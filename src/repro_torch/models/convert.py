"""Weights from the reference's parameter pytree: the LM counterpart of
:func:`repro_torch.core.batched.soft_plan_from_arrays`, which builds a
transform plan from the reference's arrays.

:func:`params_from_numpy` takes ``repro.models.lm.init``'s pytree with
every leaf as a numpy array, unstacks ``params["groups"]`` (leading axis
G: layer g * len(pattern) + slot) and ``params["tail"]`` (the layers
past the last whole group) into the :class:`~repro_torch.models.lm.LM`'s
blocks, and copies each array into the parameter of the same dotted name:
attention, RG-LRU and RWKV-6 mixers, MLP or MoE (router, wi, wo, shared),
and the norms' scale and bias.  A leaf without a parameter, or a
parameter without a leaf, raises.  bfloat16 leaves come from JAX as
numpy arrays of the ``bfloat16`` extension dtype; they are read through a
uint16 view, so nothing here needs that extension.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batched import resolve_device

from .lm import LM

__all__ = ["params_from_numpy"]


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of numpy array ``a``; bfloat16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _copy(param, a, where):
    t = _tensor(a)
    if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
        raise ValueError(f"{where}: expected {param.dtype} "
                         f"{tuple(param.shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    param.data.copy_(t)


def _leaves(tree, prefix=""):
    """(dotted path, array) of every leaf of a nested dict, in the
    module's names: the port's modules name their parameters as the
    reference's dicts name their leaves (mixer.w_a, moe.shared.wi, ...)."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        else:
            yield path, val


def params_from_numpy(cfg, tree, device=None) -> LM:
    """The model of ``cfg`` holding the reference's weights ``tree``
    (numpy leaves) on ``device`` (None: the card)."""
    model = LM(cfg, device=resolve_device(device)).eval()
    params = dict(model.named_parameters())
    _copy(model.embed, tree["embed"], "embed")
    if not cfg.tie_embeddings:
        _copy(model.head, tree["head"], "head")
    for name, a in tree["final_norm"].items():
        _copy(params[f"final_norm.{name}"], a, f"final_norm.{name}")
    pat = cfg.block_pattern
    G = cfg.num_layers // len(pat)
    layer_trees = []
    for g in range(G):
        for slot in range(len(pat)):
            layer_trees.append(_index(tree["groups"][slot], g))
    layer_trees.extend(tree["tail"])
    if len(layer_trees) != len(model.blocks):
        raise ValueError(f"tree has {len(layer_trees)} layers, the config "
                         f"{len(model.blocks)}")
    for i, p in enumerate(layer_trees):
        want = {n for n in params if n.startswith(f"blocks.{i}.")}
        for path, a in _leaves(p):
            name = f"blocks.{i}.{path}"
            if name not in want:
                raise ValueError(f"layer {i}: the tree's leaf {path} has no "
                                 f"parameter in the model")
            _copy(params[name], a, f"layer {i} {path}")
            want.discard(name)
        if want:
            raise ValueError(f"layer {i}: no leaf for {sorted(want)}")
    return model


def _index(tree, g):
    """Leaf [g] of every array of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
