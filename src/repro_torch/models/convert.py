"""Weights from the reference's parameter pytree: the LM counterpart of
:func:`repro_torch.core.batched.soft_plan_from_arrays`, which builds a
transform plan from the reference's arrays.

:func:`params_from_numpy` takes ``repro.models.lm.init``'s pytree with
every leaf as a numpy array, unstacks ``params["groups"]`` (leading axis
G: layer g * len(pattern) + slot) and ``params["tail"]`` into the
:class:`~repro_torch.models.lm.LM`'s blocks, and copies each array into
its parameter.  bfloat16 leaves come from JAX as numpy arrays of the
``bfloat16`` extension dtype; they are read through a uint16 view, so
nothing here needs that extension.
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


def _block_leaves(p):
    """(module path, array) of one block's dict, in the module's names."""
    yield "norm1.scale", p["norm1"]["scale"]
    if "bias" in p["norm1"]:
        yield "norm1.bias", p["norm1"]["bias"]
    for w in ("wq", "wk", "wv", "wo"):
        yield f"mixer.{w}", p["mixer"][w]
    yield "norm2.scale", p["norm2"]["scale"]
    if "bias" in p["norm2"]:
        yield "norm2.bias", p["norm2"]["bias"]
    if "moe" in p:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP.md "
                                  "queue 1 item 11)")
    for w in ("wi", "wo"):
        yield f"mlp.{w}", p["mlp"][w]


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
        for path, a in _block_leaves(p):
            _copy(params[f"blocks.{i}.{path}"], a, f"layer {i} {path}")
    return model


def _index(tree, g):
    """Leaf [g] of every array of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
