"""Weights and training state from and to the reference's pytrees: the LM
counterpart of :func:`repro_torch.core.batched.soft_plan_from_arrays`,
which builds a transform plan from the reference's arrays.

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

The training state goes the other way through :func:`leaf_groups`: one
entry per leaf of the reference's tree, keyed by its path
("groups/0/mixer/wq", "/"-joined as ``jax.tree_util`` paths print in the
reference's checkpoints) in ``jax.tree.flatten`` order, holding the
parameters that make up that leaf -- the G layers of a pattern slot for a
``groups/<slot>/...`` leaf, which the optimizer, the gradient compressor
and the checkpoint see stacked as (G, ...) like the reference, or the one
parameter of any other leaf.  :func:`tree_to_numpy` gives the reference's
numpy tree of the parameters or their gradients;
:func:`opt_state_from_numpy` the reference's optimizer state in the
port's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import flatten_paths
from repro_torch.core.batched import resolve_device

from . import sharding
from .lm import LM

__all__ = ["params_from_numpy", "leaf_groups", "leaf_shards", "is_stacked",
           "stack", "write_back", "stacks", "tree_to_numpy",
           "opt_state_from_numpy"]


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of numpy array ``a``; bfloat16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _copy(param, a, where, spec=(), ctx=None):
    t = _tensor(a)
    if ctx is not None:
        t = sharding.block_of(t, spec, ctx)
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


def params_from_numpy(cfg, tree, device=None, ctx=None) -> LM:
    """The model of ``cfg`` holding the reference's weights ``tree``
    (numpy leaves) on ``device`` (None: the card); with ``ctx`` placed,
    each parameter the rank's block of its leaf."""
    device = resolve_device(device)
    if ctx is None:
        model = LM(cfg, device=device).eval()
    else:
        model = sharding.place_(LM(cfg, device="meta"), ctx)
        model = model.to_empty(device=device).eval()
    params = dict(model.named_parameters())
    specs = sharding.placements_of(model)

    def copy(name, a, where):
        _copy(params[name], a, where, specs[name], ctx)
    copy("embed", tree["embed"], "embed")
    if not cfg.tie_embeddings:
        copy("head", tree["head"], "head")
    for name, a in tree["final_norm"].items():
        copy(f"final_norm.{name}", a, f"final_norm.{name}")
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
            copy(name, a, f"layer {i} {path}")
            want.discard(name)
        if want:
            raise ValueError(f"layer {i}: no leaf for {sorted(want)}")
    return model


def _index(tree, g):
    """Leaf [g] of every array of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


# ---------------------------------------------------------------------------
# leaf groups: the reference's tree over the port's per-layer parameters
# ---------------------------------------------------------------------------

def is_stacked(path: str) -> bool:
    """A leaf under ``groups/`` stacks the G layers of its pattern slot."""
    return path.split("/", 1)[0] == "groups"


def stack(path: str, tensors) -> torch.Tensor:
    """The reference's leaf ``path`` from its parameters (or their
    gradients): the (G, ...) stack of a ``groups/`` leaf, else the one
    tensor."""
    return torch.stack(list(tensors)) if is_stacked(path) else tensors[0]


@torch.no_grad()
def write_back(path: str, params, value: torch.Tensor) -> None:
    """Copy the leaf ``value`` (stacked for a ``groups/`` leaf) into its
    parameters in place, cast to their dtype (round to nearest)."""
    if is_stacked(path):
        for p, v in zip(params, value):
            p.copy_(v)
    else:
        params[0].copy_(value)


def _block_names(block) -> list:
    """A block's parameter names as the reference's nested dicts flatten:
    components "/"-joined, sorted level by level (jax sorts dict keys)."""
    names = [tuple(n.split(".")) for n, _ in block.named_parameters()]
    return ["/".join(n) for n in sorted(names)]


def leaf_groups(model: LM) -> dict:
    """Reference path -> list of the model's parameters, in the order
    ``jax.tree.flatten`` visits ``repro.models.lm.init``'s tree (embed,
    final_norm, groups, head, tail)."""
    cfg = model.cfg
    P = len(cfg.block_pattern)
    G = cfg.num_layers // P
    params = dict(model.named_parameters())
    out = {"embed": [model.embed]}
    for name in _block_names(model.final_norm):
        out[f"final_norm/{name}"] = [params[f"final_norm.{name}"]]
    for slot in range(P if G else 0):
        for name in _block_names(model.blocks[slot]):
            dotted = name.replace("/", ".")
            out[f"groups/{slot}/{name}"] = [
                params[f"blocks.{g * P + slot}.{dotted}"] for g in range(G)]
    if not cfg.tie_embeddings:
        out["head"] = [model.head]
    for i in range(len(model.blocks) - G * P):
        block = G * P + i
        for name in _block_names(model.blocks[block]):
            dotted = name.replace("/", ".")
            out[f"tail/{i}/{name}"] = [params[f"blocks.{block}.{dotted}"]]
    return out


def leaf_shards(model, ctx, placements=None) -> sharding.LeafShards:
    """Where each of the model's leaves (:func:`leaf_groups`) lives on
    ``ctx``'s mesh: its parameters' placement in ``placements`` ({name:
    placement}; default the ones recorded on the model,
    :func:`~repro_torch.models.sharding.placements_of`), a leading None
    for a stacked leaf."""
    if placements is None:
        placements = sharding.placements_of(model)
    names = {id(p): n for n, p in model.named_parameters()}
    specs = {}
    for path, ps in leaf_groups(model).items():
        spec = tuple(placements.get(names[id(ps[0])], ()))
        specs[path] = (None,) + spec if spec and is_stacked(path) \
            else spec
    return sharding.LeafShards(ctx, specs)


def _numpy(t: torch.Tensor):
    """A host numpy array of ``t``; bfloat16 as float32 (numpy has no
    bfloat16 without the extension)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _nest(flat: dict):
    """{path: leaf} -> the reference's nested dicts and lists ("groups"
    and "tail" are lists indexed by slot / layer)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    for key in ("groups", "tail"):
        sub = root.get(key, {})
        root[key] = [sub[str(i)] for i in range(len(sub))]
    return root


def stacks(model: LM, grads: bool = False) -> dict:
    """{path: the reference's leaf} of :func:`leaf_groups`: detached
    parameters, or their ``.grad`` (zeros where a parameter has none),
    stacked for a ``groups/`` leaf, on the model's device."""
    out = {}
    for path, ps in leaf_groups(model).items():
        ts = [(p.grad if p.grad is not None else torch.zeros_like(p))
              if grads else p.detach() for p in ps]
        out[path] = stack(path, ts)
    return out


def tree_to_numpy(model: LM, grads: bool = False, ctx=None):
    """The reference's parameter tree with numpy leaves (bfloat16 as
    float32), stacked as ``repro.models.lm.init`` stacks it: of the
    parameters, or of their gradients (:func:`stacks`).  With ``ctx`` a
    placed model's blocks are gathered into whole leaves (every rank
    calls it)."""
    flat = stacks(model, grads)
    if ctx is not None:
        specs = leaf_shards(model, ctx).specs
        flat = {k: sharding.gather_whole(v, specs[k], ctx)
                for k, v in flat.items()}
    return _nest({k: _numpy(v) for k, v in flat.items()})


def opt_state_from_numpy(cfg, model: LM, state) -> dict:
    """The reference's optimizer state (``repro.optim.init_opt`` or a
    later ``opt_update``, numpy leaves) in the port's layout (float32 on
    the model's device, keyed by :func:`leaf_groups`' paths), so a port
    run can pick up a reference run mid-way.  ``cfg`` is the
    :class:`~repro_torch.optim.OptConfig`."""
    dev = model.embed.device
    paths = list(leaf_groups(model))

    def tensors(tree):
        flat = flatten_paths(tree)
        return {p: _tensor(flat[p]).to(dev) for p in paths}

    out = {"step": _tensor(state["step"]).to(dev)}
    if cfg.name == "adamw":
        for key in ("mu", "nu", "master"):
            out[key] = tensors(state[key])
    elif cfg.name == "adafactor":
        flat = flatten_paths(state["stats"])
        out["stats"] = {p: {k: _tensor(flat[f"{p}/{k}"]).to(dev)
                            for k in ("vr", "vc", "v")
                            if f"{p}/{k}" in flat} for p in paths}
        out["master"] = tensors(state["master"])
    else:
        raise ValueError(cfg.name)
    return out
