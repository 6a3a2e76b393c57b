"""Meta-tensor input specs and placements for every (arch x shape) cell --
the port of ``repro/launch/specs.py``.

Nothing here allocates: models are built on the meta device, inputs are
meta tensors at their global shapes, and every placement is the
reference's ``PartitionSpec`` as a tuple (one entry per dimension: None,
an axis name or a tuple of axis names), by the reference's rules:

  batch axes over ("pod", "data"); heads / ffn / vocab / experts over
  "model"; params FSDP'd over the data axes (ZeRO-3); decode caches shard
  KV heads over "model" when divisible, else the sequence axis, else
  replicate; a batch the data axes do not divide is replicated.

:func:`local_shape` gives a rank's shape of a tensor under a placement.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import batched
from repro_torch.models import convert, layers, lm, sharding as shlib
from repro_torch.optim import OptConfig, init_opt

__all__ = ["batch_specs", "params_specs", "opt_specs", "state_shardings",
           "decode_specs", "soft_plan_specs", "soft_shardings",
           "local_shape", "placement_bytes"]

META = "meta"


def _dp_or_none(ctx, B):
    """Batch axis placement: the data axes if they divide B, else
    replicated."""
    return ctx.dp if ctx.batch_sharded(B) else None


def local_shape(shape, placement, ctx) -> tuple:
    """A rank's shape of a tensor of global ``shape`` under
    ``placement`` (() or shorter: the rest replicated)."""
    placement = tuple(placement) + (None,) * (len(shape) - len(placement))
    return tuple(d // ctx.axis_size(ax) for d, ax in zip(shape, placement))


def placement_bytes(tensors: dict, placements: dict, ctx) -> int:
    """Bytes one rank holds of ``tensors`` under ``placements``."""
    return sum(math.prod(local_shape(t.shape, placements[k], ctx))
               * t.element_size() for k, t in tensors.items())


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_specs(cfg, B, S, ctx, *, with_labels):
    """({name: meta tensor at the global shape}, {name: placement})."""
    dp = _dp_or_none(ctx, B)
    specs, shards = {}, {}
    if cfg.embed_inputs:
        specs["embeds"] = torch.empty((B, S, cfg.d_model), device=META,
                                      dtype=layers.dtype_of(
                                          cfg.compute_dtype))
        shards["embeds"] = (dp, None, None)
    else:
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
        shards["tokens"] = (dp, None)
    if with_labels:
        specs["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
        shards["labels"] = (dp, None)
    if cfg.pos_type == "mrope":
        specs["positions"] = torch.empty((3, B, S), dtype=torch.int32,
                                         device=META)
        shards["positions"] = (None, dp, None)
    return specs, shards


# ---------------------------------------------------------------------------
# params / optimizer
# ---------------------------------------------------------------------------

def params_specs(cfg, ctx):
    """(the LM on the meta device with all E experts, {parameter name:
    placement})."""
    model = lm.LM(cfg, device=META)
    return model, shlib.param_placements(model, ctx)


def _leaf_placement(path: str, shape, ctx) -> tuple:
    """The reference's rule for a leaf of its tree ("/"-joined path,
    stacked (G, ...) for a groups/ leaf): mu / nu / master / stats mirror
    the parameter names."""
    spec = shlib._spec_for(path.replace("/", "."), len(shape), ctx)
    return tuple(ax if ax is not None and d % ctx.axis_size(ax) == 0
                 else None for d, ax in zip(shape, spec))


def opt_specs(cfg, ctx, opt: OptConfig, model):
    """(the optimizer state over the reference's stacked leaves, as meta
    tensors; {flattened "/" path: placement})."""
    state = init_opt(opt, convert.stacks(model))
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = node
    walk(state, "")
    return state, {k: _leaf_placement(k, tuple(v.shape), ctx)
                   for k, v in flat.items()}


# ---------------------------------------------------------------------------
# decode states
# ---------------------------------------------------------------------------

def state_shardings(cfg, states, ctx, B):
    """Decode-state placements, one dict per layer, keyed on the leaf
    name and its trailing dims as the reference's rules (the port's
    states are per layer: no scan-group axis)."""
    dp = _dp_or_none(ctx, B)
    nm = ctx.n_model
    mdl = ctx.model_axis

    def div(n):
        return n % nm == 0 and n >= nm

    def leaf_spec(name, shape):
        if name in ("k", "v"):          # (B, L, Hkv, D) cache
            spec = [dp, None, None, None]
            _, L, Hkv, _ = shape[-4:]
            if div(Hkv):
                spec[2] = mdl
            elif div(L):
                spec[1] = mdl            # sequence-parallel cache
        elif name == "S":                # (B, H, Dk, Dv) rwkv state
            spec = [dp, None, None, None]
            if div(shape[-3]):
                spec[1] = mdl
        elif name == "conv":             # (B, W, d)
            spec = [dp, None, mdl if div(shape[-1]) else None]
        elif name in ("h", "x_prev"):    # (B, d)
            spec = [dp, mdl if div(shape[-1]) else None]
        else:
            spec = [None] * len(shape)
        return tuple([None] * (len(shape) - len(spec)) + spec)

    return [{k: leaf_spec(k, tuple(v.shape)) for k, v in st.items()}
            for st in states]


def decode_specs(cfg, B, S, ctx):
    """Specs for one decode step: one new token against an S-long state.
    ((batch, states, pos), (batch placements, state placements, ()))."""
    batch, batch_sh = batch_specs(cfg, B, 1, ctx, with_labels=False)
    states = lm.state_init(cfg, B, S, device=META)
    return (batch, states, S), (batch_sh, state_shardings(cfg, states, ctx,
                                                          B), ())


# ---------------------------------------------------------------------------
# SOFT (the paper's own workload)
# ---------------------------------------------------------------------------

def soft_plan_specs(B, n_shards, dtype=torch.float32):
    """A SoftPlan of meta tensors with the real plan's shapes and dtypes
    (``core.batched.build_plan(B, dtype, pad_to=n_shards)``): no 0.4 TB
    table build."""
    K = B * (B + 1) // 2
    Kp = ((K + n_shards - 1) // n_shards) * n_shards
    L, J, C = B, 2 * B, 8

    def t(shape, dt):
        return torch.empty(shape, dtype=dt, device=META)
    idx = torch.int64
    return batched.SoftPlan(
        B=B, table=None, n_padded=Kp, device=torch.device(META),
        plan_dtype=dtype, d=t((Kp, L, J), dtype),
        gather_m=t((Kp, C), idx), gather_mp=t((Kp, C), idx),
        scatter_m=t((Kp, C), idx), scatter_mp=t((Kp, C), idx),
        sign=t((Kp, C), dtype), reflected=t((Kp, C), torch.bool),
        w=t((J,), dtype), scale=t((L,), dtype), parity=t((L,), dtype))


def soft_shardings(plan, ctx, axis) -> dict:
    """{leaf: placement} of a SoftPlan sharded over ``axis`` (the
    reference's: the table, reflections and weights split, the rest
    replicated)."""
    ax = axis if len(axis) > 1 else axis[0]
    return {"d": (ax,), "gather_m": (), "gather_mp": (), "scatter_m": (),
            "scatter_mp": (), "sign": (), "reflected": (ax,), "w": (ax,),
            "scale": (), "parity": ()}
