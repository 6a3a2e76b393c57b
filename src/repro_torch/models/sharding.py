"""Sharding rules and the mesh context of the sharded LM path -- the port
of ``repro/models/sharding.py``.

:class:`ShardCtx` carries the mesh through the model code: its shape and
axis names (enough for the rules and the dry run with no process group,
at 16x16 or 2x16x16), the ``DeviceMesh`` when there is one, the
data-parallel axes, the model axis, and the data, model and world
process groups.  A ctx with no process group (:func:`shape_ctx`) may only
be used on meta tensors: its collectives return meta tensors of the
right shape and record their bytes; on a real tensor they raise.

The rules table (``_rules``, ``_MOE_RULES``, ``_spec_for``) is the
reference's, strategy as there:

  * FSDP/ZeRO-3: every large weight matrix shards its non-TP dimension
    over the data axes ("pod", "data");
  * TP (Megatron): head / ffn / expert / vocab dimensions shard over
    "model";
  * activations: batch over the data axes; logits vocab over "model".

:func:`param_placements` gives, for each parameter of an
:class:`~repro_torch.models.lm.LM`, the reference's ``PartitionSpec`` as a
tuple (one entry per dimension: None, an axis name or a tuple of axis
names; () for a replicated parameter), with the reference's divisibility
cleaning.  The port keeps one module per layer, so the entry of the
reference's scan-group axis is not there.  At run time the port
applies only the expert placement (each model rank holds E / n_model
experts, :meth:`~repro_torch.models.lm.LM.shard_experts`); every other
parameter stays replicated.

The collectives of the sharded MoE and loss live here, each an autograd
function counted in :data:`COLLECTIVES` by op with its result bytes (the
reference's HLO convention: all-gather the gathered buffer, all-reduce
the operand, all-to-all the result; a backward collective counts where
it runs).  Their backward rules assume what the model guarantees: the
computation downstream of a gather or a reduction is replicated over the
group, so its cotangent is too.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["MeshSpec", "ShardCtx", "shape_ctx", "constrain",
           "param_placements", "is_expert", "in_moe", "COLLECTIVES",
           "reset_collectives", "collective_summary", "note_collective",
           "all_to_all",
           "all_gather", "all_reduce", "enter_model", "scale_grad"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh by shape alone: what the rules and the dry run read when no
    process group exists."""
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardCtx:
    """Mesh context threaded through the model code.  None => one device.

    ``shape`` / ``axis_names`` describe the mesh; ``mesh`` is the
    ``DeviceMesh`` (None for a shape-only ctx); the groups are None
    without a process group.  ``model_rank`` / ``data_rank`` are this
    process's coordinates (0 in a shape-only ctx, which traces rank 0's
    program: every rank's shapes are the same)."""
    shape: tuple
    axis_names: tuple
    dp_axes: tuple = ("data",)       # ("pod", "data") on the multi-pod mesh
    model_axis: str = "model"
    mesh: object = None
    data_group: object = None
    model_group: object = None
    world_group: object = None

    def axis_size(self, ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, str):
            return self.shape[self.axis_names.index(ax)]
        return math.prod(self.axis_size(a) for a in ax)

    @property
    def n_model(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def n_data(self) -> int:
        return self.axis_size(tuple(self.dp_axes))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def has_groups(self) -> bool:
        return self.model_group is not None

    @property
    def model_rank(self) -> int:
        return dist.get_rank(self.model_group) if self.has_groups else 0

    @property
    def data_rank(self) -> int:
        return dist.get_rank(self.data_group) if self.has_groups else 0

    def batch_sharded(self, B: int) -> bool:
        """The reference's ``specs._dp_or_none``: the data axes shard a
        batch of B rows iff they divide it."""
        n = self.n_data
        return B % n == 0 and B >= n

    def local_rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B (all of them when the
        data axes do not divide B)."""
        if not self.batch_sharded(B):
            return slice(0, B)
        b = B // self.n_data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)


def shape_ctx(shape, axis_names, dp_axes=None,
              model_axis="model") -> ShardCtx:
    """A ctx with no process group: for the rules, the specs and the dry
    run on meta tensors."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if dp_axes is None:
        dp_axes = tuple(a for a in axis_names if a != model_axis)
    return ShardCtx(shape=shape, axis_names=axis_names,
                    dp_axes=tuple(dp_axes), model_axis=model_axis)


def constrain(x, ctx, *spec):
    """The identity.  The reference's ``constrain`` is
    ``with_sharding_constraint``, a layout hint to the SPMD partitioner
    that changes no value; the port's tensors are already rank-local."""
    return x


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _rules(ctx: ShardCtx):
    dp, mdl = ctx.dp, ctx.model_axis
    return {
        # name -> spec for the parameter's own rank
        "embed": (mdl, dp),           # (V, d): vocab TP, d FSDP
        "head": (mdl, dp),
        "wq": (dp, mdl), "wk": (dp, mdl), "wv": (dp, mdl),
        "wo": (mdl, dp),
        "wi": (dp, mdl),              # mlp in (d, ff*)
        "router": (dp, None),
        "w_gate": (dp, mdl), "w_branch": (dp, mdl), "w_out": (mdl, dp),
        "w_a": (dp, None), "w_x": (dp, None),
        "w_r": (dp, mdl), "w_k": (dp, mdl), "w_v": (dp, mdl),
        "w_g": (dp, mdl), "w_o": (mdl, dp),
        "A_w": (dp, None), "B_w": (None, dp),
        "A_k": (dp, None), "B_k": (None, dp),
        "A_v": (dp, None), "B_v": (None, dp),
        "A_r": (dp, None), "B_r": (None, dp),
        "A_g": (dp, None), "B_g": (None, dp),
    }


_MOE_RULES = {
    # experts shard over model (EP); inner dims FSDP over data
    "wi": lambda dp, mdl: (mdl, dp, None),
    "wo": lambda dp, mdl: (mdl, None, dp),
}


def in_moe(name: str) -> bool:
    """A parameter under a block's MoE (router, experts, shared
    experts)."""
    return "moe" in name.split(".")


def is_expert(name: str) -> bool:
    """A routed expert's weight: (E, ...), sharded over the model axis."""
    parts = name.split(".")
    return "moe" in parts and parts[-1] in _MOE_RULES and \
        parts[-2] == "moe"


def _spec_for(name: str, ndim: int, ctx: ShardCtx) -> tuple:
    rules = _rules(ctx)
    leaf = name.rsplit(".", 1)[-1]
    if in_moe(name) and leaf in _MOE_RULES:
        spec = _MOE_RULES[leaf](ctx.dp, ctx.model_axis)
    elif leaf in rules:
        spec = rules[leaf]
    else:
        return ()   # small params (norms, biases, gates): replicate
    pad = ndim - len(spec)
    if pad < 0:
        return ()
    return (None,) * pad + tuple(spec)


def param_placements(model, ctx: ShardCtx) -> dict:
    """{parameter name: the reference's PartitionSpec as a tuple}: axes
    that do not divide their dimension evenly are dropped (replicated),
    as the reference's ``param_shardings`` cleans them.  Reads shapes
    only: build the model on the meta device with all E experts.

    A layer the reference stacks into a scan group (the first G * P
    layers) is placed as its stacked leaf (G, ...) and the group axis's
    entry dropped: None for every rule but the shared experts' wi / wo,
    where the reference's expert rule lands "model" on the group axis --
    a placement of the stack with no per-layer counterpart."""
    cfg = model.cfg
    stacked = (cfg.num_layers // len(cfg.block_pattern)) \
        * len(cfg.block_pattern)
    G = cfg.num_layers // len(cfg.block_pattern)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        lead = parts[0] == "blocks" and int(parts[1]) < stacked
        if lead:
            shape = (G,) + shape
        spec = _spec_for(name, len(shape), ctx)
        clean = tuple(ax if ax is not None and
                      dim % ctx.axis_size(ax) == 0 else None
                      for dim, ax in zip(shape, spec))
        out[name] = clean[1:] if lead and clean else clean
    return out


# ---------------------------------------------------------------------------
# collectives (counted; autograd rules for replicated downstream code)
# ---------------------------------------------------------------------------

COLLECTIVES: dict = {}    # op -> {"count": n, "bytes": result bytes}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collective_summary() -> dict:
    """The reference's ``hlo.collective_bytes`` layout over the counts:
    {"by_op": {op: bytes}, "total": bytes, "count": calls, "calls":
    {op: calls}}."""
    by_op = {op: c["bytes"] for op, c in COLLECTIVES.items()}
    return {"by_op": by_op, "total": sum(by_op.values()),
            "count": sum(c["count"] for c in COLLECTIVES.values()),
            "calls": {op: c["count"] for op, c in COLLECTIVES.items()}}


def note_collective(op: str, t: torch.Tensor) -> None:
    """Count one collective ``op`` whose result is ``t``."""
    c = COLLECTIVES.setdefault(op, {"count": 0, "bytes": 0})
    c["count"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _shape_only(x: torch.Tensor, group) -> bool:
    """True when the collective is traced on a meta tensor (no
    communication); raises for a real tensor without a group."""
    if x.device.type == "meta":
        return True
    if group is None:
        raise RuntimeError(
            "a sharded ctx without a torch.distributed process group works "
            "on meta tensors only: call torch.distributed.init_process_group "
            "and build the ctx with repro_torch.launch.mesh.make_ctx on a "
            "DeviceMesh to run it")
    return False


def _group(ctx, group_name):
    return getattr(ctx, f"{group_name}_group")


def _all_to_all(x, ctx):
    """Dim 0 split into n_model chunks, chunk j to model rank j; the
    received chunks concatenated on dim 0 in source-rank order."""
    group = ctx.model_group
    x = x.contiguous()
    out = torch.empty_like(x)
    note_collective("all-to-all", out)
    if not _shape_only(x, group):
        dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx):
        ctx_.shard = ctx
        return _all_to_all(x, ctx)

    @staticmethod
    def backward(ctx_, g):
        # the exchange is a permutation; its transpose is the same exchange
        return _all_to_all(g, ctx_.shard), None


def all_to_all(x, ctx: ShardCtx):
    """``all_to_all_single`` over the model group (dim 0 tiled)."""
    return _AllToAll.apply(x, ctx)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, dim):
        ctx_.shard, ctx_.dim = ctx, dim
        n = ctx.n_model
        group = ctx.model_group
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        note_collective("all-gather", out)
        if not _shape_only(x, group):
            dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx_, g):
        # downstream is replicated over the model group, so every rank
        # holds the whole cotangent: take this rank's slice
        n, dim = ctx_.shard.n_model, ctx_.dim
        s = g.shape[dim] // n
        r = ctx_.shard.model_rank
        return g.narrow(dim, r * s, s), None, None


def all_gather(x, ctx: ShardCtx, dim: int):
    """The model ranks' ``x`` concatenated on ``dim`` in rank order."""
    return _AllGather.apply(x, ctx, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, group_name):
        group = _group(ctx, group_name)
        out = x.clone()
        note_collective("all-reduce", out)
        if not _shape_only(x, group):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx_, g):
        # downstream is replicated: each rank's term gets the cotangent
        return g, None, None


def all_reduce(x, ctx: ShardCtx, group: str):
    """Sum over the "model", "data" or "world" group.  Backward: the
    identity (the sum's consumer is replicated over the group)."""
    return _AllReduce.apply(x, ctx, group)


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx):
        ctx_.shard = ctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        # each model rank's code differentiates its own share of the
        # tokens; the replicated caller needs their sum
        out = g.clone()
        shard = ctx_.shard
        note_collective("all-reduce", out)
        if not _shape_only(g, shard.model_group):
            dist.all_reduce(out, group=shard.model_group)
        return out, None


def enter_model(x, ctx: ShardCtx):
    """Identity into a model-parallel region; backward sums the
    cotangent over the model group."""
    return _EnterModel.apply(x, ctx)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, factor):
        ctx_.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return g * ctx_.factor, None


def scale_grad(x, factor: float):
    """Identity; backward multiplies the cotangent by ``factor``."""
    return _ScaleGrad.apply(x, factor)
