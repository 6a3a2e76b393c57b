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
reference's scan-group axis is not there.  :func:`place_` applies them at
run time: each parameter is cut to the rank's block at its (data rank,
model rank) and the placement is recorded on its module; the model code
reads it there (:func:`spec_of`).  A layer's data-sharded parameters are
gathered whole over the data group once per call (:func:`gather_params`,
one flat bucket per dtype, FSDP / ZeRO-3; nothing to gather at one data
rank), and their gradients reduce-scattered back onto the shards in the
backward; the dimensions
the rules put on "model" stay split (Megatron tensor parallelism, each
module's column / row split).  The shared experts' wi / wo, which the
reference's expert rule places over "model" on its scan-group axis (a
placement of the stack with no per-layer counterpart), are replicated
over "model" here.

The collectives of the sharded path live here, each an autograd function
counted in :data:`COLLECTIVES` by op with its result bytes (the
reference's HLO convention: all-gather the gathered buffer, all-reduce
the operand, all-to-all and reduce-scatter the result; a backward
collective counts where it runs).  Their backward rules say what the
code downstream does with the result: :func:`all_gather`, :func:`all_reduce`
and :func:`model_slice` assume it is replicated over the group (its
cotangent is whole on every rank); ``all_gather(..., partial=True)`` and
:func:`enter_model` that each rank computes a part of it (the cotangents
are summed).  :func:`split_work` marks the work a rank does on its own
block of a model-split dimension, so that the FLOP counter scales it by
the model axis (:mod:`repro_torch.launch.flops`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["MeshSpec", "ShardCtx", "shape_ctx", "constrain",
           "param_placements", "is_expert", "in_moe", "place_", "spec_of",
           "split_on", "placements_of", "block_of", "gather_params",
           "gather_whole",
           "LeafShards", "COLLECTIVES", "reset_collectives",
           "collective_summary", "note_collective", "all_to_all",
           "all_gather", "all_reduce", "reduce_scatter", "model_slice",
           "enter_model", "scale_grad", "split_work", "in_split_work"]


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
# run-time placement
# ---------------------------------------------------------------------------

def group_name(ctx: ShardCtx, ax) -> str:
    """The process group of placement entry ``ax``: "model" or "data"."""
    if ax == ctx.model_axis:
        return "model"
    if ax == ctx.dp or ax == tuple(ctx.dp_axes):
        return "data"
    raise ValueError(f"placement entry {ax!r} is neither the model axis "
                     f"nor the data axes {ctx.dp_axes}")


def _coord(ctx: ShardCtx, ax) -> tuple:
    """(this rank's block index, blocks) of placement entry ``ax``."""
    if group_name(ctx, ax) == "model":
        return ctx.model_rank, ctx.n_model
    return ctx.data_rank, ctx.n_data


def block_of(t: torch.Tensor, spec, ctx: ShardCtx) -> torch.Tensor:
    """The rank's block of the whole tensor ``t`` under ``spec`` (a
    view)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        r, n = _coord(ctx, ax)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} is no "
                             f"multiple of {n} ({ax!r})")
        s = t.shape[dim] // n
        t = t.narrow(dim, r * s, s)
    return t


def spec_of(module, name: str) -> tuple:
    """The placement :func:`place_` recorded for ``module``'s parameter
    ``name`` (() when the module is not placed)."""
    return getattr(module, "_placement", {}).get(name, ())


def split_on(module, name: str, dim: int) -> bool:
    """True when dimension ``dim`` of ``module``'s parameter ``name`` is
    split over the model axis (a rank holds its block of it)."""
    spec = spec_of(module, name)
    return len(spec) > 0 and spec[dim] == "model"


def _dp_dim(spec, ctx) -> int | None:
    for dim, ax in enumerate(spec):
        if ax is not None and ax != ctx.model_axis:
            return dim
    return None


@torch.no_grad()
def place_(model, ctx: ShardCtx, placements: dict | None = None):
    """Cut every parameter of ``model`` to the rank's block of its
    placement (default :func:`param_placements`, the reference's rules)
    and record each placement on its module.  The model must hold whole
    parameters (meta tensors are fine); returns it."""
    if any(getattr(m, "_placement", None) for m in model.modules()):
        raise ValueError("the model is placed already")
    if placements is None:
        placements = param_placements(model, ctx)
    modules = dict(model.named_modules())
    # by name, so that each old parameter is freed as its block replaces
    # it (a whole block keeps the storage: nothing is copied)
    for name in [n for n, _ in model.named_parameters()]:
        spec = tuple(placements.get(name, ()))
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        p = getattr(mod, leaf)
        part = block_of(p.detach(), spec, ctx)
        if part.shape != p.shape:
            part = part.clone(memory_format=torch.contiguous_format)
        setattr(mod, leaf, torch.nn.Parameter(part,
                                              requires_grad=p.requires_grad))
        mod._placement = {**getattr(mod, "_placement", {}), leaf: spec}
        del p, part
    return model


def placements_of(model) -> dict:
    """{parameter name: the placement :func:`place_` recorded for it} of
    every parameter under ``model`` (() for each of a model not
    placed)."""
    return {name: spec for name, _, spec in _param_items(model)}


_ALIGN = 64     # elements: every tensor of a bucket starts 256-byte aligned


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _concat(blocks, dim):
    """(n, ...) rank blocks -> one tensor concatenated on ``dim`` in rank
    order."""
    return torch.cat(blocks.unbind(0), dim=dim)


def flat_bucket(tensors):
    """(one flat buffer holding ``tensors``, each at a 256-byte aligned
    offset; a function mapping such a buffer back to views of their
    shapes; the offsets).  Aligned views keep every later operation on
    them the one it is on a tensor of its own (a reduction's vector
    lanes depend on the address)."""
    offs, total = [], 0
    for t in tensors:
        offs.append(total)
        total += _aligned(t.numel())
    ref = tensors[0]
    flat = torch.zeros((total,), dtype=ref.dtype, device=ref.device)
    for t, off in zip(tensors, offs):
        flat[off:off + t.numel()].copy_(t.reshape(-1))
    shapes = [t.shape for t in tensors]

    def views(buf):
        return [buf[off:off + math.prod(shape)].view(shape)
                for off, shape in zip(offs, shapes)]
    return flat, views, offs


class _GatherBucket(torch.autograd.Function):
    """The data group's shards of several parameters, flattened into one
    buffer, all-gathered in one call and cut back into whole tensors
    (rank-major along each one's data-sharded dimension); backward: the
    gradients flattened the same way and reduce-scattered in one call."""

    @staticmethod
    def forward(ctx_, shard, dims, *params):
        group, n = shard.data_group, shard.n_data
        flat, _, offs = flat_bucket(params)
        total, ref = flat.numel(), params[0]
        out = torch.empty((n * total,), dtype=ref.dtype, device=ref.device)
        note_collective("all-gather", out)
        if not _shape_only(flat, group):
            dist.all_gather_into_tensor(out, flat, group=group)
        out = out.view(n, total)
        fulls = [_concat(out[:, off:off + p.numel()].reshape(
            (n,) + tuple(p.shape)), dim) for p, off, dim in
            zip(params, offs, dims)]
        ctx_.shard, ctx_.dims, ctx_.offs, ctx_.total = shard, dims, offs, \
            total
        ctx_.shapes = [tuple(p.shape) for p in params]
        ctx_.like = (ref.dtype, ref.device)
        return tuple(fulls)

    @staticmethod
    def backward(ctx_, *grads):
        shard, n = ctx_.shard, ctx_.shard.n_data
        dtype, device = ctx_.like
        flat = torch.zeros((n, ctx_.total), dtype=dtype, device=device)
        for g, off, dim, shape in zip(grads, ctx_.offs, ctx_.dims,
                                      ctx_.shapes):
            if g is None:
                continue
            split = list(shape)
            split[dim:dim + 1] = [n, shape[dim]]
            numel = math.prod(shape)
            flat[:, off:off + numel] = g.reshape(split).movedim(dim, 0) \
                .reshape(n, numel)
        part = _reduce_scatter_flat(flat.view(-1), shard, "data")
        return (None, None) + tuple(
            part[off:off + math.prod(shape)].view(shape)
            for off, shape in zip(ctx_.offs, ctx_.shapes))


def _param_items(module, names=None):
    """(dotted name, parameter, placement) of every parameter under
    ``module`` (or only ``names``); the walk over the modules is made
    once and kept on the module."""
    cache = module.__dict__.setdefault("_param_walk", {})
    key = None if names is None else tuple(names)
    if key not in cache:
        mods = dict(module.named_modules())
        cache[key] = [(name,) + ((mods[owner], leaf) if owner else
                                 (module, name))
                      for name, _ in module.named_parameters()
                      if names is None or name in names
                      for owner, _, leaf in [name.rpartition(".")]]
    for name, owner, leaf in cache[key]:
        yield name, getattr(owner, leaf), spec_of(owner, leaf)


def gather_params(module, ctx: ShardCtx | None, names=None) -> dict:
    """{dotted name: the parameter whole over the data axes} of every
    parameter under ``module`` (or only ``names``): the data-sharded ones
    all-gathered over the data group in one call per dtype (their
    gradients reduce-scattered back onto the shards in the backward);
    the others, and every parameter without ``ctx`` or at one data rank
    (where the gather is the identity), as they are.  Model-split
    dimensions stay split."""
    items = list(_param_items(module, names))
    if ctx is None or ctx.n_data == 1:
        return {name: p for name, p, _ in items}
    out, buckets = {}, {}
    for name, p, spec in items:
        dim = _dp_dim(spec, ctx)
        if dim is None:
            out[name] = p
        else:
            buckets.setdefault(p.dtype, []).append((name, p, dim))
    for bucket in buckets.values():
        fulls = _GatherBucket.apply(ctx, tuple(d for _, _, d in bucket),
                                    *[p for _, p, _ in bucket])
        out.update(zip([name for name, _, _ in bucket], fulls))
    return out


def sub_weights(w, prefix: str):
    """The entries of a :func:`gather_params` dict under ``prefix.``, the
    prefix stripped (None for None: the module's own parameters)."""
    if w is None:
        return None
    n = len(prefix) + 1
    return {k[n:]: v for k, v in w.items() if k.startswith(prefix + ".")}


@torch.no_grad()
def gather_whole(t: torch.Tensor, spec, ctx: ShardCtx | None):
    """The whole tensor from every rank's block of it under ``spec`` (no
    gradient; for checkpoints, tests and the EF-int8 roundtrip)."""
    if ctx is None:
        return t
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = _gather_raw(t, ctx, group_name(ctx, ax), dim)
    return t


class LeafShards:
    """Where each optimizer leaf ({path: tensor}, the reference's leaves)
    lives on the mesh: ``specs`` {path: placement aligned with the leaf's
    dimensions}.  A group of one rank shards nothing: its sums are skipped,
    so that one rank computes the unsharded path's operations."""

    def __init__(self, ctx: ShardCtx, specs: dict):
        self.ctx, self.specs = ctx, specs

    def _group(self, axes) -> str | None:
        names = {group_name(self.ctx, ax) for ax in axes if ax is not None}
        names = {g for g in names if _group_size(self.ctx, g) > 1}
        if not names:
            return None
        return "world" if len(names) == 2 else names.pop()

    def leaf_group(self, path) -> str | None:
        """The group whose ranks hold the blocks of leaf ``path``."""
        return self._group(self.specs.get(path, ()))

    def dim_group(self, path, dim: int) -> str | None:
        """The group that splits dimension ``dim`` (negative: from the
        end) of leaf ``path``."""
        spec = self.specs.get(path, ())
        if not spec or -dim > len(spec):
            return None
        return self._group([spec[dim]])

    def reduce_sq(self, sq: dict) -> dict:
        """{path: a partial sum over the leaf} completed over the groups
        that shard each leaf: one all-reduce per group."""
        out = dict(sq)
        by_group: dict = {}
        for k in sq:
            g = self.leaf_group(k)
            if g is not None:
                by_group.setdefault(g, []).append(k)
        for g, keys in by_group.items():
            summed = all_reduce(torch.stack([sq[k] for k in keys]),
                                self.ctx, g)
            out.update(zip(keys, summed.unbind()))
        return out

    def mean(self, path, x, dim: int, leaf_dim: int):
        """mean of ``x`` over its dimension ``dim``, which holds the
        leaf's dimension ``leaf_dim``: over the whole dimension when a
        group splits it."""
        g = self.dim_group(path, leaf_dim)
        if g is None:
            return torch.mean(x, dim)
        total = all_reduce(torch.sum(x, dim), self.ctx, g)
        return total / (x.shape[dim] * _group_size(self.ctx, g))


# ---------------------------------------------------------------------------
# collectives (counted)
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


def _group_size(ctx, group_name) -> int:
    return {"data": ctx.n_data, "model": ctx.n_model,
            "world": ctx.size}[group_name]


def _group_rank(ctx, group_name) -> int:
    if group_name == "model":
        return ctx.model_rank
    if group_name == "data":
        return ctx.data_rank
    return dist.get_rank(ctx.world_group) if ctx.has_groups else 0


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


def _gather_raw(x, ctx, group_name, dim):
    """The group's ``x`` concatenated on ``dim`` in rank order, as a
    contiguous tensor."""
    n, group = _group_size(ctx, group_name), _group(ctx, group_name)
    dim = dim % x.ndim
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    note_collective("all-gather", out)
    if not _shape_only(x, group):
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if n == 1:      # the identity: keep x's layout, as its consumers see it
        return torch.empty_like(x).copy_(out.view(x.shape))
    return _concat(out.view((n,) + tuple(x.shape)), dim)


def _reduce_scatter_flat(flat, ctx, group_name):
    """A flat buffer of n equal chunks summed over the group; this rank
    keeps its chunk."""
    n, group = _group_size(ctx, group_name), _group(ctx, group_name)
    out = torch.empty((flat.numel() // n,), dtype=flat.dtype,
                      device=flat.device)
    note_collective("reduce-scatter", out)
    if not _shape_only(flat, group):
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def _reduce_scatter_raw(x, ctx, group_name, dim):
    """``x`` summed over the group; this rank keeps its block of ``dim``."""
    n = _group_size(ctx, group_name)
    dim = dim % x.ndim
    shape = list(x.shape)
    split = shape[:dim] + [n, shape[dim] // n] + shape[dim + 1:]
    flat = x.reshape(split).movedim(dim, 0).reshape(-1)
    part = _reduce_scatter_flat(flat, ctx, group_name)
    if n == 1:
        return torch.empty_like(x).copy_(part.view(x.shape))
    shape[dim] //= n
    return part.view(shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, dim, group_name, partial):
        ctx_.shard, ctx_.dim, ctx_.group = ctx, dim, group_name
        ctx_.partial = partial
        return _gather_raw(x, ctx, group_name, dim)

    @staticmethod
    def backward(ctx_, g):
        shard, dim, group = ctx_.shard, ctx_.dim, ctx_.group
        if ctx_.partial:
            return (_reduce_scatter_raw(g, shard, group, dim), None, None,
                    None, None)
        # downstream is replicated over the group, so every rank holds
        # the whole cotangent: take this rank's slice
        n = _group_size(shard, group)
        s = g.shape[dim] // n
        r = _group_rank(shard, group)
        return g.narrow(dim, r * s, s), None, None, None, None


def all_gather(x, ctx: ShardCtx, dim: int, group: str = "model",
               partial: bool = False):
    """The group's ``x`` concatenated on ``dim`` in rank order.
    Backward: this rank's slice of the cotangent, which the code
    downstream must hold whole (it is replicated over the group); with
    ``partial`` the ranks' cotangents are summed first (a reduce-scatter:
    each rank's code downstream computes a part of the result)."""
    return _AllGather.apply(x, ctx, dim, group, partial)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, group_name, dim):
        ctx_.shard, ctx_.group, ctx_.dim = ctx, group_name, dim
        return _reduce_scatter_raw(x, ctx, group_name, dim)

    @staticmethod
    def backward(ctx_, g):
        return (_gather_raw(g, ctx_.shard, ctx_.group, ctx_.dim), None,
                None, None)


def reduce_scatter(x, ctx: ShardCtx, group: str, dim: int):
    """``x`` summed over the group, this rank keeping its block of
    ``dim``.  Backward: the blocks' cotangents all-gathered."""
    return _ReduceScatter.apply(x, ctx, group, dim)


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, dim):
        ctx_.shard, ctx_.dim = ctx, dim
        n = ctx.n_model
        s = x.shape[dim] // n
        return x.narrow(dim, ctx.model_rank * s, s)

    @staticmethod
    def backward(ctx_, g):
        return _gather_raw(g, ctx_.shard, "model", ctx_.dim), None, None


def model_slice(x, ctx: ShardCtx, dim: int):
    """This model rank's block of ``dim`` of a tensor replicated over the
    model group (the input of a row-split weight).  Backward: the ranks'
    cotangents all-gathered, so the replicated code upstream sees the
    whole."""
    return _ModelSlice.apply(x, ctx, dim)


def _all_reduce_raw(x, group, op=dist.ReduceOp.SUM):
    """A copy of ``x`` (its layout kept) summed over ``group``."""
    out = x.clone()
    note_collective("all-reduce", out)
    if not _shape_only(x, group):
        buf = out if out.is_contiguous() else out.contiguous()
        dist.all_reduce(buf, group=group, op=op)
        if buf is not out:
            out.copy_(buf)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, group_name, op):
        return _all_reduce_raw(x, _group(ctx, group_name), op)

    @staticmethod
    def backward(ctx_, g):
        # downstream is replicated: each rank's term gets the cotangent
        return g, None, None, None


def all_reduce(x, ctx: ShardCtx, group: str, op: str = "sum"):
    """Sum (or, with ``op="max"``, the maximum: for values that carry no
    gradient) over the "model", "data" or "world" group.  Backward of the
    sum: the identity (the sum's consumer is replicated over the
    group)."""
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return _AllReduce.apply(x, ctx, group, rop)


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx):
        ctx_.shard = ctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        # each model rank's code differentiates its own share of the
        # work; the replicated caller needs their sum
        return _all_reduce_raw(g, ctx_.shard.model_group), None


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


# ---------------------------------------------------------------------------
# model-split work (read by the FLOP counter)
# ---------------------------------------------------------------------------

_SPLIT = [0]


@contextlib.contextmanager
def split_work(on: bool = True):
    """Marks the work inside as this rank's block of a model-split
    dimension (each model rank does a different part of it); a no-op
    when ``on`` is false."""
    if on:
        _SPLIT[0] += 1
    try:
        yield
    finally:
        if on:
            _SPLIT[0] -= 1


def in_split_work() -> bool:
    return _SPLIT[0] > 0
