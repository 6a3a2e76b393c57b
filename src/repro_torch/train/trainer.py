"""Training loop: the step (gradient accumulation, clipping, optimizer, LR
schedule, optional EF-int8 gradient compression) and its fault-tolerant
loop -- the port of ``repro/train/trainer.py``.

The step updates the model's parameters in place (the torch counterpart
of the reference's buffer donation).  Gradients are taken per microbatch
with ``torch.autograd.grad`` (never accumulated into ``.grad`` in the
parameters' dtype) and summed into float32 buffers, g / nm at a time, as
the reference's float32 scan carry.  The optimizer and the compressor see
the reference's leaves (:func:`repro_torch.models.convert.leaf_groups`):
a pattern slot's G layers stacked as one (G, ...) leaf.

Fault tolerance (the reference's, exercised by tests/test_torch_train.py
and chip_smoke.py phase 12c):
  * async atomic checkpoints every ``ckpt_every`` steps (keep-N GC);
  * a non-finite loss (FloatingPointError) or a RuntimeError during a
    step restores from the latest checkpoint and the run continues (the
    deterministic data pipeline replays the exact stream from the
    restored step); every restart is an "event" entry of ``history``.  In
    torch a CUDA fault or an out-of-memory error is a RuntimeError too,
    so a run on the card must be read for events (chip_smoke.py fails
    on any it did not plant);
  * ``max_restarts`` bounds crash loops;
  * heartbeats feed train.straggler.StragglerPolicy.

Each step's ``history`` entry also holds ``step_s``: host seconds from
making the batch to the loss on the host (which waits for the device),
before the checkpoint snapshot.

Sharded training (``ctx``): each rank takes its B / n_data rows of the
global batch (``tcfg.microbatch`` is global, as in the reference) and
holds its block of every parameter (a placed model,
:func:`repro_torch.models.sharding.place_`).  The gradient of a
data-sharded weight is reduce-scattered onto its shard in the backward
(the reverse of the block's gather), so the microbatch accumulation
carries shards, as the reference's ``param_shardings=`` pin keeps its
carry; :func:`reduce_grads` all-reduces the rest over the data group --
and the router's and shared experts' over the model group too -- so one
step equals the reference's global jitted step.  Each rank owns its
blocks' gradients and optimizer state; the grad norm sums each leaf's
squares over the groups that shard it, Adafactor's statistics and
update RMS likewise (:class:`~repro_torch.models.sharding.LeafShards`);
the EF-int8 roundtrip blocks each leaf as the global leaf is blocked
(:func:`_compress`).  Checkpoints hold whole leaves in the reference's
format, assembled on disk by rank 0 one block at a time
(:func:`repro_torch.ckpt.save_with_placements`, synchronous); a restore
reads each rank's block, on any mesh shape
(:func:`repro_torch.ckpt.restore_with_placements`).
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.distributed as dist

from repro_torch import ckpt as ckptlib
from repro_torch.core.batched import resolve_device
from repro_torch.models import convert, lm, sharding
from repro_torch.optim import OptConfig, cosine_schedule, init_opt, opt_update

from . import compress as compress_lib

__all__ = ["TrainConfig", "make_train_step", "grads_of", "reduce_grads",
           "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatch: int = 0              # 0 = no gradient accumulation
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    grad_compression: str = "none"   # none | int8 (EF roundtrip)
    max_restarts: int = 5
    seed: int = 0
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def grads_of(model, batch, ctx=None):
    """(loss, {path: gradient of the reference's leaf}) of one batch, in
    the parameters' dtype; a parameter the loss does not reach gets
    zeros, as ``jax.grad`` gives.  With ``ctx``: the global loss and this
    rank's share of the gradient (:func:`reduce_grads` completes it)."""
    groups = convert.leaf_groups(model)
    loss = lm.loss_fn(model, batch, ctx)
    flat = [p for ps in groups.values() for p in ps]
    it = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = {}
    for path, ps in groups.items():
        gs = [next(it) for _ in ps]
        # contiguous: a reduction over the leaf (the grad norm, Adafactor's
        # statistics) then adds in one order whatever layout the backward
        # left (a tied embedding's is transposed; a sharded run's is not)
        grads[path] = convert.stack(path, [
            torch.zeros_like(p) if g is None else g.contiguous()
            for g, p in zip(gs, ps)])
    return loss.detach(), grads


def _leaf_group(path: str, spec=(), ctx=None) -> str | None:
    """The group a leaf's gradient is summed over here: "data" for an
    expert shard and every other parameter outside the MoE, "world" for
    the router and the shared experts (each model rank differentiates its
    own tokens through them); the data group drops out for a
    data-sharded leaf, whose gradient the reduce-scatter of its gather
    summed already."""
    name = path.replace("/", ".")
    partial = sharding.in_moe(name) and not sharding.is_expert(name)
    fsdp = ctx is not None and any(ax is not None and ax != ctx.model_axis
                                   for ax in spec)
    if fsdp:
        return "model" if partial else None
    return "world" if partial else "data"


def reduce_grads(grads: dict, ctx, specs=None) -> dict:
    """Each rank's gradient shares summed into the global gradient, one
    all-reduce per (group, dtype) over the leaves flattened together.
    ``specs``: {path: the leaf's placement}
    (:func:`~repro_torch.models.convert.leaf_shards`); a leaf without one
    is whole on every rank."""
    specs = specs or {}
    buckets: dict = {}
    for path, g in grads.items():
        group = _leaf_group(path, specs.get(path, ()), ctx)
        if group is not None:
            buckets.setdefault((group, g.dtype), []).append(path)
    out = dict(grads)
    for (group, _), paths in buckets.items():
        flat, views, _ = sharding.flat_bucket([grads[p] for p in paths])
        flat = sharding.all_reduce(flat, ctx, group)
        out.update(zip(paths, views(flat)))
    return out


def _aligned_shard(g, spec, shards, ax) -> bool:
    """The leaf's blocks of the EF-int8 roundtrip are the rank's own:
    only dimension ``ax`` (the first past a stacked leaf's group axis)
    is split, and each layer's part of the shard fills whole blocks."""
    others = [a for d, a in enumerate(spec) if d != ax and a is not None]
    if any(shards._group([a]) is not None for a in others):
        return False
    return math.prod(g.shape[ax:]) % compress_lib.BLOCK == 0


def _compress(grads, err_state, ctx, shards=None):
    """EF-int8 roundtrip of every leaf, blocked as the reference blocks
    the global leaf.  A leaf whole on the rank, or a shard that holds
    whole blocks of the global leaf, runs its roundtrip in place;
    otherwise the blocks straddle the ranks' blocks, so the gradient and
    its residual are gathered whole, the whole leaf goes through the
    roundtrip, and the rank keeps its block of both."""
    if shards is None:
        return compress_lib.compress_grads(grads, err_state)
    new_g, new_e = {}, {}
    for k, g in grads.items():
        spec = shards.specs.get(k, ())
        ax = 1 if convert.is_stacked(k) else 0
        if shards.leaf_group(k) is None or \
                _aligned_shard(g, spec, shards, ax):
            new_g[k], new_e[k] = compress_lib.ef_roundtrip(g, err_state[k])
            continue
        whole = [sharding.gather_whole(t, spec, ctx)
                 for t in (g, err_state[k])]
        new_g[k], new_e[k] = (sharding.block_of(t, spec, ctx).contiguous()
                              for t in compress_lib.ef_roundtrip(*whole))
    return new_g, new_e


def _accumulate(acc, grads, nm):
    """acc + g / nm in float32: the reference's float32 carry."""
    return {k: acc[k] + g.to(torch.float32) / nm for k, g in grads.items()}


def _microbatch(batch, i, mb):
    """Rows [i mb, (i + 1) mb) of every input; M-RoPE positions (3, B, S)
    on axis 1, as the reference slices "positions"."""
    return {k: v[:, i * mb:(i + 1) * mb] if k == "positions"
            else v[i * mb:(i + 1) * mb] for k, v in batch.items()}


def make_train_step(cfg, tcfg: TrainConfig, ctx=None, param_shardings=None):
    """Returns train_step(model, opt_state, err_state, batch, step) ->
    (model, opt_state, err_state, metrics): the model's parameters are
    updated in place; opt_state / err_state are the optimizer's and the
    compressor's state over :func:`~repro_torch.models.convert.stacks`'
    leaves; batch holds tensors on the model's device; metrics are
    float32 scalar tensors "loss", "grad_norm", "lr".

    With ``ctx`` the batch is this rank's rows and the model holds its
    rank's blocks; ``tcfg.microbatch`` counts global rows.
    ``param_shardings``: {parameter name: placement}
    (:func:`~repro_torch.models.sharding.param_placements`), as the
    reference's step takes them: the gradients, their accumulation and
    the optimizer state live on those shards, and the first call checks
    that the model holds them.  Default: the placements recorded on the
    model (:func:`~repro_torch.models.sharding.placements_of`)."""
    n_data = 1 if ctx is None else ctx.n_data
    if tcfg.microbatch % n_data:
        raise ValueError(f"microbatch {tcfg.microbatch} is no multiple of "
                         f"the {n_data} data ranks")
    leaves = {}

    def shards_of(model):
        """The leaves' placements, made (and the model checked against
        ``param_shardings``) on the first call."""
        if ctx is None:
            return None
        if "shards" not in leaves:
            if param_shardings is not None:
                for name, held in sharding.placements_of(model).items():
                    want = tuple(param_shardings.get(name, ()))
                    if held != want:
                        raise ValueError(
                            f"{name}: the model holds placement {held}, "
                            f"the step was made for {want}")
            leaves["shards"] = convert.leaf_shards(model, ctx,
                                                   param_shardings)
        return leaves["shards"]

    def train_step(model, opt_state, err_state, batch, step):
        shards = shards_of(model)
        if tcfg.microbatch:
            mb = tcfg.microbatch // n_data
            B = batch["labels"].shape[0]
            if B % mb:
                raise ValueError(f"batch {B} is no multiple of microbatch "
                                 f"{mb}")
            nm = B // mb
            loss = 0.0
            grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                     for k, v in convert.stacks(model).items()}
            for i in range(nm):
                l, g = grads_of(model, _microbatch(batch, i, mb), ctx)
                grads = _accumulate(grads, g, nm)
                loss = loss + l / nm
        else:
            loss, grads = grads_of(model, batch, ctx)
        if ctx is not None:
            grads = reduce_grads(grads, ctx, shards.specs)
        if tcfg.grad_compression == "int8":
            grads, err_state = _compress(grads, err_state, ctx, shards)
        lr = cosine_schedule(step, peak_lr=tcfg.opt.peak_lr,
                             warmup_steps=tcfg.opt.warmup_steps,
                             decay_steps=tcfg.opt.decay_steps)
        params, opt_state, gnorm = opt_update(
            tcfg.opt, grads, opt_state, convert.stacks(model), lr, shards)
        for path, ps in convert.leaf_groups(model).items():
            convert.write_back(path, ps, params[path])
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "lr": lr}
        return model, opt_state, err_state, metrics

    return train_step


def _ckpt_specs(tree, shards) -> dict:
    """{checkpoint key: placement} of the trainer's tree (params,
    opt_state, err_state): a parameter's, its optimizer moments' and
    residual's the leaf's; Adafactor's row statistic drops the last
    dimension, its column statistic the one before."""
    specs = shards.specs
    out = {}
    for key in ckptlib.flatten_paths(tree):
        part, _, rest = key.partition("/")
        spec = ()
        if part in ("0", "2"):
            spec = specs[rest]
        elif part == "1":
            kind, _, path = rest.partition("/")
            if kind in ("mu", "nu", "master"):
                spec = specs[path]
            elif kind == "stats":
                path, _, stat = path.rpartition("/")
                spec = specs[path]
                if spec and stat == "vr":
                    spec = spec[:-1]
                elif spec and stat == "vc":
                    spec = spec[:-2] + spec[-1:]
        out[key] = spec
    return out


class Trainer:
    """Fault-tolerant loop around the step, on ``device`` (None: the
    card; raises without one).  With ``ctx`` every rank of the mesh runs
    one Trainer on the same data stream, takes its rows and holds its
    blocks of a placed model; rank 0 writes the checkpoints (whole leaves)
    and every rank restores its blocks from them."""

    def __init__(self, cfg, tcfg: TrainConfig, data_stream, ctx=None,
                 policy=None, device=None):
        self.step_fn = make_train_step(cfg, tcfg, ctx)
        self.cfg = cfg
        self.ctx = ctx
        self.tcfg = tcfg
        self.data = data_stream
        self.policy = policy
        self.device = resolve_device(device)
        self.ckpt = ckptlib.AsyncCheckpointer(tcfg.ckpt_dir,
                                              keep_n=tcfg.keep_ckpts) \
            if ckptlib.process_index() == 0 else None
        self.history: list = []

    def _fresh_state(self):
        """The model from a seeded generator on the device, trainable,
        and its optimizer (and error-feedback) state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        model = lm.init(self.cfg, gen, self.device, self.ctx).trainable()
        params = convert.stacks(model)
        opt_state = init_opt(self.tcfg.opt, params)
        err_state = (compress_lib.init_error_state(params)
                     if self.tcfg.grad_compression == "int8" else None)
        return model, opt_state, err_state

    @staticmethod
    def _tree(model, opt_state, err_state):
        """The checkpoint's tree: (params, opt_state, err_state), keyed
        as the reference's; the rank's blocks of them on a mesh."""
        return convert.stacks(model), opt_state, err_state

    def _placements(self, tree, model):
        return None if self.ctx is None else _ckpt_specs(
            tree, convert.leaf_shards(model, self.ctx))

    def _wait(self):
        """Every write finished and, on a mesh, every rank past it."""
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.ctx is not None:
            dist.barrier(group=self.ctx.world_group)

    def _save(self, step, model, opt_state, err_state, meta):
        tree = self._tree(model, opt_state, err_state)
        if self.ctx is None:
            self.ckpt.save(step, tree, meta=meta)
            return
        ckptlib.save_with_placements(self.tcfg.ckpt_dir, step, tree,
                                     self._placements(tree, model),
                                     self.ctx, meta=meta)
        if self.ckpt is not None:
            ckptlib.gc_checkpoints(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    def _restore_or_init(self):
        model, opt_state, err_state = self._fresh_state()
        self._wait()
        last = ckptlib.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return 0, (model, opt_state, err_state)
        tree = self._tree(model, opt_state, err_state)
        if self.ctx is None:
            step, tree, _ = ckptlib.restore_to_device(
                self.tcfg.ckpt_dir, tree, self.device)
        else:
            step, tree, _ = ckptlib.restore_with_placements(
                self.tcfg.ckpt_dir, tree, self._placements(tree, model),
                self.ctx, self.device)
        params, opt_state, err_state = tree
        for path, ps in convert.leaf_groups(model).items():
            convert.write_back(path, ps, params[path])
        return step + 1, (model, opt_state, err_state)

    def _local(self, arrays):
        """The rank's rows of a global batch, on the device."""
        rows = slice(None)
        if self.ctx is not None:
            rows = self.ctx.local_rows(len(arrays["labels"]))
        return {k: torch.from_numpy(v[:, rows] if k == "positions"
                                    else v[rows]).to(self.device)
                for k, v in arrays.items()}

    def run(self, fail_hook=None):
        """fail_hook(step) may raise to simulate failures (tests).
        Returns (model, opt_state)."""
        start, (model, opt_state, err_state) = self._restore_or_init()
        restarts = 0
        step = start
        while step < self.tcfg.steps:
            try:
                if fail_hook is not None:
                    fail_hook(step)
                t0 = time.perf_counter()
                batch = self._local(self.data.batch_at(step))
                model, opt_state, err_state, metrics = self.step_fn(
                    model, opt_state, err_state, batch, step)
                loss = float(metrics["loss"])     # waits for the step
                step_s = time.perf_counter() - t0
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                self.history.append({"step": step, **{
                    k: float(v) for k, v in metrics.items()},
                    "step_s": step_s})
                if self.policy is not None:
                    self.policy.note_heartbeat(ckptlib.process_index(), step,
                                               time.time())
                if step % self.tcfg.ckpt_every == 0 or \
                        step == self.tcfg.steps - 1:
                    self._save(step, model, opt_state, err_state,
                               {"loss": loss})
                step += 1
            except (FloatingPointError, RuntimeError) as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                if self.ckpt is not None:
                    self.ckpt.wait()
                self.history.append({"step": step, "event": f"restart: {e}"})
                step, (model, opt_state, err_state) = self._restore_or_init()
        self._wait()
        return model, opt_state
