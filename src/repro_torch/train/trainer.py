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
holds its model rank's E / n_model experts; :func:`reduce_grads` sums the
gradients over the data group -- and the router's and shared experts'
over the model group too -- so one step equals the reference's global
jitted step.  Each model rank owns its experts' gradients and optimizer
state, and the grad norm sums the squares of the expert shards over the
model group, as does Adafactor's update RMS over an expert leaf; the
EF-int8 roundtrip blocks each leaf as the global leaf is blocked
(:func:`_compress`).  The non-expert parameters stay replicated (the
run-time FSDP / TP placements are ROADMAP.md queue 1 item 11e); with
``ctx`` each rank checkpoints into its own ``rank<r>`` subdirectory.
"""
from __future__ import annotations

import dataclasses
import math
import os
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
        grads[path] = convert.stack(path, [
            torch.zeros_like(p) if g is None else g for g, p in zip(gs, ps)])
    return loss.detach(), grads


def _leaf_group(path: str) -> str:
    """The group a leaf's gradient is summed over: "data" for an expert
    shard and every replicated parameter outside the MoE, "world" for the
    router and the shared experts (each model rank differentiates its
    own tokens through them)."""
    name = path.replace("/", ".")
    if sharding.in_moe(name) and not sharding.is_expert(name):
        return "world"
    return "data"


def reduce_grads(grads: dict, ctx) -> dict:
    """Each rank's gradient shares summed into the global gradient, one
    all-reduce per (group, dtype) over the leaves flattened together."""
    buckets: dict = {}
    for path, g in grads.items():
        buckets.setdefault((_leaf_group(path), g.dtype), []).append(path)
    out = dict(grads)
    for (group, _), paths in buckets.items():
        flat = torch.cat([grads[p].reshape(-1) for p in paths])
        flat = sharding.all_reduce(flat, ctx, group)
        for p, part in zip(paths, torch.split(
                flat, [grads[p].numel() for p in paths])):
            out[p] = part.view(grads[p].shape)
    return out


def _expert_sq_reducer(ctx):
    """Sum the experts' squared norms over the model group (the other
    leaves are whole on every rank)."""
    def reduce_sq(sq):
        keys = [k for k in sq if sharding.is_expert(k.replace("/", "."))]
        if not keys:
            return sq
        summed = sharding.all_reduce(torch.stack([sq[k] for k in keys]),
                                     ctx, "model")
        return {**sq, **dict(zip(keys, summed.unbind()))}
    return reduce_sq


def _compress(grads, err_state, ctx):
    """EF-int8 roundtrip of every leaf, blocked as the reference blocks
    the global leaf.  An expert shard whose experts fill whole blocks
    holds whole blocks of the global leaf; otherwise blocks straddle the
    model ranks' experts, so the shard and its residual are gathered over
    the model group, the whole leaf goes through the roundtrip, and the
    rank keeps its experts of both."""
    if ctx is None or ctx.n_model == 1:
        return compress_lib.compress_grads(grads, err_state)
    new_g, new_e = {}, {}
    for k, g in grads.items():
        ax = 1 if convert.is_stacked(k) else 0
        if not sharding.is_expert(k.replace("/", ".")) or \
                math.prod(g.shape[ax:]) % compress_lib.BLOCK == 0:
            new_g[k], new_e[k] = compress_lib.ef_roundtrip(g, err_state[k])
            continue
        whole = [sharding.all_gather(t, ctx, ax) for t in (g, err_state[k])]
        el, r = g.shape[ax], ctx.model_rank
        new_g[k], new_e[k] = (t.narrow(ax, r * el, el).contiguous()
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


def make_train_step(cfg, tcfg: TrainConfig, ctx=None):
    """Returns train_step(model, opt_state, err_state, batch, step) ->
    (model, opt_state, err_state, metrics): the model's parameters are
    updated in place; opt_state / err_state are the optimizer's and the
    compressor's state over :func:`~repro_torch.models.convert.stacks`'
    leaves; batch holds tensors on the model's device; metrics are
    float32 scalar tensors "loss", "grad_norm", "lr".

    With ``ctx`` the batch is this rank's rows and the model holds its
    rank's experts; ``tcfg.microbatch`` counts global rows."""
    n_data = 1 if ctx is None else ctx.n_data
    if tcfg.microbatch % n_data:
        raise ValueError(f"microbatch {tcfg.microbatch} is no multiple of "
                         f"the {n_data} data ranks")
    reduce_sq = None if ctx is None else _expert_sq_reducer(ctx)

    def train_step(model, opt_state, err_state, batch, step):
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
            grads = reduce_grads(grads, ctx)
        if tcfg.grad_compression == "int8":
            grads, err_state = _compress(grads, err_state, ctx)
        lr = cosine_schedule(step, peak_lr=tcfg.opt.peak_lr,
                             warmup_steps=tcfg.opt.warmup_steps,
                             decay_steps=tcfg.opt.decay_steps)
        params, opt_state, gnorm = opt_update(
            tcfg.opt, grads, opt_state, convert.stacks(model), lr, reduce_sq)
        for path, ps in convert.leaf_groups(model).items():
            convert.write_back(path, ps, params[path])
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "lr": lr}
        return model, opt_state, err_state, metrics

    return train_step


class Trainer:
    """Fault-tolerant loop around the step, on ``device`` (None: the
    card; raises without one).  With ``ctx`` every rank of the mesh runs
    one Trainer on the same data stream, takes its rows, and checkpoints
    into ``ckpt_dir/rank<r>``."""

    def __init__(self, cfg, tcfg: TrainConfig, data_stream, ctx=None,
                 policy=None, device=None):
        self.step_fn = make_train_step(cfg, tcfg, ctx)
        self.cfg = cfg
        self.ctx = ctx
        if ctx is not None:
            tcfg = dataclasses.replace(tcfg, ckpt_dir=os.path.join(
                tcfg.ckpt_dir, f"rank{dist.get_rank()}"))
        self.tcfg = tcfg
        self.data = data_stream
        self.policy = policy
        self.device = resolve_device(device)
        self.ckpt = ckptlib.AsyncCheckpointer(tcfg.ckpt_dir,
                                              keep_n=tcfg.keep_ckpts)
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
        as the reference's."""
        return convert.stacks(model), opt_state, err_state

    def _restore_or_init(self):
        model, opt_state, err_state = self._fresh_state()
        last = ckptlib.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return 0, (model, opt_state, err_state)
        step, (params, opt_state, err_state), _ = ckptlib.restore_to_device(
            self.tcfg.ckpt_dir, self._tree(model, opt_state, err_state),
            self.device)
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
                    self.ckpt.save(step, self._tree(model, opt_state,
                                                    err_state),
                                   meta={"loss": loss})
                step += 1
            except (FloatingPointError, RuntimeError) as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                self.ckpt.wait()
                self.history.append({"step": step, "event": f"restart: {e}"})
                step, (model, opt_state, err_state) = self._restore_or_init()
        self.ckpt.wait()
        return model, opt_state
