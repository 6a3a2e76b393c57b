"""Production-mesh dry run: trace one rank's program of every
(architecture x input shape x mesh) cell on meta tensors and record its
FLOPs, HBM bytes, collectives and memory -- the port of
``repro/launch/dryrun.py`` (with ``patch_bytes.py`` folded in).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out artifacts/dryrun_torch

One process, no process group, no card: the mesh is shape-only
(:func:`repro_torch.launch.mesh.make_production_mesh` without a group),
so a collective on a meta tensor returns a meta tensor of the right shape
and records its bytes (:data:`repro_torch.models.sharding.COLLECTIVES`).
Every rank of a cell runs the same shapes, so rank 0's program stands for
all of them.  (Faking 512 ranks with torch's fake process group is the
other route; it is internal API and would trace the same program 512
times.)

Per cell ``<out>/<arch>__<shape>__<single|multi>.json`` holds the
reference's keys where they still mean something:

  flops_analytic_global      the reference's definition: the logical
                             program at global shapes -- the rank's
                             replicated work times the data ranks that
                             split the batch, its model-split work
                             (``sharding.split_work``) times those and
                             the model axis, its MoE work times the mesh
                             size (the reference's shard_map body), the
                             folded attention kernel counted as the
                             reference's chunked attention (every query
                             against every key);
  flops_analytic_per_device  that over the devices;
  flops_executed_per_device  the rank's own program: the placed model's
                             blocks of every layer (work the rules cannot
                             split -- heads cut by the rules' columns,
                             the RWKV token shift -- replicated over the
                             model axis), the attention kernel's causal
                             blocks;
  bytes_analytic_per_device  the reference's analytic bytes (counted ops'
                             operands and results, plus the global inputs
                             and outputs) over the devices;
  collectives                bytes and calls by op, forward and backward;
  memory                     argument_gb / output_gb under the rules'
                             placements, and *_runtime_gb: what the
                             port's placed rank holds (its parameter
                             blocks, optimizer state and decode states;
                             the serving logits gathered over the vocab);
                             temp_gb null, with the reason;
  checkpoint_extra_gb        (train cells) the device bytes a placed
                             rank adds while it saves a checkpoint: the
                             stacked copy of its parameter blocks and
                             the largest block in transit;
  trace_s                    in place of lower_s / compile_s.

The CLI is the reference's but for ``--save-hlo``: eager PyTorch compiles
no HLO, and the collective counter stands in for ``launch/hlo.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import shapes_for
from repro_torch.core import batched, parallel
from repro_torch.launch import specs as speclib
from repro_torch.launch.flops import Counter, active
from repro_torch.launch.mesh import make_ctx, make_mesh, make_production_mesh
from repro_torch.models import convert, lm
from repro_torch.models import sharding as shlib
from repro_torch.optim import OptConfig, init_opt
from repro_torch.train import TrainConfig, make_train_step

__all__ = ["all_cells", "run_cell", "build_train", "build_prefill",
           "build_decode", "build_soft", "main"]

BIG_PARAM_THRESHOLD = 50e9   # adafactor above this (optimizer memory)
META = "meta"

ACT_BUDGET_GB = float(os.environ.get("REPRO_ACT_BUDGET_GB", "6.0"))
# per-device activation-carry budget -> microbatching (the reference's)


def _auto_microbatch(cfg, ctx, B, S):
    """The reference's gradient-accumulation size: the largest local
    microbatch whose saved layer carries fit ACT_BUDGET_GB (under nested
    remat the outer carries plus one inner segment's).  Returns (global
    microbatch or 0, accumulation steps)."""
    ndp = ctx.n_data
    b_loc = max(B // ndp, 1)
    pat = len(cfg.block_pattern)
    G = cfg.num_layers // pat
    if cfg.remat == "nested" and G:
        gi = cfg.remat_inner or max(int(math.sqrt(G)), 1)
        while G % gi:
            gi -= 1
        carries = G // gi + 3 * gi
    else:
        carries = G
    per_seq = S * cfg.d_model * 2 * carries * pat  # bf16 carries
    mb = b_loc
    while mb > 1 and mb * per_seq > ACT_BUDGET_GB * 1e9:
        mb //= 2
    micro = b_loc // mb
    return (mb * ndp if micro > 1 else 0), micro


@dataclasses.dataclass
class Cell:
    """One rank's program (``run``) and what the record needs."""
    run: object
    sharded: tuple = ()            # modules whose work scales by the mesh
    data_size: int = 1             # ranks that split the batch
    rules: dict = dataclasses.field(default_factory=dict)   # placements
    runtime: dict = dataclasses.field(default_factory=dict)  # rank's copy
    outputs_rules_bytes: int = 0
    outputs_runtime_bytes: int = 0
    global_io_bytes: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _meta_like(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _local_batch(batch, shards, ctx):
    return {k: _meta_like(speclib.local_shape(v.shape, shards[k], ctx)
                          if ctx.batch_sharded(v.shape[1 if k == "positions"
                                                       else 0]) else
                          v.shape, v.dtype)
            for k, v in batch.items()}


def _model(cfg, ctx):
    """(the rank's meta model placed under the rules, their placements,
    the rules' bytes of a rank, the parameters' global bytes)."""
    model, placements = speclib.params_specs(cfg, ctx)
    params = dict(model.named_parameters())
    rules_bytes = speclib.placement_bytes(params, placements, ctx)
    global_bytes = _bytes(params.values())
    shlib.place_(model, ctx, placements)
    return model, placements, rules_bytes, global_bytes


def _moe_modules(model):
    return tuple(b.moe for b in model.blocks if hasattr(b, "moe"))


def meta_attention(q, k, v, *, bq, bk):
    """Stand-in for the folded attention kernel on meta tensors: the
    output's shape, and the kernel's count -- executed FLOPs over its
    causal blocks (nb (nb + 1) / 2 blocks of 4 bq^2 D a head), logical
    FLOPs as the reference's chunked attention (4 S^2 D a head), bytes
    q, k, v read and out written once."""
    B, Hq, S, D = q.shape
    nb = S // bq
    out = torch.empty_like(q)
    c = active()
    if c is not None:
        c.note("folded_causal_attention",
               4 * B * Hq * D * bq * bq * nb * (nb + 1) // 2,
               _bytes((q, k, v, out)), logical=4 * B * Hq * S * S * D)
    return out


def build_train(cfg, ctx, shape, opt_name) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    micro_b, n_acc = _auto_microbatch(cfg, ctx, B, S)
    tcfg = TrainConfig(opt=OptConfig(name=opt_name), microbatch=micro_b)
    model, p_sh, p_rules, p_global = _model(cfg, ctx)
    model.trainable()
    full = lm.LM(cfg, device=META)
    o_full, o_place = speclib.opt_specs(cfg, ctx, tcfg.opt, full)
    o_flat = _flat(o_full)
    o_rules = speclib.placement_bytes(o_flat, o_place, ctx)
    del full, o_full
    opt_state = init_opt(tcfg.opt, convert.stacks(model))
    batch, b_sh = speclib.batch_specs(cfg, B, S, ctx, with_labels=True)
    local = _local_batch(batch, b_sh, ctx)
    step = make_train_step(cfg, tcfg, ctx, param_shardings=p_sh)

    def run():
        return step(model, opt_state, None, local, 0)

    p_run = _bytes(model.parameters())
    o_run = _bytes(_flat(opt_state).values())
    # a placed save (ckpt.save_with_placements) adds on a rank's device the
    # stacked copy of its parameter blocks and one block in transit
    stacks = convert.stacks(model)
    ckpt_extra = _bytes(v for k, v in stacks.items()
                        if convert.is_stacked(k)) + max(
        _bytes([t]) for t in [*stacks.values(), *_flat(opt_state).values()])
    return Cell(run=run, sharded=_moe_modules(model),
                data_size=ctx.n_data if ctx.batch_sharded(B) else 1,
                rules={"params": p_rules, "opt": o_rules,
                       "batch": speclib.placement_bytes(batch, b_sh, ctx)},
                runtime={"params": p_run, "opt": o_run,
                         "batch": _bytes(local.values())},
                outputs_rules_bytes=p_rules + o_rules,
                outputs_runtime_bytes=p_run + o_run,
                global_io_bytes=2 * (p_global + _bytes(o_flat.values()))
                + _bytes(batch.values()),
                extra={"microbatch_global": micro_b,
                       "grad_accum_steps": n_acc,
                       "checkpoint_extra_gb": ckpt_extra / 1e9})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _states_bytes(cfg, B, S, ctx, local_B):
    states = lm.state_init(cfg, B, S, device=META)
    sh = speclib.state_shardings(cfg, states, ctx, B)
    rules = sum(speclib.placement_bytes(st, s, ctx)
                for st, s in zip(states, sh))
    run = _bytes(t for st in lm.state_init(cfg, local_B, S, device=META,
                                           ctx=ctx)
                 for t in st.values())
    return rules, run, _bytes(t for st in states for t in st.values())


def build_prefill(cfg, ctx, shape) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    model, _, p_rules, p_global = _model(cfg, ctx)
    batch, b_sh = speclib.batch_specs(cfg, B, S, ctx, with_labels=False)
    local = _local_batch(batch, b_sh, ctx)
    bl = B // ctx.n_data if ctx.batch_sharded(B) else B
    st_rules, st_run, st_global = _states_bytes(cfg, B, S, ctx, bl)
    dp = speclib._dp_or_none(ctx, B)
    logits_rules = math.prod(speclib.local_shape(
        (B, cfg.vocab_size), (dp, ctx.model_axis), ctx)) * 4

    def run():
        return model.prefill(local.get("tokens"), S,
                             embeds=local.get("embeds"),
                             positions=local.get("positions"),
                             attn_fn=meta_attention, ctx=ctx)

    return Cell(run=run, sharded=_moe_modules(model),
                data_size=ctx.n_data if ctx.batch_sharded(B) else 1,
                rules={"params": p_rules,
                       "batch": speclib.placement_bytes(batch, b_sh, ctx)},
                runtime={"params": _bytes(model.parameters()),
                         "batch": _bytes(local.values())},
                outputs_rules_bytes=logits_rules + st_rules,
                outputs_runtime_bytes=bl * cfg.vocab_size * 4 + st_run,
                global_io_bytes=p_global + _bytes(batch.values())
                + B * cfg.vocab_size * 4 + st_global)


def build_decode(cfg, ctx, shape) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    model, _, p_rules, p_global = _model(cfg, ctx)
    (batch, states, pos), (b_sh, st_sh, _) = speclib.decode_specs(cfg, B, S,
                                                                  ctx)
    local = _local_batch(batch, b_sh, ctx)
    bl = B // ctx.n_data if ctx.batch_sharded(B) else B
    st_local = lm.state_init(cfg, bl, S, device=META, ctx=ctx)
    st_rules = sum(speclib.placement_bytes(st, s, ctx)
                   for st, s in zip(states, st_sh))
    st_run = _bytes(t for st in st_local for t in st.values())
    st_global = _bytes(t for st in states for t in st.values())
    dp = speclib._dp_or_none(ctx, B)
    logits_rules = math.prod(speclib.local_shape(
        (B, cfg.vocab_size), (dp, ctx.model_axis), ctx)) * 4

    def run():
        return model.decode_step(local.get("tokens"), st_local, pos,
                                 embeds=local.get("embeds"), ctx=ctx)

    return Cell(run=run, sharded=_moe_modules(model),
                data_size=ctx.n_data if ctx.batch_sharded(B) else 1,
                rules={"params": p_rules, "states": st_rules,
                       "batch": speclib.placement_bytes(batch, b_sh, ctx)},
                runtime={"params": _bytes(model.parameters()),
                         "states": st_run, "batch": _bytes(local.values())},
                outputs_rules_bytes=logits_rules + st_rules,
                outputs_runtime_bytes=bl * cfg.vocab_size * 4 + st_run,
                global_io_bytes=p_global + 2 * st_global
                + _bytes(batch.values()) + B * cfg.vocab_size * 4)


class _RankTrace(parallel.DistExecutor):
    """Rank 0 of a DistExecutor over ``n_shards`` with no process group:
    its collectives return meta tensors of the right shape and are
    counted."""

    def __init__(self, plan, n_shards):
        self.mesh, self.axis = None, ()
        self._bind(plan, n_shards, None, 0, 1, None, None, "off")

    def _all_to_all(self, send, direction, out=None, async_op=False):
        out = torch.empty_like(send) if out is None else out
        shlib.note_collective("all-to-all", out)
        parallel.ALL_TO_ALLS[direction] += 1
        return out, None

    def _gather(self, x, dim: int):
        if self.n_shards == 1:
            return x
        shape = list(x.shape)
        shape[dim] *= self.n_shards
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        shlib.note_collective("all-gather", out)
        return out


def build_soft(soft_cfg, ctx, direction="forward") -> Cell:
    """The paper's transform on the mesh: shard over the largest suffix
    of the mesh axes whose size divides the beta axis 2B (leading axes
    replicate, as in the reference), the plain dense contraction
    (``REPRO_SOFT_IMPL=plain``, the reference's default)."""
    B = soft_cfg.bandwidth
    names = tuple(ctx.axis_names)
    axis = names
    while axis and (2 * B) % ctx.axis_size(axis):
        axis = axis[1:]
    if not axis:
        raise ValueError(f"no mesh suffix divides beta axis {2 * B}")
    n = ctx.axis_size(axis)
    plan = speclib.soft_plan_specs(B, n)
    ex = _RankTrace(plan, n)
    leaves = {k: getattr(plan, k) for k in batched.PLAN_LEAVES}
    sh = speclib.soft_shardings(plan, ctx, axis)
    rules = speclib.placement_bytes(leaves, sh, ctx)
    runtime = sum(t.numel() * t.element_size() // (n if sh[k] else 1)
                  for k, t in leaves.items())
    cd = plan.cdtype
    if direction == "forward":
        x = _meta_like((2 * B,) * 3, cd)
        run = lambda: ex.forward(x)          # noqa: E731
        out_bytes = plan.n_padded * B * 8 * x.element_size()
    else:
        x = _meta_like((plan.n_padded, B, 8), cd)
        run = lambda: ex.inverse(x)          # noqa: E731
        out_bytes = (2 * B) ** 3 * x.element_size()
    return Cell(run=run, sharded=(), data_size=1,
                rules={"plan": rules, "input": _bytes([x])},
                runtime={"plan": runtime, "input": _bytes([x])},
                outputs_rules_bytes=out_bytes,
                outputs_runtime_bytes=out_bytes,
                global_io_bytes=_bytes(leaves.values()) + _bytes([x])
                + out_bytes,
                extra={"soft_axis": list(axis), "n_shards": n,
                       "whole_program_sharded": True})


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

TEMP_GB_REASON = ("not measured: the rank's program runs on meta tensors, "
                  "which hold no storage; a peak of temporaries needs "
                  "FakeTensorMode with torch's memory tracker")


def _ctx_for(multi_pod, mesh_shape):
    if mesh_shape:   # hillclimb override: same chips, different DP/TP split
        dims = tuple(int(x) for x in mesh_shape.split("x"))
        names = ("pod", "data", "model")[-len(dims):]
        return make_ctx(make_mesh(dims, names)), "pod" + mesh_shape
    return (make_ctx(make_production_mesh(multi_pod=multi_pod)),
            "pod2x16x16" if multi_pod else "pod16x16")


def run_cell(arch, shape_name, multi_pod, opt_override=None, remat=None,
             mesh_shape=None, ctx=None, cfg=None):
    """Trace one cell; returns its record.  ``ctx`` overrides the mesh
    and ``cfg`` the architecture's config (tests pass a small shape-only
    mesh and a reduced config)."""
    if ctx is None:
        ctx, mesh_name = _ctx_for(multi_pod, mesh_shape)
    else:
        mesh_name = "x".join(map(str, ctx.shape))
    devices = ctx.size
    if arch.startswith("soft_b"):
        soft_cfg = configs.SOFT_CONFIGS[arch]
        cell = build_soft(soft_cfg, ctx, "forward" if shape_name == "forward"
                          else "inverse")
        extra = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": "soft", "bandwidth": soft_cfg.bandwidth,
                 "devices": devices, **cell.extra}
    else:
        cfg = cfg or configs.get(arch)
        if remat:
            cfg = dataclasses.replace(cfg, remat=remat)
        shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
        n_params = lm.count_params(cfg)
        opt_name = opt_override or (
            "adafactor" if n_params > BIG_PARAM_THRESHOLD else "adamw")
        if shape.kind == "train":
            cell = build_train(cfg, ctx, shape, opt_name)
        elif shape.kind == "prefill":
            cell = build_prefill(cfg, ctx, shape)
        else:
            cell = build_decode(cfg, ctx, shape)
        extra = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind, "devices": devices,
                 "params": n_params, **cell.extra,
                 "active_params": lm.count_active_params(cfg),
                 "tokens": shape.global_batch * (shape.seq_len
                                                 if shape.kind != "decode"
                                                 else 1),
                 "seq_len": shape.seq_len,
                 "global_batch": shape.global_batch,
                 "opt": opt_name if shape.kind == "train" else None}
    shlib.reset_collectives()
    t0 = time.perf_counter()
    whole = cell.extra.get("whole_program_sharded", False)
    with Counter(cell.sharded, split=not whole) as c:
        cell.run()
    trace_s = time.perf_counter() - t0
    if whole:
        flops_global = devices * (c.flops + c.logical_extra)
        bytes_global = devices * c.bytes
    else:
        flops_global = c.global_flops(devices, cell.data_size, ctx.n_model)
        bytes_global = c.global_bytes(devices, cell.data_size, ctx.n_model)
    bytes_global += cell.global_io_bytes
    res = {
        "flops_analytic_global": float(flops_global),
        "flops_analytic_per_device": float(flops_global) / devices,
        "flops_executed_per_device": float(c.flops),
        "flops_moe_per_device": float(c.sharded_flops),
        "flops_split_per_device": float(c.split_flops),
        "bytes_analytic_per_device": float(bytes_global) / devices,
        "flops_by_op_per_device": c.by_op,
        "collectives": shlib.collective_summary(),
        "memory": {
            "argument_gb": sum(cell.rules.values()) / 1e9,
            "output_gb": cell.outputs_rules_bytes / 1e9,
            "argument_runtime_gb": sum(cell.runtime.values()) / 1e9,
            "output_runtime_gb": cell.outputs_runtime_bytes / 1e9,
            "argument_parts_gb": {k: v / 1e9 for k, v in cell.rules.items()},
            "argument_runtime_parts_gb": {k: v / 1e9
                                          for k, v in cell.runtime.items()},
            "temp_gb": None, "temp_gb_reason": TEMP_GB_REASON,
        },
        "trace_s": trace_s,
    }
    res.update(extra)
    gap = c.flops / max(res["flops_analytic_per_device"], 1.0)
    print(f"[dryrun] {arch} {shape_name} {mesh_name}: trace {trace_s:.1f}s "
          f"flops/dev {res['flops_analytic_per_device']:.3e} (executed "
          f"{res['flops_executed_per_device']:.3e}, x{gap:.2f}) coll "
          f"{res['collectives']['total']:.3e}B args "
          f"{res['memory']['argument_gb']:.2f}GB (runtime "
          f"{res['memory']['argument_runtime_gb']:.2f}GB)", flush=True)
    return res


def all_cells():
    cells = []
    for arch in configs.ARCH_NAMES:
        for s in shapes_for(configs.get(arch)):
            cells.append((arch, s.name))
    for name in ("soft_b128", "soft_b256", "soft_b512"):
        cells.append((name, "forward"))
        cells.append((name, "inverse"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--opt", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 64x4 (data x model), hillclimb override")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t_all = time.perf_counter()
    failures = []
    for arch, shape in cells:
        for multi in meshes:
            cell_id = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            out_path = os.path.join(args.out, cell_id + ".json")
            if os.path.exists(out_path):
                print(f"[dryrun] skip existing {cell_id}")
                continue
            try:
                res = run_cell(arch, shape, multi, args.opt, args.remat,
                               args.mesh_shape)
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
            except Exception as e:
                failures.append((cell_id, repr(e)))
                print(f"[dryrun] FAIL {cell_id}: {e}")
                traceback.print_exc()
                if not args.continue_on_error:
                    raise
    print(f"[dryrun] {len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for cid, err in failures:
            print("  ", cid, err)
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
