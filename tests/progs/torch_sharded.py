"""Subprocess program: one rank of a gloo process group running the
port's sharded LM paths on the CPU.  Run by tests/test_torch_moe_sharded.py
and tests/test_torch_lm_sharded.py, one process per rank:

    python torch_sharded.py {moe|lm|placed} RANK WORLD INIT_FILE REF_NPZ \\
        OUT_DIR MESH [MESH ...]

MESH is "<n_data>x<n_model>" with n_data * n_model == WORLD.  Weights,
inputs and batches come from REF_NPZ (written by sharded_ref.py); the
rank takes its rows of every batch and writes OUT_DIR/rank<RANK>.npz.

moe: per arch and mesh, the MoE module with its experts placed over the
model axis (``sharding.place_``): ``moe_apply(ctx)``'s output and aux,
and (with n_model > 1) the same with the all-to-all's source chunks
rotated by one rank (a planted fault).

lm: per arch and mesh, the model placed by ``params_from_numpy(...,
ctx=)`` (every parameter the rank's block under the reference's rules):
the global loss and the rank's block of the reduced gradient
(``grads_of`` + ``reduce_grads``), ``prefill(ctx)`` logits and states,
one ``decode_step(ctx)``; at meshes 1x4 and 2x2 the loss and gradient
of a (4, 15) batch (the MoE's non-sequence-parallel branch), and the
same with the branch's 1 / n_model cotangent factor dropped (a planted
fault); for olmoe three ``make_train_step(ctx)`` steps of each train
case of the mesh (sharded_ref.py's ``train_cases``; the rank's blocks
of the parameters, the residuals whole), with planted faults
for two of them (Adafactor's update RMS taken over the rank's experts
only; EF-int8 blocked over the rank's shard), at capacity 8 with aux
weight 0 the sharded loss and gradient beside the local path's on the
global batch, and three steps of ``Trainer(ctx=)`` on a synthetic
stream.

placed: per arch of sharded_ref.py's placed part (reduced olmoe-1b-7b,
llama4-maverick-400b-a17b, glm4-9b) and mesh, the model placed by
``params_from_numpy(..., ctx=)``: each parameter's shape, the global loss
and the rank's block of every gradient, ``prefill(ctx)`` / one
``decode_step(ctx)`` logits and states (the rank's rows, heads or
slots), three ``make_train_step(..., param_shardings=)`` steps of AdamW
and of Adafactor (loss, grad norm, the rank's blocks of the parameters,
the optimizer state's shapes); planted faults: every leaf's square
summed over every rank in the grad norm (a replicated leaf counted once
a rank), and wo's partial sums not all-reduced.  For glm4-9b the
elastic checkpoint: two ``Trainer(ctx=)`` steps at 2x2 writing whole
leaves to ELASTIC_DIR (OUT_DIR's parent), the third step from the
trainer's state, and at 4x1 and 1x1 the step-1 checkpoint restored
(``restore_with_placements``) and the third step from it.  Imports only
repro_torch."""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_ctx, make_test_mesh  # noqa: E402
from repro_torch import ckpt as ckptlib  # noqa: E402
from repro_torch.models import attention, convert, moe, sharding  # noqa
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import OptConfig, init_opt, optimizers  # noqa: E402
from repro_torch.train import compress as compress_lib  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
S, MAX_LEN = 16, 24
S_NOSP, NOSP_MESHES = 15, ("1x4", "2x2")
OPT = dict(name="adamw", peak_lr=1e-2, warmup_steps=1, decay_steps=10)
TRAIN_STEPS = 3
# sharded_ref.py's train cases: case -> (optimizer, grad_compression,
# EF-int8 block)
TRAIN = {"adamw": (OPT, "none", 2048),
         "adafactor": (dict(OPT, name="adafactor"), "none", 2048),
         "int8": (OPT, "int8", 2048),
         "int8_unaligned": (OPT, "int8", 1536)}
OUT_DIR = "."


def train_cases(mesh):
    """The cases sharded_ref.py runs at ``mesh``."""
    return list(TRAIN) if mesh in NOSP_MESHES else ["adamw"]


def _per_slice_rms(k, u, eps, shards=None):
    """Planted fault: Adafactor's update RMS over the rank's own slice."""
    return _real_update_rms(k, u, eps)


def _per_rank_blocks(grads, err_state, ctx, shards=None):
    """Planted fault: EF-int8 blocks over the rank's shard of a leaf."""
    return compress_lib.compress_grads(grads, err_state)


_real_update_rms = optimizers._update_rms
# case -> (module, attribute, planted fault)
FAULTS = {"adafactor": (optimizers, "_update_rms", _per_slice_rms),
          "int8_unaligned": (trainer, "_compress", _per_rank_blocks)}


def nest(ref, prefix):
    """The reference's nested tree under ``prefix`` from the flat npz
    ("groups" / "tail" and every all-digit level become lists)."""
    root = {}
    for key in ref.files:
        if not key.startswith(prefix + "/"):
            continue
        node = root
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = ref[key]

    def lists(n):
        if not isinstance(n, dict):
            return n
        n = {k: lists(v) for k, v in n.items()}
        if n and all(k.isdigit() for k in n):
            return [n[str(i)] for i in range(len(n))]
        return n
    out = lists(root)
    out.setdefault("groups", [])
    out.setdefault("tail", [])
    return out


def rotated_all_to_all(orig):
    def fault(x, ctx):
        out = orig(x, ctx)
        n = ctx.n_model
        return out.reshape(n, -1, *out.shape[1:]).roll(1, 0).reshape(
            out.shape)
    return fault


def moe_part(ref, ctx, m, out):
    for arch in ARCHS:
        cfg = configs.reduced(arch)
        x = torch.from_numpy(ref[f"{arch}/x"])
        rows = ctx.local_rows(x.shape[0])
        mod = moe.MoE(cfg, torch.float32)
        p = nest(ref, f"{arch}/p")
        for name, prm in mod.named_parameters():
            a = p
            for k in name.split("."):
                a = a[k]
            prm.data.copy_(torch.from_numpy(np.asarray(a)))
        spec = (ctx.model_axis, None, None)
        sharding.place_(mod, ctx, {"wi": spec, "wo": spec})
        y, aux = moe.moe_apply(mod, x[rows], ctx)
        out[f"{arch}/{m}/out"] = y.numpy()
        out[f"{arch}/{m}/aux"] = aux.numpy()
        if ctx.n_model > 1:
            orig = sharding.all_to_all
            moe.sharding.all_to_all = rotated_all_to_all(orig)
            try:
                y, _ = moe.moe_apply(mod, x[rows], ctx)
            finally:
                moe.sharding.all_to_all = orig
            out[f"{arch}/{m}/out_fault"] = y.numpy()


def _placed(cfg, tree, ctx):
    """The reference's weights ``tree``, placed on ``ctx`` and
    trainable."""
    return convert.params_from_numpy(cfg, tree, "cpu", ctx=ctx).trainable()


def _specs(model, ctx):
    return convert.leaf_shards(model, ctx).specs


def _local(batch, rows):
    return {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in
            batch.items()}


def _save_grads(out, tag, grads):
    for k, g in grads.items():
        out[f"{tag}/{k}"] = g.detach().float().numpy()


def lm_part(ref, ctx, m, out):
    for arch in ARCHS:
        cfg = configs.reduced(arch)
        tree = nest(ref, f"{arch}/params")
        batch = {k: ref[f"{arch}/batch/{k}"] for k in ("tokens", "labels")}
        rows = ctx.local_rows(batch["tokens"].shape[0])
        model = _placed(cfg, tree, ctx)
        loss, grads = trainer.grads_of(model, _local(batch, rows), ctx)
        grads = trainer.reduce_grads(grads, ctx, _specs(model, ctx))
        out[f"{arch}/{m}/loss"] = loss.numpy()
        _save_grads(out, f"{arch}/{m}/grads", grads)
        if m in NOSP_MESHES:
            nosp(ref, model, ctx, rows, f"{arch}/{m}", out)

        tokens = torch.from_numpy(batch["tokens"][rows])
        logits, states = model.prefill(tokens, MAX_LEN, ctx=ctx)
        out[f"{arch}/{m}/prefill_logits"] = logits.numpy()
        for i, st in enumerate(states):
            for k, v in st.items():
                out[f"{arch}/{m}/states/{i}/{k}"] = v.numpy().copy()
        nxt = torch.from_numpy(ref[f"{arch}/next"][rows])
        logits, states = model.decode_step(nxt, states, S, ctx=ctx)
        out[f"{arch}/{m}/decode_logits"] = logits.numpy()
        for i, st in enumerate(states):
            for k, v in st.items():
                out[f"{arch}/{m}/decode_states/{i}/{k}"] = v.numpy()
        if arch != ARCHS[0]:
            continue
        for case in train_cases(m):
            train(cfg, tree, ctx, rows, f"{arch}/{m}/train/{case}",
                  *TRAIN[case], out)
            if case in FAULTS:
                mod, name, fault = FAULTS[case]
                real = getattr(mod, name)
                setattr(mod, name, fault)
                try:
                    train(cfg, tree, ctx, rows,
                          f"{arch}/{m}/train/{case}_fault", *TRAIN[case],
                          out)
                finally:
                    setattr(mod, name, real)
        invariant(cfg, tree, batch, ctx, rows, m, arch, out)
        trainer_run(cfg, ctx, m, arch, out)


def no_drops(cfg):
    """Capacity 8 (no token dropped) and aux weight 0: the sharded MoE
    computes the local one's function."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, router_aux_weight=0.0))


def trainer_setup(cfg, ckpt_dir):
    """The fault-tolerant loop's settings: 3 steps of a 4 x 16 synthetic
    stream from seeded weights, at :func:`no_drops`
    (tests/test_torch_lm_sharded.py runs the same without ctx)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    tcfg = trainer.TrainConfig(steps=3, ckpt_every=2, ckpt_dir=ckpt_dir,
                               opt=OptConfig(**OPT))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=4, mean_doc_len=8))
    return no_drops(cfg), tcfg, data


def trainer_run(cfg, ctx, m, arch, out):
    cfg, tcfg, data = trainer_setup(cfg, f"{OUT_DIR}/ckpt_{m}")
    tr = trainer.Trainer(cfg, tcfg, data, ctx=ctx, device="cpu")
    tr.run()
    out[f"{arch}/{m}/trainer_losses"] = np.asarray(
        [h["loss"] for h in tr.history if "loss" in h])


def nosp(ref, model, ctx, rows, tag, out):
    """Loss and gradient of the (4, 15) batch, and the same with the
    non-sequence-parallel branch's cotangent factor 1 / n_model dropped."""
    arch = tag.split("/")[0]
    batch = _local({k: ref[f"{arch}/nosp_batch/{k}"]
                    for k in ("tokens", "labels")}, rows)
    specs = _specs(model, ctx)
    loss, grads = trainer.grads_of(model, batch, ctx)
    out[f"{tag}/nosp/loss"] = loss.numpy()
    _save_grads(out, f"{tag}/nosp/grads",
                trainer.reduce_grads(grads, ctx, specs))
    real = sharding.scale_grad
    sharding.scale_grad = lambda x, factor: x
    try:
        _, grads = trainer.grads_of(model, batch, ctx)
    finally:
        sharding.scale_grad = real
    _save_grads(out, f"{tag}/nosp_fault/grads",
                trainer.reduce_grads(grads, ctx, specs))


def train(cfg, tree, ctx, rows, tag, opt, comp, block, out):
    tcfg = trainer.TrainConfig(opt=OptConfig(**opt), grad_compression=comp)
    model = _placed(cfg, tree, ctx)
    specs = _specs(model, ctx)
    params = convert.stacks(model)
    st = init_opt(tcfg.opt, params)
    err = compress_lib.init_error_state(params) if comp == "int8" else None
    step = trainer.make_train_step(cfg, tcfg, ctx)
    compress_lib.BLOCK = block
    try:
        for s in range(TRAIN_STEPS):
            rng = np.random.default_rng(60 + s)
            b = {"tokens": rng.integers(1, cfg.vocab_size, (4, S), np.int32),
                 "labels": rng.integers(1, cfg.vocab_size, (4, S),
                                        np.int32)}
            model, st, err, met = step(model, st, err, _local(b, rows), s)
            out[f"{tag}/{s}/loss"] = met["loss"].numpy()
            out[f"{tag}/{s}/grad_norm"] = met["grad_norm"].numpy()
    finally:
        compress_lib.BLOCK = 2048
    for k, v in convert.stacks(model).items():
        out[f"{tag}/params/{k}"] = v.numpy()
    for k, v in (err or {}).items():
        out[f"{tag}/err/{k}"] = sharding.gather_whole(v, specs[k],
                                                      ctx).numpy()


def invariant(cfg, tree, batch, ctx, rows, m, arch, out):
    """Capacity 8, aux weight 0: no token is dropped and aux does not
    enter, so the sharded loss and gradient are the local ones."""
    cfg = no_drops(cfg)
    model = _placed(cfg, tree, ctx)
    loss, grads = trainer.grads_of(model, _local(batch, rows), ctx)
    out[f"{arch}/{m}/inv/loss"] = loss.numpy()
    _save_grads(out, f"{arch}/{m}/inv/grads",
                trainer.reduce_grads(grads, ctx, _specs(model, ctx)))
    local = convert.params_from_numpy(cfg, tree, "cpu").trainable()
    loss, grads = trainer.grads_of(local, _local(batch, slice(None)))
    out[f"{arch}/{m}/inv/local_loss"] = loss.numpy()
    _save_grads(out, f"{arch}/{m}/inv/local_grads", grads)


PLACED_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "glm4-9b")
PLACED_TRAIN = {"adamw": OPT, "adafactor": dict(OPT, name="adafactor")}
ELASTIC_ARCH = "glm4-9b"


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (4, S), np.int32),
            "labels": rng.integers(1, cfg.vocab_size, (4, S), np.int32)}


def _world_sq(self, sq):
    """Planted fault: every leaf's square summed over every rank -- a
    replicated leaf's counted once a rank."""
    keys = list(sq)
    summed = sharding.all_reduce(torch.stack([sq[k] for k in keys]),
                                 self.ctx, "world")
    return dict(zip(keys, summed.unbind()))


def _out_no_reduce(self, out, w, tp):
    """Planted fault: wo's partial sums not all-reduced."""
    if tp is None or not tp.row:
        return out @ w["wo"]
    if not tp.local:
        out = sharding.model_slice(out, tp.ctx, -1)
    return out @ w["wo"]


def placed_train(cfg, tree, ctx, rows, tag, opt, out, shapes=False):
    model = convert.params_from_numpy(cfg, tree, "cpu", ctx=ctx).trainable()
    tcfg = trainer.TrainConfig(opt=OptConfig(**opt))
    st = init_opt(tcfg.opt, convert.stacks(model))
    rules = sharding.param_placements(tlm.LM(cfg, device="meta"), ctx)
    step = trainer.make_train_step(cfg, tcfg, ctx, param_shardings=rules)
    for s in range(TRAIN_STEPS):
        model, st, _, met = step(model, st, None,
                                 _local(_batch(cfg, 110 + s), rows), s)
        out[f"{tag}/{s}/loss"] = met["loss"].numpy()
        out[f"{tag}/{s}/grad_norm"] = met["grad_norm"].numpy()
    for k, v in convert.stacks(model).items():
        out[f"{tag}/params/{k}"] = v.numpy()
    if shapes:
        for k, v in ckptlib.flatten_paths(st).items():
            out[f"{tag}/opt_shapes/{k}"] = np.asarray(v.shape, np.int64)


def placed_part(ref, ctx, m, out):
    for arch in PLACED_ARCHS:
        cfg = configs.reduced(arch)
        tree = nest(ref, f"{arch}/params")
        batch = {k: ref[f"{arch}/batch/{k}"] for k in ("tokens", "labels")}
        rows = ctx.local_rows(batch["tokens"].shape[0])
        model = convert.params_from_numpy(cfg, tree, "cpu", ctx=ctx) \
            .trainable()
        for name, p in model.named_parameters():
            out[f"{arch}/{m}/shapes/{name}"] = np.asarray(p.shape, np.int64)
        loss, grads = trainer.grads_of(model, _local(batch, rows), ctx)
        specs = convert.leaf_shards(model, ctx).specs
        out[f"{arch}/{m}/loss"] = loss.numpy()
        _save_grads(out, f"{arch}/{m}/grads",
                    trainer.reduce_grads(grads, ctx, specs))
        tokens = torch.from_numpy(batch["tokens"][rows])
        logits, states = model.prefill(tokens, MAX_LEN, ctx=ctx)
        out[f"{arch}/{m}/prefill_logits"] = logits.numpy()
        for i, st in enumerate(states):
            for k, v in st.items():
                out[f"{arch}/{m}/states/{i}/{k}"] = v.numpy().copy()
        nxt = torch.from_numpy(ref[f"{arch}/next"][rows])
        logits, states = model.decode_step(nxt, states, S, ctx=ctx)
        out[f"{arch}/{m}/decode_logits"] = logits.numpy()
        for i, st in enumerate(states):
            for k, v in st.items():
                out[f"{arch}/{m}/decode_states/{i}/{k}"] = v.numpy()
        for case, opt in PLACED_TRAIN.items():
            placed_train(cfg, tree, ctx, rows, f"{arch}/{m}/train/{case}",
                         opt, out, shapes=True)
        if ctx.size > 1:
            real = sharding.LeafShards.reduce_sq
            sharding.LeafShards.reduce_sq = _world_sq
            try:
                placed_train(cfg, tree, ctx, rows,
                             f"{arch}/{m}/train/adamw_norm_fault", OPT, out)
            finally:
                sharding.LeafShards.reduce_sq = real
        if ctx.n_model > 1:
            real = attention.Attention._out
            attention.Attention._out = _out_no_reduce
            try:
                loss, grads = trainer.grads_of(model, _local(batch, rows),
                                               ctx)
            finally:
                attention.Attention._out = real
            out[f"{arch}/{m}/wo_fault/loss"] = loss.numpy()
            _save_grads(out, f"{arch}/{m}/wo_fault/grads",
                        trainer.reduce_grads(grads, ctx, specs))
        if arch == ELASTIC_ARCH and m in ("2x2", "4x1", "1x1"):
            elastic(cfg, ctx, m, out)
        if m == "1x1":
            unplaced(cfg, tree, batch, ref[f"{arch}/next"], f"{arch}/{m}",
                     out)


def unplaced(cfg, tree, batch, nxt, tag, out):
    """The same loss, gradients, prefill, decode and AdamW steps without
    ctx (at one rank the placed path must equal them bit for bit)."""
    model = convert.params_from_numpy(cfg, tree, "cpu").trainable()
    loss, grads = trainer.grads_of(model, _local(batch, slice(None)))
    out[f"{tag}/unplaced/loss"] = loss.numpy()
    _save_grads(out, f"{tag}/unplaced/grads", grads)
    logits, states = model.prefill(torch.from_numpy(batch["tokens"]),
                                   MAX_LEN)
    out[f"{tag}/unplaced/prefill_logits"] = logits.numpy()
    for i, st in enumerate(states):
        for k, v in st.items():
            out[f"{tag}/unplaced/states/{i}/{k}"] = v.numpy().copy()
    logits, states = model.decode_step(torch.from_numpy(nxt), states, S)
    out[f"{tag}/unplaced/decode_logits"] = logits.numpy()
    tcfg = trainer.TrainConfig(opt=OptConfig(**OPT))
    st = init_opt(tcfg.opt, convert.stacks(model))
    step = trainer.make_train_step(cfg, tcfg)
    for s in range(TRAIN_STEPS):
        model, st, _, met = step(model, st, None,
                                 _local(_batch(cfg, 110 + s), slice(None)), s)
        out[f"{tag}/unplaced/train/{s}/loss"] = met["loss"].numpy()
        out[f"{tag}/unplaced/train/{s}/grad_norm"] = met["grad_norm"].numpy()
    for k, v in convert.stacks(model).items():
        out[f"{tag}/unplaced/train/params/{k}"] = v.numpy()


def elastic(cfg, ctx, m, out):
    """2x2: two Trainer steps writing whole leaves, then the third step;
    4x1 and 1x1: the step-1 checkpoint restored on this mesh, then the
    third step."""
    import os
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(OUT_DIR)),
                            "elastic_ckpt")
    tcfg = trainer.TrainConfig(steps=2, ckpt_every=1, ckpt_dir=ckpt_dir,
                               opt=OptConfig(**OPT))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=4, mean_doc_len=8))
    tag = f"elastic/{m}"
    if m == "2x2":
        tr = trainer.Trainer(cfg, tcfg, data, ctx=ctx, device="cpu")
        model, st = tr.run()
        out[f"{tag}/losses"] = np.asarray(
            [h["loss"] for h in tr.history if "loss" in h])
    else:
        dist.barrier()
        model = tlm.init(cfg, torch.Generator().manual_seed(99), "cpu",
                         ctx).trainable()
        st = init_opt(tcfg.opt, convert.stacks(model))
        tree = (convert.stacks(model), st, None)
        specs = trainer._ckpt_specs(tree, convert.leaf_shards(model, ctx))
        step, (params, st, _), _ = ckptlib.restore_with_placements(
            ckpt_dir, tree, specs, ctx, "cpu", step=1)
        for path, ps in convert.leaf_groups(model).items():
            convert.write_back(path, ps, params[path])
        out[f"{tag}/restored_step"] = np.asarray(step)
        for k, v in ckptlib.flatten_paths((params, st)).items():
            out[f"{tag}/restored/{k}"] = v.numpy()
    step_fn = trainer.make_train_step(cfg, tcfg, ctx)
    batch = {k: torch.from_numpy(v[ctx.local_rows(4)])
             for k, v in data.batch_at(2).items()}
    _, _, _, met = step_fn(model, st, None, batch, 2)
    out[f"{tag}/step2_loss"] = met["loss"].numpy()


def main():
    part, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    init_file, ref_npz, out_dir = sys.argv[4], sys.argv[5], sys.argv[6]
    meshes = sys.argv[7:]
    global OUT_DIR
    OUT_DIR = out_dir
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    ref = np.load(ref_npz)
    out = {}
    for m in meshes:
        nd, nm = (int(v) for v in m.split("x"))
        ctx = make_ctx(make_test_mesh(nd, nm, device_type="cpu"))
        out[f"{m}/model_rank"] = np.asarray(ctx.model_rank)
        out[f"{m}/data_rank"] = np.asarray(ctx.data_rank)
        sharding.reset_collectives()
        {"moe": moe_part, "lm": lm_part, "placed": placed_part}[part](
            ref, ctx, m, out)
        for op, c in sharding.COLLECTIVES.items():
            out[f"{m}/collectives/{op}"] = np.asarray([c["count"],
                                                       c["bytes"]])
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    print("TORCH_SHARDED_OK")


if __name__ == "__main__":
    main()
