"""Subprocess program: the reference's sharded LM paths on fake XLA CPU
devices, the side the port's sharded paths are held to.  Run by
tests/test_torch_moe_sharded.py and tests/test_torch_lm_sharded.py:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python sharded_ref.py {moe|lm|placed[=ARCH]} OUT_NPZ MESH [MESH ...]

MESH is "<n_data>x<n_model>".  Meshes are built with Auto axes through
``repro.core.compat.make_mesh(..., axis_types=...)``: the reference's own
``make_test_mesh`` builds Explicit axes, on which ``with_sharding_
constraint`` (models/sharding.py ``constrain``) fails under jit.

moe: for reduced olmoe-1b-7b and llama4-maverick-400b-a17b (f32), the
MoE layer's weights, an input x (4, 16, d), and per mesh
``moe_apply(ctx)``'s output and aux.

lm: for the same two configs, the weights, a batch (4, 16), and per
mesh ``loss_fn(ctx)`` and every gradient, ``prefill(ctx)`` logits and
states (max_len 24), one ``decode_step(ctx)``; at meshes 1x4 and 2x2
``loss_fn(ctx)`` and every gradient on a batch (4, 15), whose sequence
the model axis does not split (the MoE's non-sequence-parallel branch);
for olmoe three jitted ``make_train_step(ctx)`` steps (loss, grad norm,
parameters, error-feedback residuals) of each train case of its mesh
(:func:`train_cases`).

placed: for reduced olmoe-1b-7b, llama4-maverick-400b-a17b and glm4-9b
(f32; or ARCH alone) the weights placed by ``jax.device_put(params,
param_shardings(...))``, a batch (4, 16), and per mesh ``loss_fn(ctx)``
and every gradient, ``prefill(ctx)`` logits and states (max_len 24), one
``decode_step(ctx)``, and three jitted ``make_train_step(ctx,
param_shardings=)`` steps of AdamW and of Adafactor (loss, grad norm,
parameters)."""
import sys

import numpy as np
import jax
import jax.numpy as jnp

from repro import configs
from repro.core.compat import make_mesh
from repro.launch.specs import opt_specs
from repro.models import lm, moe
from repro.models.sharding import ShardCtx, param_shardings
from repro.optim import OptConfig, init_opt
from repro.train import TrainConfig, make_train_step
from repro.train import compress as compress_lib

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
B, S, MAX_LEN = 4, 16, 24
S_NOSP, NOSP_MESHES = 15, ("1x4", "2x2")
OPT = dict(name="adamw", peak_lr=1e-2, warmup_steps=1, decay_steps=10)
TRAIN_STEPS = 3
# case -> (optimizer, grad_compression, EF-int8 block); the 1536-element
# blocks do not align with the reduced olmoe's experts (16384 and 8192
# elements each)
TRAIN = {"adamw": (OPT, "none", 2048),
         "adafactor": (dict(OPT, name="adafactor"), "none", 2048),
         "int8": (OPT, "int8", 2048),
         "int8_unaligned": (OPT, "int8", 1536)}


def train_cases(mesh):
    """AdamW at every mesh; Adafactor and EF-int8 where the model axis
    splits the experts and the data axis is 1 or 2 (1x4, 2x2)."""
    return list(TRAIN) if mesh in NOSP_MESHES else ["adamw"]


def flat(tree, prefix):
    """{prefix/path: numpy leaf} of a nested dict / list tree."""
    out = {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: np.asarray(tree, np.float32)
                if np.asarray(tree).dtype.kind == "f" else np.asarray(tree)}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def ctx_of(mesh_name):
    nd, nm = (int(v) for v in mesh_name.split("x"))
    mesh = make_mesh((nd, nm), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:nd * nm])
    return ShardCtx(mesh=mesh, dp_axes=("data",))


def batch_of(cfg, seed, seq=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, seq), np.int32),
            "labels": rng.integers(1, cfg.vocab_size, (B, seq), np.int32)}


def moe_part(meshes, out):
    for a, arch in enumerate(ARCHS):
        cfg = configs.reduced(arch)
        p = moe.moe_init(jax.random.key(10 + a), cfg, jnp.float32)
        x = np.random.default_rng(20 + a).normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
        out.update(flat(p, f"{arch}/p"))
        out[f"{arch}/x"] = x
        for m in meshes:
            ctx = ctx_of(m)
            y, aux = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, ctx))(
                p, jnp.asarray(x))
            out[f"{arch}/{m}/out"] = np.asarray(y)
            out[f"{arch}/{m}/aux"] = np.asarray(aux)


def lm_part(meshes, out):
    for a, arch in enumerate(ARCHS):
        cfg = configs.reduced(arch)
        params = lm.init(cfg, jax.random.key(30 + a))
        batch = batch_of(cfg, 40 + a)
        nxt = np.random.default_rng(50 + a).integers(
            1, cfg.vocab_size, (B, 1), np.int32)
        out.update(flat(params, f"{arch}/params"))
        nosp = batch_of(cfg, 70 + a, S_NOSP)
        out.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
        out.update({f"{arch}/nosp_batch/{k}": v for k, v in nosp.items()})
        out[f"{arch}/next"] = nxt
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for m in meshes:
            ctx = ctx_of(m)
            loss_grad = jax.jit(jax.value_and_grad(
                lambda p, b: lm.loss_fn(p, cfg, b, ctx)))
            loss, grads = loss_grad(params, jb)
            out[f"{arch}/{m}/loss"] = np.asarray(loss)
            out.update(flat(grads, f"{arch}/{m}/grads"))
            if m in NOSP_MESHES:
                loss, grads = loss_grad(params, {
                    k: jnp.asarray(v) for k, v in nosp.items()})
                out[f"{arch}/{m}/nosp/loss"] = np.asarray(loss)
                out.update(flat(grads, f"{arch}/{m}/nosp/grads"))
            logits, states = jax.jit(
                lambda p, b: lm.prefill(p, cfg, b, MAX_LEN, ctx))(
                params, {"tokens": jb["tokens"]})
            out[f"{arch}/{m}/prefill_logits"] = np.asarray(logits)
            out.update(flat(states, f"{arch}/{m}/states"))
            logits, states = jax.jit(
                lambda p, b, st: lm.decode_step(p, cfg, b, st, S, ctx))(
                params, {"tokens": jnp.asarray(nxt)}, states)
            out[f"{arch}/{m}/decode_logits"] = np.asarray(logits)
            out.update(flat(states, f"{arch}/{m}/decode_states"))
            if arch != ARCHS[0]:
                continue
            for case in train_cases(m):
                train(cfg, params, ctx, f"{arch}/{m}/train/{case}",
                      *TRAIN[case], out)


def train(cfg, params, ctx, tag, opt, comp, block, out):
    tcfg = TrainConfig(opt=OptConfig(**opt), grad_compression=comp)
    compress_lib.BLOCK = block
    try:
        step = jax.jit(make_train_step(cfg, tcfg, ctx))
        p, st = params, init_opt(tcfg.opt, params)
        err = compress_lib.init_error_state(params) if comp == "int8" \
            else None
        for s in range(TRAIN_STEPS):
            b = {k: jnp.asarray(v) for k, v in batch_of(cfg, 60 + s).items()}
            p, st, err, met = step(p, st, err, b, jnp.int32(s))
            out[f"{tag}/{s}/loss"] = np.asarray(met["loss"])
            out[f"{tag}/{s}/grad_norm"] = np.asarray(met["grad_norm"])
    finally:
        compress_lib.BLOCK = 2048
    out.update(flat(p, f"{tag}/params"))
    if err is not None:
        out.update(flat(err, f"{tag}/err"))


PLACED_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "glm4-9b")
PLACED_TRAIN = {"adamw": OPT, "adafactor": dict(OPT, name="adafactor")}


def placed_part(meshes, out, only=None):
    for a, arch in enumerate(PLACED_ARCHS):
        if only not in (None, arch):
            continue
        cfg = configs.reduced(arch)
        params = lm.init(cfg, jax.random.key(80 + a))
        batch = batch_of(cfg, 90 + a)
        nxt = np.random.default_rng(100 + a).integers(
            1, cfg.vocab_size, (B, 1), np.int32)
        out.update(flat(params, f"{arch}/params"))
        out.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
        out[f"{arch}/next"] = nxt
        for m in meshes:
            ctx = ctx_of(m)
            p_sh = param_shardings(jax.eval_shape(lambda: params), ctx)
            placed = jax.device_put(params, p_sh)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: lm.loss_fn(p, cfg, b, ctx)))(placed, jb)
            out[f"{arch}/{m}/loss"] = np.asarray(loss)
            out.update(flat(grads, f"{arch}/{m}/grads"))
            logits, states = jax.jit(
                lambda p, b: lm.prefill(p, cfg, b, MAX_LEN, ctx))(
                placed, {"tokens": jb["tokens"]})
            out[f"{arch}/{m}/prefill_logits"] = np.asarray(logits)
            out.update(flat(states, f"{arch}/{m}/states"))
            logits, states = jax.jit(
                lambda p, b, st: lm.decode_step(p, cfg, b, st, S, ctx))(
                placed, {"tokens": jnp.asarray(nxt)}, states)
            out[f"{arch}/{m}/decode_logits"] = np.asarray(logits)
            out.update(flat(states, f"{arch}/{m}/decode_states"))
            for case, opt in PLACED_TRAIN.items():
                tcfg = TrainConfig(opt=OptConfig(**opt))
                # the dry run's layout (launch/dryrun.py build_train): the
                # optimizer state under the same rules, outputs laid out
                # as the inputs (one compile, not one a layout)
                _, o_sh = opt_specs(cfg, ctx, tcfg.opt,
                                    jax.eval_shape(lambda: params))
                p = placed
                st = jax.device_put(init_opt(tcfg.opt, placed), o_sh)
                step = jax.jit(make_train_step(cfg, tcfg, ctx,
                                               param_shardings=p_sh),
                               in_shardings=(p_sh, o_sh, None, None, None),
                               out_shardings=(p_sh, o_sh, None, None))
                tag = f"{arch}/{m}/train/{case}"
                for s in range(TRAIN_STEPS):
                    b = {k: jnp.asarray(v)
                         for k, v in batch_of(cfg, 110 + s).items()}
                    p, st, _, met = step(p, st, None, b, jnp.int32(s))
                    out[f"{tag}/{s}/loss"] = np.asarray(met["loss"])
                    out[f"{tag}/{s}/grad_norm"] = np.asarray(
                        met["grad_norm"])
                out.update(flat(p, f"{tag}/params"))


def main():
    part, path, meshes = sys.argv[1], sys.argv[2], sys.argv[3:]
    out = {}
    part, _, arch = part.partition("=")
    if part == "placed":
        placed_part(meshes, out, arch or None)
    else:
        {"moe": moe_part, "lm": lm_part}[part](meshes, out)
    np.savez(path, **out)
    print("SHARDED_REF_OK", len(out))


if __name__ == "__main__":
    main()
