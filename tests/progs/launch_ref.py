"""Subprocess program: the reference's launch tooling on fake XLA CPU
devices, the side tests/test_torch_sharding.py and
tests/test_torch_launch.py hold the port's to.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python launch_ref.py placements OUT_JSON
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python launch_ref.py flops OUT_JSON
    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python launch_ref.py full OUT_JSON [DRYRUN_DIR]

placements: for each of the ten published configs and both production
mesh shapes (16x16, 2x16x16), ``param_shardings`` of ``jax.eval_shape(
lm.init)`` as {"/"-joined leaf path: spec list}, and ``state_shardings``
of decode_32k's states (B 128, S 32768).

flops: ``analytic_flops`` of ``dryrun.build_train`` / ``build_prefill``
/ ``build_decode`` for the reduced smollm-135m, olmoe-1b-7b and
llama4-maverick-400b-a17b (its shared expert) at the
train_4k / prefill_32k / decode_32k shapes on a (2, 4) mesh with Auto
axes (the reference's Explicit-axis meshes fail under
``with_sharding_constraint``).

full: the same for every LM cell of the reference's ``all_cells()`` at
its published config on both production meshes (Auto axes), and with a
dry-run directory of the port the ratio of each cell's
``flops_analytic_global`` to it."""
import json
import sys

import jax


def spec_list(sharding):
    return [list(a) if isinstance(a, tuple) else a for a in sharding.spec]


def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = spec_list(leaf)
    return out


def placements():
    from repro import configs
    from repro.configs.base import DECODE_32K
    from repro.launch import specs
    from repro.launch.mesh import make_ctx, make_production_mesh
    out = {}
    for multi in (False, True):
        ctx = make_ctx(make_production_mesh(multi_pod=multi))
        for arch in configs.ARCH_NAMES:
            cfg = configs.get(arch)
            _, sh = specs.params_specs(cfg, ctx)
            key = f"{arch}/{'multi' if multi else 'single'}"
            out[f"{key}/params"] = flat(sh)
            _, (_, st_sh, _) = specs.decode_specs(
                cfg, DECODE_32K.global_batch, DECODE_32K.seq_len, ctx)
            out[f"{key}/states"] = flat(st_sh)
    return out


def auto_mesh(shape, names):
    """A mesh of Auto axes on the first devices (dryrun is imported after
    the device count is fixed)."""
    from repro.core.compat import make_mesh
    n = 1
    for d in shape:
        n *= d
    return make_mesh(shape, names,
                     axis_types=(jax.sharding.AxisType.Auto,) * len(shape),
                     devices=jax.devices()[:n])


def cell_flops(cfg, ctx, mesh, shape):
    """The reference's analytic_flops of a cell's build_* function."""
    from repro.launch import dryrun
    from repro.launch.flops import analytic_flops
    if shape.kind == "train":
        opt = ("adafactor" if dryrun.lm.count_params(cfg)
               > dryrun.BIG_PARAM_THRESHOLD else "adamw")
        fn, args = dryrun.build_train(cfg, ctx, shape, opt)
    elif shape.kind == "prefill":
        fn, args = dryrun.build_prefill(cfg, ctx, shape)
    else:
        fn, args = dryrun.build_decode(cfg, ctx, shape)
    return float(analytic_flops(fn, *args, mesh_size=mesh.size))


def flops():
    jax.devices()      # the device count is fixed before dryrun's import
    from repro import configs
    from repro.configs.base import shapes_for
    from repro.launch.mesh import make_ctx
    mesh = auto_mesh((2, 4), ("data", "model"))
    ctx = make_ctx(mesh)
    out = {}
    for arch in ("smollm-135m", "olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        cfg = configs.reduced(arch)
        for shape in shapes_for(cfg):
            out[f"{arch}/{shape.name}"] = cell_flops(cfg, ctx, mesh, shape)
    return out


def full():
    """Every LM cell of the reference's all_cells() at its published
    config on both production meshes (512 devices), keyed as the dry
    run's files: <arch>__<shape>__<single|multi>."""
    jax.devices()
    from repro import configs
    from repro.configs.base import shapes_for
    from repro.launch.mesh import make_ctx
    out = {}
    for multi in (False, True):
        shape = (2, 16, 16) if multi else (16, 16)
        names = ("pod", "data", "model") if multi else ("data", "model")
        mesh = auto_mesh(shape, names)
        ctx = make_ctx(mesh)
        for arch in configs.ARCH_NAMES:
            cfg = configs.get(arch)
            for s in shapes_for(cfg):
                key = f"{arch}__{s.name}__{'multi' if multi else 'single'}"
                out[key] = cell_flops(cfg, ctx, mesh, s)
    return out


def compare(path, dryrun_dir):
    """Each dry-run cell's flops_analytic_global over the reference's."""
    ref = json.loads(open(path).read())
    worst = 0.0
    for key, want in sorted(ref.items()):
        with open(f"{dryrun_dir}/{key}.json") as f:
            got = json.load(f)["flops_analytic_global"]
        worst = max(worst, abs(got / want - 1))
        print(f"{key}: port {got:.6e} reference {want:.6e} "
              f"ratio {got / want:.9f}")
    print(f"{len(ref)} cells, worst |port / reference - 1| = {worst:.3e}")


def main():
    """placements | flops | full OUT_JSON [DRYRUN_DIR]: with DRYRUN_DIR
    (python -m repro_torch.launch.dryrun --all --mesh both --out DIR),
    print each cell's port / reference FLOP ratio."""
    mode, path = sys.argv[1], sys.argv[2]
    out = {"placements": placements, "flops": flops, "full": full}[mode]()
    with open(path, "w") as f:
        json.dump(out, f)
    print("LAUNCH_REF_OK", len(out))
    if len(sys.argv) > 3:
        compare(path, sys.argv[3])


if __name__ == "__main__":
    main()
