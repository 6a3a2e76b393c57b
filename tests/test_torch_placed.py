"""The port's placed sharded LM path (repro_torch.models.sharding.place_:
each parameter, its gradient and its optimizer state held as the rank's
block under the reference's FSDP / tensor-parallel rules) against the
reference's run with ``jax.device_put(params, param_shardings(...))`` and
``make_train_step(..., param_shardings=)`` on 4 fake XLA CPU devices
(Auto axes), for reduced olmoe-1b-7b, llama4-maverick-400b-a17b and
glm4-9b (GQA: at n_model = 4 the rules' columns cut a KV head, so every
rank computes every head and holds its cache slots) in float32, at meshes
1x4, 2x2, 4x1 (4 gloo ranks), 1x2, 2x1 (2 ranks) and 1x1.

The reference runs once per architecture, the three in parallel
(tests/progs/sharded_ref.py ``placed=ARCH``); the port under gloo, one
process a rank (tests/progs/torch_sharded.py ``placed``).  Per arch and
mesh: each parameter's shape against ``param_placements`` (and the
rank's bytes against ``placement_bytes``); the loss and the rank's block
of every gradient leaf; ``prefill`` / ``decode_step`` logits (the rank's
rows) and states (the rank's rows and heads or slots, by
``state_shardings``); three AdamW and three Adafactor steps (loss, grad
norm, the rank's block of every parameter, the optimizer state's
shapes).  At one rank the placed path equals the unplaced one bit for
bit.  Planted faults must fail: every leaf's square summed over every
rank in the grad norm, and attention's row-split wo without its
all-reduce.  Elastic checkpoint: glm4-9b trained two steps at 2x2 writes
whole leaves; restored at 4x1 and 1x1 each rank holds its block of them
(bit for bit), the next step's loss agrees with the 2x2 run's, and the
reference's ``repro.ckpt.load_checkpoint`` reads the checkpoint.

Tolerances are the sharded path's (tests/test_torch_lm_sharded.py):
loss rtol 1e-5; gradients, logits and states 1e-4 of max|reference|;
per step loss and grad norm rtol 1e-5; after the last step every
parameter leaf 1e-4 in relative l2, for AdamW and Adafactor at every
mesh, but for the two AdamW leaves of :data:`BY_UPDATE`, where a
single element's normalised update magnifies the packages' rounding.
At 1x1 one element of olmoe's embedding has a step-1 gradient at the
noise floor (-7.9e-8 in the reference, -4.6e-8 in the port, gradients
agreeing within 1.7e-6 of max) against AdamW's eps of 1e-8: its update
differs by a third of a full one (3.2e-4 rel l2 on the leaf).  In
llama4's tail/0/norm1/scale (zero at the start, so its value is its
updates) element 38's gradient changes sign between steps 0 and 1
(-1.12e-4, +1.06e-4), AdamW's first moment keeps 5 % of either term,
and the element ends 2.0e-5 apart on 1.6e-3 (2.0e-4 rel l2 on the
leaf).  Those two leaves are held by their update (after - before) at
2e-2 in relative l2, the limit tests/test_torch_lm_sharded.py sets where
single elements take a full update in one package and not in the other
(its EF-int8 cases)."""
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_moe_sharded import (PROGS, MESHES, _env, rel,  # noqa: E402
                                    run_port, world_of)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import convert, lm as tlm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "glm4-9b")
LOSS_RTOL, GRAD_TOL, VALUE_TOL, L2_TOL = 1e-5, 1e-4, 1e-4, 1e-4
UPDATE_TOL = 2e-2
# (arch, mesh) -> AdamW leaves held by their update (see the docstring)
BY_UPDATE = {("olmoe-1b-7b", "1x1"): {"embed"},
               ("llama4-maverick-400b-a17b", "1x1"): {"tail/0/norm1/scale"}}
CASES = ("adamw", "adafactor")
B, MAX_LEN, STEPS = 4, 24, 3
# (pattern length, whole groups) of the reduced configs
LAYOUT = {"olmoe-1b-7b": (1, 3), "llama4-maverick-400b-a17b": (2, 1),
          "glm4-9b": (1, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("placed")
    env = _env(d, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {arch: subprocess.Popen(
        [sys.executable, str(PROGS / "sharded_ref.py"), f"placed={arch}",
         str(d / f"ref_{arch}.npz"), *MESHES], cwd=d, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch in ARCHS}
    for arch, p in procs.items():
        log = p.communicate(timeout=900)[0]
        assert p.returncode == 0, log[-3000:]
    ref = {}
    for arch in ARCHS:
        ref.update(np.load(d / f"ref_{arch}.npz"))
    np.savez(d / "ref_placed.npz", **ref)
    return ref, run_port("placed", d / "ref_placed.npz", d), d


def _ctx(mesh):
    nd, nm = (int(v) for v in mesh.split("x"))
    return tsh.shape_ctx((nd, nm), ("data", "model"))


def _placed_meta(arch, mesh):
    """The meta model placed on a shape-only ctx of ``mesh``, its rules'
    placements and its leaves' placements."""
    cfg = tconfigs.reduced(arch)
    ctx = _ctx(mesh)
    model = tlm.LM(cfg, device="meta")
    rules = tsh.param_placements(model, ctx)
    tsh.place_(model, ctx)
    return ctx, rules, convert.leaf_shards(model, ctx).specs


def _block(a, spec, o, mesh, ctx):
    """The rank's block of array ``a`` under ``spec``."""
    dr, mr = int(o[f"{mesh}/data_rank"]), int(o[f"{mesh}/model_rank"])
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        r, n = (mr, ctx.n_model) if ax == "model" else (dr, ctx.n_data)
        s = a.shape[dim] // n
        a = np.take(a, range(r * s, (r + 1) * s), axis=dim)
    return a


def _leaves(o, prefix):
    return {k[len(prefix):]: v for k, v in o.items()
            if k.startswith(prefix)}


def _l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_shapes_follow_the_rules(runs, arch, mesh):
    _, port, _ = runs
    ctx, rules, _ = _placed_meta(arch, mesh)
    full = tlm.LM(tconfigs.reduced(arch), device="meta")
    params = dict(full.named_parameters())
    want_bytes = tspecs.placement_bytes(params, rules, ctx)
    for o in port[world_of(mesh)[0]]:
        shapes = _leaves(o, f"{arch}/{mesh}/shapes/")
        assert set(shapes) == set(params)
        got_bytes = 0
        for name, shp in shapes.items():
            want = tspecs.local_shape(params[name].shape, rules[name], ctx)
            assert tuple(shp) == want, (name, tuple(shp), want)
            got_bytes += int(np.prod(shp)) * params[name].element_size()
        assert got_bytes == want_bytes


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_blocks_match_reference(runs, arch, mesh):
    ref, port, _ = runs
    ctx, _, specs = _placed_meta(arch, mesh)
    want_loss = float(ref[f"{arch}/{mesh}/loss"])
    for o in port[world_of(mesh)[0]]:
        assert float(o[f"{arch}/{mesh}/loss"]) == pytest.approx(
            want_loss, rel=LOSS_RTOL)
        grads = _leaves(o, f"{arch}/{mesh}/grads/")
        assert set(grads) == set(_leaves(ref, f"{arch}/{mesh}/grads/"))
        for path, g in grads.items():
            want = _block(ref[f"{arch}/{mesh}/grads/{path}"], specs[path],
                          o, mesh, ctx)
            assert g.shape == want.shape, path
            assert rel(g, want) <= GRAD_TOL, (path, rel(g, want))


def _state(ref, arch, mesh, tag, i, leaf):
    P, G = LAYOUT[arch]
    if i < G * P:
        return ref[f"{arch}/{mesh}/{tag}/groups/{i % P}/{leaf}"][i // P]
    return ref[f"{arch}/{mesh}/{tag}/tail/{i - G * P}/{leaf}"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(runs, arch, mesh):
    ref, port, _ = runs
    cfg = tconfigs.reduced(arch)
    ctx = _ctx(mesh)
    st_sh = tspecs.state_shardings(
        cfg, tlm.state_init(cfg, B, MAX_LEN, device="meta"), ctx, B)
    for o in port[world_of(mesh)[0]]:
        for tag in ("prefill", "decode"):
            got = o[f"{arch}/{mesh}/{tag}_logits"]
            want = _block(ref[f"{arch}/{mesh}/{tag}_logits"], (ctx.dp,),
                          o, mesh, ctx)
            assert rel(got, want) < VALUE_TOL, tag
        for tag in ("states", "decode_states"):
            st = _leaves(o, f"{arch}/{mesh}/{tag}/")
            assert len(st) == 2 * cfg.num_layers, tag
            for key, got in st.items():
                i, leaf = key.split("/")
                want = _block(_state(ref, arch, mesh, tag, int(i), leaf),
                              st_sh[int(i)][leaf], o, mesh, ctx)
                assert got.shape == want.shape, (tag, key)
                assert rel(got, want) < VALUE_TOL, (tag, key)


def _opt_shape(key, specs, shapes, ctx):
    """The rank's shape of optimizer-state leaf ``key``."""
    kind, _, path = key.partition("/")
    if kind == "step":
        return ()
    stat = None
    if kind == "stats":
        path, _, stat = path.rpartition("/")
    spec, shape = specs[path], shapes[path]
    local = tspecs.local_shape(shape, spec, ctx)
    if stat == "vr":
        return local[:-1]
    if stat == "vc":
        return local[:-2] + local[-1:]
    return local


def train_readings(ref, outs, arch, mesh, case, tag, ctx, specs,
                   by_update=()):
    """The worst reading over the ranks: per step loss and grad norm
    (relative); after the last step each parameter leaf's rel l2
    ("params", "worst" names its leaf), or for the leaves of
    ``by_update`` their update's ("update")."""
    want_tag = f"{arch}/{mesh}/train/{case}"
    r = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "update": 0.0,
         "worst": None}
    for o in outs:
        got_tag = f"{arch}/{mesh}/train/{tag}"
        for s in range(STEPS):
            for key in ("loss", "grad_norm"):
                want = float(ref[f"{want_tag}/{s}/{key}"])
                got = float(o[f"{got_tag}/{s}/{key}"])
                r[key] = max(r[key], abs(got / want - 1))
        params = _leaves(o, f"{got_tag}/params/")
        assert set(params) == set(_leaves(ref, f"{want_tag}/params/"))
        for path, p in params.items():
            want = _block(ref[f"{want_tag}/params/{path}"], specs[path], o,
                          mesh, ctx)
            p0 = _block(ref[f"{arch}/params/{path}"], specs[path], o, mesh,
                        ctx)
            if path in by_update:
                r["update"] = max(r["update"], _l2(p - p0, want - p0))
            elif _l2(p, want) > r["params"]:
                r["params"], r["worst"] = _l2(p, want), path
    return r


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(runs, arch, mesh, case):
    ref, port, _ = runs
    ctx, _, specs = _placed_meta(arch, mesh)
    outs = port[world_of(mesh)[0]]
    by_update = BY_UPDATE.get((arch, mesh), ()) if case == "adamw" else ()
    r = train_readings(ref, outs, arch, mesh, case, case, ctx, specs,
                       by_update)
    assert r["loss"] <= LOSS_RTOL and r["grad_norm"] <= LOSS_RTOL, r
    assert r["params"] <= L2_TOL and r["update"] <= UPDATE_TOL, \
        f"worst leaf {r['worst']}: {r}"
    shapes = {k: tuple(v.shape) for k, v in
              _leaves(ref, f"{arch}/{mesh}/train/{case}/params/").items()}
    for o in outs:
        got = _leaves(o, f"{arch}/{mesh}/train/{case}/opt_shapes/")
        assert got
        for key, shp in got.items():
            assert tuple(shp) == _opt_shape(key, specs, shapes, ctx), key


@pytest.mark.parametrize("mesh", [m for m in MESHES if world_of(m)[0] > 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_planted_grad_norm_fault_is_rejected(runs, arch, mesh):
    """Every leaf's square summed over every rank: a replicated leaf (the
    norms, at least) counted once a rank moves the grad norm."""
    ref, port, _ = runs
    ctx, _, specs = _placed_meta(arch, mesh)
    r = train_readings(ref, port[world_of(mesh)[0]], arch, mesh, "adamw",
                       "adamw_norm_fault", ctx, specs)
    assert r["grad_norm"] > 10 * LOSS_RTOL, r


@pytest.mark.parametrize("mesh", [m for m in MESHES if world_of(m)[2] > 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_planted_wo_fault_is_rejected(runs, arch, mesh):
    """Attention's row-split wo without the all-reduce of its partial
    sums computes another function."""
    ref, port, _ = runs
    ctx, _, specs = _placed_meta(arch, mesh)
    worst = 0.0
    for o in port[world_of(mesh)[0]]:
        worst = max(worst, abs(float(o[f"{arch}/{mesh}/wo_fault/loss"])
                               / float(ref[f"{arch}/{mesh}/loss"]) - 1))
        for path, g in _leaves(o, f"{arch}/{mesh}/wo_fault/grads/").items():
            want = _block(ref[f"{arch}/{mesh}/grads/{path}"], specs[path],
                          o, mesh, ctx)
            worst = max(worst, rel(g, want))
    assert worst > 100 * GRAD_TOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_equals_unplaced_bit_for_bit(runs, arch):
    _, port, _ = runs
    (o,) = port[1]
    tag = f"{arch}/1x1"
    assert np.array_equal(o[f"{tag}/loss"], o[f"{tag}/unplaced/loss"])
    for key in ("prefill_logits", "decode_logits"):
        assert np.array_equal(o[f"{tag}/{key}"], o[f"{tag}/unplaced/{key}"])
    for part in ("grads", "states", "train/adamw/params"):
        got = _leaves(o, f"{tag}/{part}/")
        want = _leaves(o, f"{tag}/unplaced/{part.replace('/adamw', '')}/")
        assert got and set(got) == set(want), part
        for k in got:
            assert np.array_equal(got[k], want[k]), (part, k)
    for s in range(STEPS):
        for key in ("loss", "grad_norm"):
            assert np.array_equal(o[f"{tag}/train/adamw/{s}/{key}"],
                                  o[f"{tag}/unplaced/train/{s}/{key}"])


def test_elastic_restore_across_meshes(runs):
    """Written at 2x2 (whole leaves), restored at 4x1 and 1x1: each rank
    holds its block of the checkpoint bit for bit, the next step's loss
    agrees with the 2x2 run's, and the reference reads the checkpoint."""
    import jax
    from repro import configs as jconfigs
    from repro.ckpt import load_checkpoint
    from repro.models import lm as jlm
    from repro.optim import OptConfig as JOpt, init_opt as jinit
    _, port, d = runs
    arch = ARCHS[2]
    ckpt_dir = str(d / "elastic_ckpt")
    jcfg = jconfigs.reduced(arch)
    params = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.key(0)))
    tmpl = (params, jax.eval_shape(lambda p: jinit(JOpt(), p), params),
            None)
    step, tree, _ = load_checkpoint(ckpt_dir, tmpl, step=1)
    assert step == 1
    whole = _flat_ref(tree)
    base = [o for o in port[4]]
    want = float(base[0]["elastic/2x2/step2_loss"])
    assert len(base[0]["elastic/2x2/losses"]) == 2
    for mesh in ("4x1", "1x1"):
        ctx, _, specs = _placed_meta(arch, mesh)
        model = tlm.LM(tconfigs.reduced(arch), device="meta")
        tsh.place_(model, ctx)
        for o in port[world_of(mesh)[0]]:
            assert int(o[f"elastic/{mesh}/restored_step"]) == 1
            got = _leaves(o, f"elastic/{mesh}/restored/")
            assert got
            for key, blk in got.items():
                part, _, rest = key.partition("/")
                path = rest.partition("/")[2] if part == "1" else rest
                spec = () if rest == "step" else specs[path]
                ref_key = f"{part}/{rest}"
                assert np.array_equal(blk, _block(whole[ref_key], spec, o,
                                                  mesh, ctx)), key
            assert float(o[f"elastic/{mesh}/step2_loss"]) == pytest.approx(
                want, rel=LOSS_RTOL)


def _flat_ref(tree):
    """{"/"-joined path: numpy leaf} of the reference's loaded tree."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = np.asarray(leaf)
    return out
