"""The port's sharded LM path (``ctx`` through repro_torch.models.lm and
repro_torch.train.trainer, the model placed by the reference's rules:
``convert.params_from_numpy(..., ctx=)``) against the reference's sharded
paths on 4 fake XLA CPU devices, reduced olmoe-1b-7b and
llama4-maverick-400b-a17b (for its shared expert) in float32, at meshes
1x4, 2x2, 4x1 (4 gloo ranks), 1x2, 2x1 (2 ranks) and 1x1; the harness is
tests/test_torch_moe_sharded.py's.

Per arch and mesh: ``loss_fn(ctx)`` (the global loss on every rank) and
every gradient leaf once :func:`repro_torch.train.trainer.reduce_grads`
has summed the ranks' shares (held to the rank's block of the
reference's leaf), ``prefill(ctx)`` logits and states, one
``decode_step(ctx)``.  At 1x4 and 2x2 also the loss and gradients of a
(4, 15) batch: the model axis does not split 15, so every model rank
routes every token (the MoE's non-sequence-parallel branch), and a
planted fault that drops that branch's 1 / n_model cotangent factor must
fail.  For olmoe three ``make_train_step(ctx)`` steps (loss, grad norm,
the rank's block of every parameter, the error-feedback residuals
gathered whole) of AdamW at every mesh,
and at 1x4 and 2x2 of Adafactor, AdamW with EF-int8, and EF-int8 on
1536-element blocks, which straddle the ranks' experts; planted faults
(Adafactor's update RMS over the rank's slice only, EF-int8 blocked
over the rank's shard) must fail.  With capacity 8.0 and aux weight 0,
the port's sharded loss and gradients equal its local ones.

Tolerances are the local paths' (tests/test_torch_train_archs.py,
tests/test_torch_lm_archs.py, tests/test_torch_train.py): loss rtol
1e-5; gradients 1e-4 of max|reference leaf|; logits and states 1e-4 of
max|reference|; per training step loss rtol 1e-5 and grad norm rtol
1e-5 (1e-4 with EF-int8), the parameters after the last step 1e-4 in
relative l2; with EF-int8 each leaf's update (after - before) 2e-2 in
relative l2 and the residuals' share of elements moved a quarter int8
step 0.1 (:func:`test_torch_train.moved_share`)."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import convert, lm as tlm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from test_torch_moe_sharded import (ARCHS, B, MESHES, rel,  # noqa: E402
                                    run_port, run_reference, world_of)
from test_torch_train import ERR_SHARE, moved_share  # noqa: E402

LOSS_RTOL, GRAD_TOL, VALUE_TOL = 1e-5, 1e-4, 1e-4
GNORM_RTOL = {"none": 1e-5, "int8": 1e-4}
L2_TOL, UPDATE_TOL = 1e-4, 2e-2
TRAIN_STEPS = 3
MAX_LEN = 24        # the programs' prefill length
NOSP_MESHES = ("1x4", "2x2")
# train case -> (grad_compression, EF-int8 block), as the programs run
# them: AdamW at every mesh, the others at NOSP_MESHES
TRAIN = {"adamw": ("none", 2048), "adafactor": ("none", 2048),
         "int8": ("int8", 2048), "int8_unaligned": ("int8", 1536)}
TRAIN_CASES = [("adamw", m) for m in MESHES] + [
    (c, m) for c in TRAIN if c != "adamw" for m in NOSP_MESHES]
FAULT_CASES = [(c, m) for c in ("adafactor", "int8_unaligned")
               for m in NOSP_MESHES]
# (pattern length, whole groups) of the reduced configs: layer i of the
# port is the reference's groups[i % P][i // P], or tail[i - G P]
LAYOUT = {"olmoe-1b-7b": (1, 3), "llama4-maverick-400b-a17b": (2, 1)}


DIRS = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_sharded")
    DIRS["lm"] = d
    ref = run_reference("lm", d)
    return dict(np.load(ref)), run_port("lm", ref, d)


def _rows(o, mesh):
    _, nd, _ = world_of(mesh)
    dr = int(o[f"{mesh}/data_rank"])
    return slice(dr * B // nd, (dr + 1) * B // nd)


SPECS = {}


def _specs(arch, mesh):
    """(shape-only ctx of ``mesh``, {leaf path: placement}) of the model
    placed by the rules."""
    if (arch, mesh) not in SPECS:
        _, nd, nm = world_of(mesh)
        ctx = tsh.shape_ctx((nd, nm), ("data", "model"))
        model = tsh.place_(tlm.LM(tconfigs.reduced(arch), device="meta"),
                           ctx)
        SPECS[arch, mesh] = ctx, convert.leaf_shards(model, ctx).specs
    return SPECS[arch, mesh]


def _block(a, spec, o, mesh, ctx):
    """The rank's block of array ``a`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        model = ax == ctx.model_axis
        r = int(o[f"{mesh}/{'model' if model else 'data'}_rank"])
        n = ctx.n_model if model else ctx.n_data
        s = a.shape[dim] // n
        a = np.take(a, range(r * s, (r + 1) * s), axis=dim)
    return a


def _mine(want, path, o, mesh, arch):
    """The rank's block of a reference leaf under its placement."""
    ctx, specs = _specs(arch, mesh)
    return _block(want, specs[path], o, mesh, ctx)


def _leaves(o, prefix):
    return {k[len(prefix):]: v for k, v in o.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(runs, arch, mesh):
    ref, port = runs
    world = world_of(mesh)[0]
    want_loss = float(ref[f"{arch}/{mesh}/loss"])
    for o in port[world]:
        assert float(o[f"{arch}/{mesh}/loss"]) == pytest.approx(
            want_loss, rel=LOSS_RTOL)
        grads = _leaves(o, f"{arch}/{mesh}/grads/")
        assert set(grads) == set(_leaves(ref, f"{arch}/{mesh}/grads/"))
        for path, g in grads.items():
            want = _mine(ref[f"{arch}/{mesh}/grads/{path}"], path, o, mesh,
                         arch)
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
    """Logits of the rank's rows; states of its rows and of its heads or
    cache slots (``state_shardings``)."""
    ref, port = runs
    world = world_of(mesh)[0]
    cfg = tconfigs.reduced(arch)
    ctx = _specs(arch, mesh)[0]
    st_sh = tspecs.state_shardings(
        cfg, tlm.state_init(cfg, B, MAX_LEN, device="meta"), ctx, B)
    for o in port[world]:
        rows = _rows(o, mesh)
        for tag in ("prefill", "decode"):
            got = o[f"{arch}/{mesh}/{tag}_logits"]
            want = ref[f"{arch}/{mesh}/{tag}_logits"][rows]
            assert rel(got, want) < VALUE_TOL, tag
        for tag in ("states", "decode_states"):
            st = _leaves(o, f"{arch}/{mesh}/{tag}/")
            assert st, tag
            for key, got in st.items():
                i, leaf = key.split("/")
                want = _block(_state(ref, arch, mesh, tag, int(i), leaf),
                              st_sh[int(i)][leaf], o, mesh, ctx)
                assert got.shape == want.shape, (tag, key)
                assert rel(got, want) < VALUE_TOL, (tag, key)


def _l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def train_readings(ref, outs, arch, mesh, case, tag):
    """The worst reading over the ranks of the port's run ``tag`` of
    train case ``case`` against the reference's: per step loss and grad
    norm (relative), after the last step each parameter (rel l2) and
    each leaf's update, and the residuals' moved share."""
    want_tag = f"{arch}/{mesh}/train/{case}"
    got_tag = f"{arch}/{mesh}/train/{tag}"
    r = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "update": 0.0,
         "err": 0.0}
    for o in outs:
        for s in range(TRAIN_STEPS):
            for key in ("loss", "grad_norm"):
                want = float(ref[f"{want_tag}/{s}/{key}"])
                got = float(o[f"{got_tag}/{s}/{key}"])
                r[key] = max(r[key], abs(got / want - 1))
        params = _leaves(o, f"{got_tag}/params/")
        assert set(params) == set(_leaves(ref, f"{want_tag}/params/"))
        for path, p in params.items():
            want = _mine(ref[f"{want_tag}/params/{path}"], path, o, mesh,
                         arch)
            p0 = _mine(ref[f"{arch}/params/{path}"], path, o, mesh, arch)
            r["params"] = max(r["params"], _l2(p, want))
            r["update"] = max(r["update"], _l2(p - p0, want - p0))
    errs = _leaves(ref, f"{want_tag}/err/")
    assert set(errs) == set(_leaves(outs[0], f"{got_tag}/err/"))
    for path, want in errs.items():
        got = outs[0][f"{got_tag}/err/{path}"]
        r["err"] = max(r["err"], moved_share(got, want, TRAIN[case][1]))
    return r


@pytest.mark.parametrize("case,mesh", TRAIN_CASES)
def test_train_steps_match_reference(runs, case, mesh):
    ref, port = runs
    comp = TRAIN[case][0]
    r = train_readings(ref, port[world_of(mesh)[0]], ARCHS[0], mesh, case,
                       case)
    assert r["loss"] <= LOSS_RTOL and r["grad_norm"] <= GNORM_RTOL[comp], r
    if comp == "none":
        assert r["params"] <= L2_TOL, r
    else:
        assert r["update"] <= UPDATE_TOL and r["err"] <= ERR_SHARE, r


@pytest.mark.parametrize("case,mesh", FAULT_CASES)
def test_planted_train_faults_are_rejected(runs, case, mesh):
    """Adafactor's update RMS taken over the rank's experts only, and
    EF-int8 blocks laid over the rank's shard of an expert leaf whose
    experts do not fill whole blocks, compute another step than the
    reference's global one; the tolerances above reject both."""
    ref, port = runs
    r = train_readings(ref, port[world_of(mesh)[0]], ARCHS[0], mesh, case,
                       f"{case}_fault")
    if TRAIN[case][0] == "none":
        assert r["params"] > 10 * L2_TOL, r
    else:
        assert r["update"] > 2 * UPDATE_TOL or r["err"] > 2 * ERR_SHARE, r


@pytest.mark.parametrize("mesh", NOSP_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_non_sequence_parallel_gradients_match_reference(runs, arch, mesh):
    """S = 15: every model rank routes every token; the output's
    cotangent is divided by n_model and the router's and shared experts'
    gradients summed over the world group."""
    ref, port = runs
    want_loss = float(ref[f"{arch}/{mesh}/nosp/loss"])
    for o in port[world_of(mesh)[0]]:
        assert float(o[f"{arch}/{mesh}/nosp/loss"]) == pytest.approx(
            want_loss, rel=LOSS_RTOL)
        grads = _leaves(o, f"{arch}/{mesh}/nosp/grads/")
        assert set(grads) == set(_leaves(ref, f"{arch}/{mesh}/nosp/grads/"))
        for path, g in grads.items():
            want = _mine(ref[f"{arch}/{mesh}/nosp/grads/{path}"], path, o,
                         mesh, arch)
            assert rel(g, want) <= GRAD_TOL, (path, rel(g, want))


@pytest.mark.parametrize("mesh", NOSP_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_planted_cotangent_fault_is_caught(runs, arch, mesh):
    """Without the 1 / n_model factor every rank's duplicate routing adds
    its full cotangent: the gradients must fail the tolerance."""
    ref, port = runs
    worst = 0.0
    for o in port[world_of(mesh)[0]]:
        for path, g in _leaves(o, f"{arch}/{mesh}/nosp_fault/grads/").items():
            want = _mine(ref[f"{arch}/{mesh}/nosp/grads/{path}"], path, o,
                         mesh, arch)
            worst = max(worst, rel(g, want))
    assert worst > 100 * GRAD_TOL, worst


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_equals_local_without_drops_or_aux(runs, mesh):
    """Capacity 8.0 drops no token and aux weight 0 removes the per-rank
    aux terms: what remains is the same function, so the sharded loss
    and gradient equal the local path's on the global batch."""
    arch = ARCHS[0]
    _, port = runs
    world = world_of(mesh)[0]
    for o in port[world]:
        assert float(o[f"{arch}/{mesh}/inv/loss"]) == pytest.approx(
            float(o[f"{arch}/{mesh}/inv/local_loss"]), rel=LOSS_RTOL)
        grads = _leaves(o, f"{arch}/{mesh}/inv/grads/")
        for path, g in grads.items():
            want = _mine(o[f"{arch}/{mesh}/inv/local_grads/{path}"], path,
                         o, mesh, arch)
            assert rel(g, want) <= GRAD_TOL, (path, rel(g, want))


def test_trainer_with_ctx_matches_unsharded_trainer(runs, tmp_path):
    """Trainer(ctx=): every rank takes its rows of the stream and its
    blocks of the placed model; without drops or aux (capacity 8, aux weight 0) the losses of
    three steps equal the unsharded Trainer's."""
    import sys
    import pathlib
    from repro_torch import configs as tconfigs
    from repro_torch.train import Trainer
    sys.path.insert(0, str(pathlib.Path(__file__).parent / "progs"))
    from torch_sharded import trainer_setup
    arch = ARCHS[0]
    cfg = tconfigs.reduced(arch)
    cfg, tcfg, data = trainer_setup(cfg, str(tmp_path))
    tr = Trainer(cfg, tcfg, data, device="cpu")
    tr.run()
    want = [h["loss"] for h in tr.history if "loss" in h]
    _, port = runs
    for mesh in MESHES:
        for o in port[world_of(mesh)[0]]:
            got = o[f"{arch}/{mesh}/trainer_losses"]
            assert len(got) == len(want) == 3
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_checkpoints_whole_leaves(runs, mesh):
    """Trainer(ctx=) writes one checkpoint of whole leaves (rank 0
    assembles every rank's blocks), in the reference's format:
    ``repro.ckpt.load_checkpoint`` reads it, every leaf finite and at the
    reference's shape."""
    import jax
    from repro import configs as jconfigs
    from repro.ckpt import load_checkpoint
    from repro.models import lm as jlm
    from repro.optim import OptConfig as JOpt, init_opt as jinit
    arch = ARCHS[0]
    params = jax.eval_shape(lambda: jlm.init(jconfigs.reduced(arch),
                                             jax.random.key(0)))
    tmpl = (params, jax.eval_shape(lambda p: jinit(JOpt(), p), params),
            None)

    def load(m):
        d = DIRS["lm"] / f"lm_world{world_of(m)[0]}" / f"ckpt_{m}"
        step, tree, _ = load_checkpoint(str(d), tmpl)
        assert step == 2
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    got = load(mesh)
    shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  tmpl)[0]}
    assert set(got) == set(shapes)
    for key, arr in got.items():
        assert arr.shape == shapes[key], key
        assert np.isfinite(arr.astype(np.float64)).all(), key
