"""The port's optimizers, schedule and gradient compression
(repro_torch.optim, repro_torch.train.compress) against the reference's
(repro.optim, repro.train.compress) on identical numpy inputs, and the
reference's own tests of them (tests/test_train_runtime.py) ported.

The port's optimizer takes flat {path: tensor} trees in the reference's
flatten order; a stacked (G, ...) leaf is one leaf, as in the
reference.  Tolerances, as a share of max|reference| per leaf: float32
parameters, state and grad norm 1e-6 (both sum the same float32 terms in
another order); bfloat16 parameters equal bit for bit or one bf16 step
apart where the float32 masters round differently; the int8 blocks and
their scales equal exactly (the same IEEE operations)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.optim import init_opt as jinit, opt_update as jupdate  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402

from repro_torch.ckpt.checkpoint import flatten_paths  # noqa: E402
from repro_torch.optim import (OptConfig, cosine_schedule,  # noqa: E402
                               init_opt, opt_update)
from repro_torch.train import compress  # noqa: E402

F32_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the reference's tests, ported
# ---------------------------------------------------------------------------

def quad_params():
    return {"a": torch.tensor([2.0, -3.0]),
            "b/w": torch.full((3, 4), 1.5, dtype=torch.bfloat16)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends(name):
    cfg = OptConfig(name=name, peak_lr=0.05, weight_decay=0.0, clip_norm=10.0)
    params = quad_params()
    state = init_opt(cfg, params)

    def loss(p):
        return sum(torch.sum(v.float() ** 2) for v in p.values())

    l0 = float(loss(params))
    for _ in range(50):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
        params, state, gnorm = opt_update(cfg, g, state, params, 0.05)
    assert float(loss(params)) < 0.25 * l0
    assert params["b/w"].dtype == torch.bfloat16  # dtype preserved


def test_adamw_matches_reference_math():
    """One AdamW step vs hand-computed update."""
    cfg = OptConfig(name="adamw", b1=0.9, b2=0.99, eps=1e-8,
                    weight_decay=0.0, clip_norm=1e9)
    p = {"w": torch.tensor([1.0])}
    st = init_opt(cfg, p)
    p2, st2, _ = opt_update(cfg, {"w": torch.tensor([0.5])}, st, p, 0.1)
    mhat = 0.1 * 0.5 / (1 - 0.9)
    vhat = 0.01 * 0.25 / (1 - 0.99)
    expect = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(p2["w"][0]), expect, rtol=1e-6)
    assert float(p["w"][0]) == 1.0          # the master never aliases p


def test_grad_clipping():
    cfg = OptConfig(clip_norm=1.0)
    p = {"w": torch.zeros(4)}
    st = init_opt(cfg, p)
    _, _, gnorm = opt_update(cfg, {"w": torch.full((4,), 100.0)}, st, p, 0.0)
    assert float(gnorm) == pytest.approx(200.0)


def test_cosine_schedule():
    kw = dict(peak_lr=1.0, warmup_steps=10, decay_steps=100)
    assert float(cosine_schedule(0, **kw)) == 0.0
    assert float(cosine_schedule(10, **kw)) == pytest.approx(1.0)
    assert float(cosine_schedule(110, **kw)) == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 57, 109, 110, 500])
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100)
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jcosine(step, **kw)),
                               rtol=1e-6, atol=0)


def test_adafactor_memory_factored():
    cfg = OptConfig(name="adafactor")
    st = init_opt(cfg, {"w": torch.zeros((128, 256), dtype=torch.bfloat16)})
    assert sum(x.numel() for x in flatten_paths(st["stats"]).values()) \
        == 128 + 256  # factored, not 128*256


# ---------------------------------------------------------------------------
# against the reference on identical trees
# ---------------------------------------------------------------------------

def _tree(rng, stacked: bool):
    """A reference tree (nested) with f32 and bf16 leaves of 1-3 axes;
    ``stacked`` adds (G, ...) leaves like lm.init's groups."""
    t = {"embed": rng.normal(size=(64, 16)).astype(np.float32) * 0.02,
         "final_norm": {"scale": rng.normal(size=(16,)).astype(np.float32)},
         "head": np.asarray(jnp.asarray(rng.normal(size=(32, 16)) * 0.1,
                                        jnp.bfloat16))}
    if stacked:
        t["groups"] = [{"mlp": {"wi": np.asarray(jnp.asarray(
                            rng.normal(size=(3, 16, 24)) * 0.2, jnp.bfloat16)),
                                "wo": rng.normal(size=(3, 24, 16))
                                .astype(np.float32) * 0.2},
                        "norm1": {"scale": rng.normal(size=(3, 16))
                                  .astype(np.float32)}}]
    return t


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name, stacked):
    """Three updates with the same gradients and learning rates: the
    parameters (float32 within F32_TOL; bf16 at most one bf16 step
    apart), every state leaf and the grad norm."""
    rng = np.random.default_rng(7)
    kw = dict(name=name, peak_lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    tree = _tree(rng, stacked)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = {k: _tensor(v) for k, v in flatten_paths(tree).items()}
    jst, tst = jinit(JOpt(**kw), jparams), init_opt(OptConfig(**kw), tparams)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * (0.5 + step)).astype(
            np.float32) for k, v in flatten_paths(tree).items()}
        lr = 1e-2 / (step + 1)
        jparams, jst, jg = jupdate(JOpt(**kw), jax.tree.unflatten(
            jax.tree.structure(jparams), [jnp.asarray(grads[k]) for k in
                                          flatten_paths(tree)]),
            jst, jparams, jnp.float32(lr))
        tparams, tst, tg = opt_update(OptConfig(**kw), {
            k: torch.from_numpy(g) for k, g in grads.items()}, tst, tparams,
            torch.tensor(lr, dtype=torch.float32))
        assert _rel(tg, jg) <= F32_TOL
    jflat = flatten_paths(jax.tree.map(np.asarray, jparams))
    for k, v in tparams.items():
        if v.dtype == torch.bfloat16:
            ulp = 2.0 ** -7 * np.abs(_np(jflat[k]))
            assert np.all(np.abs(_np(v) - _np(jflat[k])) <= ulp), k
        else:
            assert _rel(v, jflat[k]) <= F32_TOL, k
    jstate = flatten_paths(jax.tree.map(np.asarray, jst))
    tstate = flatten_paths(tst)
    assert jstate.keys() == tstate.keys()
    for k in jstate:
        assert _rel(tstate[k], jstate[k]) <= F32_TOL, k


def test_adafactor_factors_the_stack():
    """A stacked (G, d) norm scale is factored across layers (vr (G,),
    vc (d,)), as the reference's (G, d) leaf is; one layer alone would
    keep an unfactored (d,) moment."""
    st = init_opt(OptConfig(name="adafactor"),
                  {"groups/0/norm1/scale": torch.zeros((3, 16))})
    assert {k: tuple(v.shape) for k, v in
            st["stats"]["groups/0/norm1/scale"].items()} == \
        {"vr": (3,), "vc": (16,)}


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 2048, 5000, 3 * 144 * 144])
def test_ef_quantize_matches_reference(n):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n,)) * 3.0).astype(np.float32)
    err = (rng.normal(size=(n,)) * 1e-3).astype(np.float32)
    jq, js, je = jcompress.ef_quantize(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = compress.ef_quantize(torch.from_numpy(g),
                                      torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        compress.ef_dequantize(tq, ts, (n,)).numpy(),
        np.asarray(jcompress.ef_dequantize(jq, js, (n,))))


def test_ef_quantization_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.normal(size=(1000,)) * 3.0).astype(np.float32))
    deq, new_err = compress.ef_roundtrip(g, torch.zeros_like(g))
    # block max-scale int8: error <= scale/2 = max|block|/254
    assert float(torch.max(torch.abs(deq - g))) <= \
        float(torch.max(torch.abs(g))) / 200
    np.testing.assert_allclose(new_err.numpy(), (g - deq).numpy(), atol=1e-7)


def test_error_feedback_unbiased_over_time():
    """With EF, the running sum of compressed grads tracks the running sum
    of true grads -- without EF it drifts."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(256, np.float32)
    comp_sum = np.zeros(256, np.float32)
    err = torch.zeros(256)
    for _ in range(60):
        g = torch.from_numpy((rng.normal(size=(256,)) * 0.1 + 0.003)
                             .astype(np.float32))
        deq, err = compress.ef_roundtrip(g, err)
        true_sum += g.numpy()
        comp_sum += deq.numpy()
    assert np.abs(true_sum - comp_sum).max() < 0.01


def test_compress_grads_blocks_span_the_stack():
    """A stacked leaf is quantized as one flat array: its 2048-element
    blocks run across layer boundaries, as the reference's do (144 * 144
    is no multiple of 2048), so the result differs from compressing each
    layer alone."""
    rng = np.random.default_rng(3)
    g = (rng.normal(size=(3, 144, 144)) * 0.1).astype(np.float32)
    grads = {"groups/0/mixer/wq": torch.from_numpy(g)}
    got, err = compress.compress_grads(grads, compress.init_error_state(
        grads))
    jgot, jerr = jcompress.compress_grads({"w": jnp.asarray(g)},
                                          {"w": jnp.zeros(g.shape, jnp.float32)})
    np.testing.assert_array_equal(got["groups/0/mixer/wq"].numpy(),
                                  np.asarray(jgot["w"]))
    np.testing.assert_array_equal(err["groups/0/mixer/wq"].numpy(),
                                  np.asarray(jerr["w"]))
    per_layer = torch.stack([compress.ef_roundtrip(
        torch.from_numpy(g[i]), torch.zeros((144, 144)))[0]
        for i in range(3)])
    assert not torch.equal(per_layer, got["groups/0/mixer/wq"])
