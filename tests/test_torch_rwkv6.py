"""The port's RWKV-6 time mix (repro_torch.models.rwkv6) against the
reference's (repro.models.rwkv6 and repro.models.lm._rwkv6_prefill) on
identical weights and inputs made with numpy.

Tolerances, as a share of max|reference| (the existing LM tolerance of
tests/test_torch_lm.py): float32 1e-4, bfloat16 5e-2.  Both prefills are
the same sequential scan; they differ by summation order inside each
step's products."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "rwkv6-3b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(dtype, seed=0, perturb=True):
    """Reference params (the zero-initialized mixes and norm scale moved
    off zero, so every term of the step is exercised) and the port's
    module holding them."""
    jcfg = jconfigs.reduced(ARCH)
    p = jrw.rwkv6_init(jax.random.key(seed), jcfg, JDT[dtype])
    if perturb:
        rng = np.random.default_rng(seed)
        for name in ("mu_x", "ln_scale", *(f"mu_{s}" for s in jrw.STREAMS)):
            p[name] = jnp.asarray(rng.normal(size=p[name].shape) * 0.3,
                                  jnp.float32)
    mod = trw.RWKV6(tconfigs.reduced(ARCH), tlayers.dtype_of(dtype))
    names = dict(mod.named_parameters())
    assert set(names) == set(p)
    for name, a in p.items():
        t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
        names[name].data.copy_(t.to(names[name].dtype))
    return jcfg, p, mod


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(
        tlayers.dtype_of(dtype))


def test_init_matches_reference_shapes():
    jcfg, p, _ = _pair("float32", perturb=False)
    fresh = trw.RWKV6(tconfigs.reduced(ARCH), torch.float32,
                      torch.Generator().manual_seed(0))
    for name, a in p.items():
        got = getattr(fresh, name)
        assert tuple(got.shape) == a.shape, name
        assert got.dtype == tlayers.dtype_of(str(a.dtype)), name
    for name in ("mu_x", "w0", "ln_scale"):
        assert np.array_equal(getattr(fresh, name).numpy(),
                              np.asarray(p[name])), name


def test_ddlerp_streams_and_head_norm_match_reference():
    jcfg, p, mod = _pair("float32", seed=1)
    d, D = jcfg.d_model, jcfg.rwkv_head_dim
    jx, tx = _x((2, 5, d), "float32", 1)
    jp, tp = _x((2, 5, d), "float32", 2)
    jm, tm = jrw._ddlerp(p, jx, jp), mod._ddlerp(tx, tp)
    for s in jrw.STREAMS:
        assert _rel(tm[s], jm[s]) < 1e-5, s
    for got, want in zip(mod._streams(tm, torch.float32),
                         jrw._streams(p, jm, d // D, D, jnp.float32)):
        assert got.shape == want.shape and _rel(got, want) < 1e-5
    jy, ty = _x((2, 5, d // D, D), "float32", 3)
    assert _rel(mod._head_norm(ty), jrw._head_norm(p, jy)) < 1e-5


def test_mix_step_matches_reference():
    rng = np.random.default_rng(4)
    S, r, k, v, w = (rng.normal(size=s).astype(np.float32) for s in (
        (2, 3, 8, 8), (2, 3, 8), (2, 3, 8), (2, 3, 8), (2, 3, 8)))
    u = rng.normal(size=(3, 8)).astype(np.float32)
    jS, jy = jrw._mix_step(*(jnp.asarray(a) for a in (S, r, k, v, w, u)))
    tS, ty = trw.mix_step(*(torch.from_numpy(a) for a in (S, r, k, v, w, u)))
    assert _rel(tS, jS) < 1e-6 and _rel(ty, jy) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33])
def test_prefill_and_decode_match_reference(dtype, S):
    """The prefill's output and final (S, x_prev) state against
    _rwkv6_prefill (and rwkv6_apply), then 6 decode steps against
    rwkv6_step."""
    jcfg, p, mod = _pair(dtype, seed=S)
    jx, tx = _x((2, S, jcfg.d_model), dtype, S)
    jout, jst = jlm._rwkv6_prefill(p, jx, jcfg)
    tout, tst = mod.prefill(tx)
    assert tout.dtype == tlayers.dtype_of(dtype)
    assert _rel(tout, jout) < TOL[dtype]
    assert _rel(tout, jrw.rwkv6_apply(p, jx, jcfg)) < TOL[dtype]
    assert tst["S"].dtype == torch.float32
    assert _rel(tst["S"], jst["S"]) < TOL[dtype]
    assert torch.equal(tst["x_prev"], tx[:, -1])
    for i in range(6):
        jx1, tx1 = _x((2, 1, jcfg.d_model), dtype, 100 + i)
        jy, jst = jrw.rwkv6_step(p, jx1, jcfg, jst)
        ty, tst = mod.decode_step(tx1, tst)
        assert _rel(ty, jy) < TOL[dtype], i
        assert _rel(tst["S"], jst["S"]) < TOL[dtype], i


def test_state_init_matches_reference():
    want = jrw.state_init(jconfigs.reduced(ARCH), 3, jnp.bfloat16)
    got = trw.state_init(tconfigs.reduced(ARCH), 3, torch.bfloat16, "cpu")
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and not got[k].any()
    assert got["S"].dtype == torch.float32
    assert got["x_prev"].dtype == torch.bfloat16


@pytest.mark.parametrize("T", [1, 5, 64, 130])
def test_scan_equals_the_step_by_step_recurrence(T):
    """scan's blocked walk (SCAN_BLOCK steps a block) against mix_step
    applied T times: the same states and readouts."""
    rng = np.random.default_rng(T)
    r, k, v = (torch.from_numpy(rng.normal(size=(2, T, 3, 8))
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.3, 1.0, (2, T, 3, 8))
                         .astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    y, S = trw.scan(r, k, v, w, u)
    S_ref = torch.zeros((2, 3, 8, 8))
    for t in range(T):
        S_ref, y_t = trw.mix_step(S_ref, r[:, t], k[:, t], v[:, t], w[:, t],
                                  u)
        assert torch.allclose(y[:, t], y_t, rtol=1e-6, atol=1e-6), t
    assert torch.allclose(S, S_ref, rtol=1e-6, atol=1e-6)
