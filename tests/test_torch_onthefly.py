"""The on-the-fly DWT / iDWT of the port (repro_torch.kernels.wigner_rec),
their bindings and plans, against the reference package on identical
inputs, and against the port's fused kernels, which they must equal by
value (every degree marched from l = 0 instead of the ragged skip).

On the CPU the wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as the reference's own tests
do.  Tolerances are the reference's (tests/test_dwt_fused.py): rtol
1e-10 / atol 1e-11 in f64, 5e-4 / 1e-4 in f32; the plans' f64
tolerance is tests/test_core_soft.py's rtol 1e-11 / atol 1e-12.  The
CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import batched as jb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wigner_rec as jwr  # noqa: E402

from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import dwt_fused as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import wigner_rec as twr  # noqa: E402

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NDT = {torch.float32: np.float32, torch.float64: np.float64}
RTOL, ATOL = 1e-11, 1e-12       # plans, f64 (tests/test_core_soft.py)


def _tol(dtype):
    return (5e-4, 1e-4) if dtype == torch.float32 else (1e-10, 1e-11)


def _inputs(B, dtype, tk=4):
    """Identical on-the-fly inputs for both packages, in the plan's
    cluster order (the on-the-fly kernels take no permutation)."""
    jp = jb.build_plan(B, dtype=JDT[dtype], pad_to=tk)
    seeds, m, mp, cb = (np.asarray(x) for x in jops.onthefly_inputs(jp))
    return dict(jp=jp, jax=(seeds, m, mp, cb),
                torch=tops.onthefly_inputs_from_arrays(seeds, m, mp, cb,
                                                       device="cpu"))


def _lhs(jp, B, V, dtype, seed):
    """lhs as _gather_coeffs makes it: zero below each cluster's l-start."""
    rng = np.random.default_rng(seed)
    fh = [rng.uniform(-1, 1, (B, 2 * B - 1, 2 * B - 1)) for _ in range(V)]
    return np.asarray(jops.pack_lanes(jnp.stack(
        [jb._gather_coeffs(jp, jnp.asarray(f)) for f in fh]))) \
        .astype(NDT[dtype])


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_forward_matches_reference(B, V, dtype):
    tk = 4
    inp = _inputs(B, dtype, tk)
    K, J = inp["jax"][0].shape
    rhs = (np.random.default_rng(B * 10 + V).normal(size=(K, J, V * 16))
           * 0.3).astype(NDT[dtype])
    out = twr.dwt_onthefly(*inp["torch"], torch.as_tensor(rhs), B=B,
                           tk=tk).numpy()
    want = np.asarray(jwr.dwt_onthefly(*inp["jax"], rhs, B=B, tk=tk,
                                       interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        out, np.asarray(jref.dwt_ref(np.asarray(inp["jp"].d), rhs)),
        rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_inverse_matches_reference(B, V, dtype):
    tk = 4
    inp = _inputs(B, dtype, tk)
    lhs = _lhs(inp["jp"], B, V, dtype, B * 10 + V + 1)
    out = twr.idwt_onthefly(*inp["torch"], torch.as_tensor(lhs), B=B,
                            tk=tk).numpy()
    want = np.asarray(jwr.idwt_onthefly(*inp["jax"], lhs, B=B, tk=tk,
                                        interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        out, np.asarray(jref.idwt_ref(np.asarray(inp["jp"].d), lhs)),
        rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_onthefly_equals_fused_by_value(B, dtype):
    """The fused kernels skip each tile's rows below l0 and run the
    clusters l-start-sorted (through perm); the on-the-fly ones march
    every degree in the plan's order.  Rows below m are exact zeros of
    the recurrence's active mask, so the two agree exactly."""
    tk = 4
    inp = _inputs(B, dtype, tk)
    jp = inp["jp"]
    perm_np, _, l0s_np = jops.fused_metadata(jp, tk)
    seeds, m, mp, cb = inp["jax"]
    fused_in = tops.onthefly_inputs_from_arrays(
        seeds[perm_np], m[perm_np], mp[perm_np], cb, device="cpu")
    perm, l0s = torch.as_tensor(perm_np), torch.as_tensor(l0s_np)
    K, J = seeds.shape
    rng = np.random.default_rng(B)
    rhs = torch.as_tensor(rng.normal(size=(K, J, 32)).astype(NDT[dtype]))
    lhs = torch.as_tensor(_lhs(jp, B, 2, dtype, B))
    assert torch.equal(
        twr.dwt_onthefly(*inp["torch"], rhs, B=B, tk=tk),
        tdf.dwt_fused(*fused_in, rhs, l0s, B=B, tk=tk, perm=perm))
    assert torch.equal(
        twr.idwt_onthefly(*inp["torch"], lhs, B=B, tk=tk),
        tdf.idwt_fused(*fused_in, lhs, l0s, B=B, tk=tk, perm=perm))


def test_rows_below_m_are_zero():
    B = 8
    inp = _inputs(B, torch.float64)
    K, J = inp["jax"][0].shape
    rhs = torch.as_tensor(np.random.default_rng(1).normal(size=(K, J, 16)))
    out = twr.dwt_onthefly(*inp["torch"], rhs, B=B, tk=4)
    m = inp["torch"][1].long()
    below = torch.arange(B)[None, :] < m[:, None]
    assert below.any() and not out[below].any()


def test_tile_must_divide_and_cpu_launches_nothing():
    inp = _inputs(4, torch.float64, tk=2)
    K, J = inp["jax"][0].shape           # K = 10
    before = dict(twr.LAUNCHES)
    with pytest.raises(ValueError, match="% tk=4"):
        twr.dwt_onthefly(*inp["torch"], torch.zeros(K, J, 16,
                                                    dtype=torch.float64),
                         B=4, tk=4)
    twr.dwt_onthefly(*inp["torch"], torch.zeros(K, J, 16,
                                                dtype=torch.float64),
                     B=4, tk=2)
    twr.idwt_onthefly(*inp["torch"], torch.zeros(K, 4, 16,
                                                 dtype=torch.float64),
                      B=4, tk=2)
    assert twr.LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(8, 16, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        twr.dwt_onthefly(x[:, :, 0], x[:, 0, 0].int(), x[:, 0, 0].int(),
                         x[0, :, 0], x, B=8)


# ---------------------------------------------------------------------------
# bindings and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("direction", ["dwt", "idwt"])
def test_make_fn_matches_reference(B, batch, direction):
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8)
    tp = tb.build_plan(B, dtype=torch.float64, pad_to=8, device="cpu")
    A = 2 * B if direction == "dwt" else B
    lead = () if batch is None else (batch,)
    x = np.random.default_rng(B).normal(size=lead + (jp.n_padded, A, 8, 2))
    jfn = getattr(jops, f"make_{direction}_fn")(jp, "onthefly", tk=8,
                                               batch=batch, interpret=True)
    tfn = getattr(tops, f"make_{direction}_fn")(tp, "onthefly", tk=8,
                                               batch=batch)
    got = tfn(tp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfn(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-11)
    fused = getattr(tops, f"make_{direction}_fn")(tp, "fused", tk=8,
                                                  batch=batch)
    assert torch.equal(got, fused(tp, torch.as_tensor(x)))


def _stack(B, seeds):
    return np.stack([tsoft.random_coeffs(B, s) for s in seeds])


@pytest.mark.parametrize("B", [4, 8])
def test_plan_matches_reference_plan(B):
    t = tplan(B, device="cpu", impl="onthefly", V=2)
    j = jplan(B, impl="onthefly", V=2)
    fhats = _stack(B, range(3))
    f = t.inverse(fhats[0])
    np.testing.assert_allclose(f.numpy(), np.asarray(j.inverse(fhats[0])),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        t.forward(f).numpy(), np.asarray(j.forward(jnp.asarray(f.numpy()))),
        rtol=RTOL, atol=ATOL)
    fs = t.inverse_batch(fhats)
    np.testing.assert_allclose(fs.numpy(), np.asarray(j.inverse_batch(fhats)),
                               rtol=RTOL, atol=ATOL)
    backs = t.forward_batch(fs)
    np.testing.assert_allclose(
        backs.numpy(), np.asarray(j.forward_batch(jnp.asarray(fs.numpy()))),
        rtol=RTOL, atol=ATOL)
    # the fused plan's bits
    fused = tplan(B, device="cpu", V=2)
    assert torch.equal(fs, fused.inverse_batch(fhats))
    assert torch.equal(backs, fused.forward_batch(fs))


def test_batched_lane_equals_single_bitwise():
    t = tplan(8, device="cpu", impl="onthefly", V=4, streaming=True)
    fhats = _stack(8, range(3))
    fs = t.inverse_batch(fhats)
    backs = t.forward_batch(fs)
    for k in range(3):
        assert torch.equal(fs[k], t.inverse(fhats[k]))
        assert torch.equal(backs[k], t.forward(fs[k]))


def test_plan_schedule_rules():
    t = tplan(8, device="cpu", impl="onthefly")
    s = t.schedule
    assert s.impl == s.inverse_impl == "onthefly" and s.lchunk is None
    assert s.smem_bytes == t.describe()["smem_bytes"] > 0
    # the recurrence family streams at paper scale, as the reference does
    assert tplan(128, device="cpu", impl="onthefly").soft_plan.streaming
    with pytest.raises(ValueError, match="impl='fused'"):
        tplan(8, device="cpu", impl="onthefly", lchunk=4)
    with pytest.raises(ValueError, match="impl='fused'"):
        tplan(8, device="cpu", impl="onthefly", precision="bf16")
