"""repro_torch.plan end to end on the CPU: the port's FSOFT / iFSOFT
against repro.plan and the direct O(B^6) transforms, the bitwise
invariants the port keeps inside itself (beta-slab == monolithic,
batched lane == single transform), and the planner's rules.

f64 tolerance: rtol 1e-11 / atol 1e-12 (tests/test_core_soft.py)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.core import soft as jsoft  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

RTOL, ATOL = 1e-11, 1e-12


def _stack(B, seeds):
    return np.stack([tsoft.random_coeffs(B, s) for s in seeds])


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_single_matches_reference_plan(B, impl):
    t = tplan(B, device="cpu", impl=impl)
    j = jplan(B)
    fhat = tsoft.random_coeffs(B, B)
    f = t.inverse(fhat)
    assert f.shape == (2 * B,) * 3 and f.dtype == torch.complex128
    np.testing.assert_allclose(f.numpy(), np.asarray(j.inverse(fhat)),
                               rtol=RTOL, atol=ATOL)
    back = t.forward(f)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(j.forward(jnp.asarray(f.numpy()))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), fhat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [4, 8])
def test_single_matches_direct_transforms(B):
    t = tplan(B, device="cpu")
    fhat = tsoft.random_coeffs(B, 7)
    f_direct = jsoft.direct_inverse(fhat)
    np.testing.assert_allclose(t.inverse(fhat).numpy(), f_direct,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.forward(f_direct).numpy(),
                               jsoft.direct_forward(f_direct, B),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [4, 8, 16])
def test_batches_match_reference_plan(B):
    """V = 2 with three requests: one full chunk and a partial one."""
    t = tplan(B, device="cpu", V=2)
    j = jplan(B, V=2)
    fhats = _stack(B, range(3))
    t.reset_stats()
    fs = t.inverse_batch(fhats)
    assert t.stats == dict(launches=2, transforms=3, padded_lanes=1)
    np.testing.assert_allclose(fs.numpy(), np.asarray(j.inverse_batch(fhats)),
                               rtol=RTOL, atol=ATOL)
    backs = t.forward_batch(fs)
    np.testing.assert_allclose(
        backs.numpy(), np.asarray(j.forward_batch(jnp.asarray(fs.numpy()))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(backs.numpy(), fhats, rtol=RTOL, atol=ATOL)
    assert t.forward_batch(fs[:0]).shape == (0, B, 2 * B - 1, 2 * B - 1)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("streaming", [False, True])
def test_batched_lane_equals_single_bitwise(B, streaming):
    t = tplan(B, device="cpu", V=4, streaming=streaming)
    fhats = _stack(B, range(3))
    fs = t.inverse_batch(fhats)
    backs = t.forward_batch(fs)
    for k in range(3):
        assert torch.equal(fs[k], t.inverse(fhats[k]))
        assert torch.equal(backs[k], t.forward(fs[k]))


def test_beta_slab_equals_monolithic_bitwise():
    """B = 8 slabs J = 16 in linspace's quarters; at B = 5 and 7 (J % 4
    == 2) the mirror-symmetric cuts are no longer linspace's, in the
    inverse too."""
    for B in (8, 5, 7):
        mono = tplan(B, device="cpu", streaming=False, V=2)
        slab = tplan(B, device="cpu", streaming=True, V=2)
        assert not mono.soft_plan.streaming and slab.soft_plan.streaming
        fhats = _stack(B, (5, 6, 7))
        assert torch.equal(slab.inverse(fhats[0]), mono.inverse(fhats[0]))
        f = mono.inverse_batch(fhats)
        assert torch.equal(slab.inverse_batch(fhats), f)
        assert torch.equal(slab.forward(f[0]), mono.forward(f[0]))
        assert torch.equal(slab.forward_batch(f), mono.forward_batch(f))
        plan = mono.soft_plan
        assert torch.equal(tb.streamed_rhs(plan, f),
                           tb._gather_rhs(plan, tb.fft_analysis(f)))


def _scaled_ifft2(x):
    """(2B)^2 * ifft2 as the scaled formula: each ifft normalised by 1 / 2B,
    the result multiplied by (2B)^2; lane by lane for a stack."""
    if x.ndim > 3:
        return torch.stack([_scaled_ifft2(xi) for xi in x])
    n = x.shape[-3]
    return (n * n) * torch.fft.ifft(torch.fft.ifft(x, dim=-3), dim=-1)


def _unscaled_ifft2(x):
    """(2B)^2 * ifft2 with both iffts unnormalized; lane by lane."""
    if x.ndim > 3:
        return torch.stack([_unscaled_ifft2(xi) for xi in x])
    return torch.fft.ifft(torch.fft.ifft(x, dim=-3, norm="forward"), dim=-1,
                          norm="forward")


def _pow2(n):
    return n & (n - 1) == 0


def _assert_rounding_close(got, want):
    """got differs from want by the rounding of the 1 / 2B scalings alone:
    at most 4 ulps of the largest value (1.7 ulps measured)."""
    eps = torch.finfo(want.real.dtype).eps
    assert (got - want).abs().max() <= 4 * eps * want.abs().max()


def _linspace_bounds(J):
    cuts = np.linspace(0, J, min(tb.GRID_N_SLABS, J) + 1).astype(int)
    return tuple((int(a), int(b)) for a, b in zip(cuts, cuts[1:]) if a < b)


def _two_spectra_rhs(plan, f, ifft2):
    """The beta-slab FFT + gather with two spectra a slab, the slab's own
    and its mirror's, each from ``ifft2``: rows [j0, j1) of
    _gather_rhs(plan, fft_analysis(f)) for any cut of [0, J) into slabs."""
    J = 2 * plan.B
    K, C = plan.gather_m.shape
    rhs = torch.empty(f.shape[:-3] + (K, J, C, 2), dtype=plan.dtype)
    for j0, j1 in _linspace_bounds(J):
        direct = tb._at_members(plan, ifft2(f[..., j0:j1, :]))
        mirror = tb._at_members(
            plan, ifft2(f[..., J - j1:J - j0, :])).flip(-1)
        Sm = torch.where(plan.reflected[..., None], mirror, direct)
        rhs[..., j0:j1, :, :] = tb._rhs_from_members(plan, Sm, plan.w[j0:j1])
    return rhs


def _grids(B, V, dtype, seed):
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((V,) + (2 * B,) * 3, generator=gen, dtype=cdt)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("B", [5, 7, 8, 16])
def test_streamed_rhs_equals_two_spectra_loop_bitwise(B, V, dtype):
    """One spectrum a slab, shared with its mirror slab and computed
    unscaled, gives the bits of two spectra a slab (scaled ones where 2B
    is a power of two, unscaled ones else) and of the whole-grid FFT +
    gather; lane 0 alone gives lane 0's."""
    plan = tplan(B, dtype, device="cpu", streaming=True, V=2).soft_plan
    assert plan.streaming
    f = _grids(B, V, dtype, seed=10 * B + V)
    rhs = tb.streamed_rhs(plan, f)
    ifft2 = _scaled_ifft2 if _pow2(2 * B) else _unscaled_ifft2
    assert torch.equal(rhs, _two_spectra_rhs(plan, f, ifft2))
    assert torch.equal(rhs, tb._gather_rhs(plan, tb.fft_analysis(f)))
    assert torch.equal(tb.streamed_rhs(plan, f[0]), rhs[0])


@pytest.mark.parametrize("n_slabs", [1, 3, 5])
def test_streamed_rhs_middle_slab_is_its_own_mirror(n_slabs, monkeypatch):
    """With an odd slab count the middle slab is its own mirror: its one
    spectrum serves both roles, and the rows stay bitwise the whole-grid
    FFT + gather's."""
    B = 8
    plan = tplan(B, device="cpu", streaming=True, V=2).soft_plan
    bounds = tb._slab_bounds(2 * B, n_slabs)
    assert len(bounds) == n_slabs
    monkeypatch.setattr(tb, "_slab_bounds", lambda J: bounds)
    f = _grids(B, 2, torch.float64, seed=n_slabs)
    rec = obs.Recorder()
    old = obs.set_recorder(rec)
    try:
        rhs = tb.streamed_rhs(plan, f)
    finally:
        obs.set_recorder(old)
    assert rec.counter(tb.SLAB_SPECTRA) == n_slabs
    assert torch.equal(rhs, tb._gather_rhs(plan, tb.fft_analysis(f)))


def test_slab_bounds_are_mirror_symmetric():
    """Slabs cover [0, J) in order, the mirror of each is a slab, and for
    4 | J they are np.linspace's cuts (J = 256 and 1024 included), so the
    slab shapes of plan(128) and plan(512) stay as they were."""
    for J in list(range(2, 65)) + [256, 1024]:
        bounds = tb._slab_bounds(J)
        assert bounds[0][0] == 0 and bounds[-1][1] == J, J
        assert all(a < b for a, b in bounds), J
        assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:])), J
        assert set(bounds) == {(J - b, J - a) for a, b in bounds}, J
        assert len(bounds) <= tb.GRID_N_SLABS + 1, J
        if J % 4 == 0:
            assert bounds == _linspace_bounds(J), J
    assert tb._slab_bounds(256) == ((0, 64), (64, 128), (128, 192),
                                    (192, 256))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [3, 5, 8, 16])
def test_fft_analysis_equals_scaled_formula_bitwise(B, dtype):
    """Unnormalized iffts give the scaled formula's bits where 2B is a
    power of two (B = 8, 16); at B = 3 and 5 they differ by its rounding
    alone."""
    f = _grids(B, 2, dtype, seed=B)
    pairs = [(tb.fft_analysis(f), _scaled_ifft2(f)),
             (tb.fft_analysis(f[1]), _scaled_ifft2(f[1]))]
    pairs += [(tb.fft_analysis_slab(f, j0, j1),
               _scaled_ifft2(f[..., j0:j1, :]))
              for j0, j1 in tb._slab_bounds(2 * B)]
    for got, want in pairs:
        if _pow2(2 * B):
            assert torch.equal(got, want)
        else:
            _assert_rounding_close(got, want)


@pytest.mark.parametrize("B", [8, 16])
def test_fp32_roundtrip_within_reference_bound(B):
    t = tplan(B, torch.float32, device="cpu")
    fhat = tsoft.random_coeffs(B, 1)
    back = t.forward(t.inverse(fhat)).numpy()
    assert back.dtype == np.complex64
    mask = tsoft.coeff_mask(B)
    rel = (np.abs(back - fhat)[mask] / np.abs(fhat)[mask]).max()
    assert rel < autotune.FP32_ROUNDTRIP_BOUNDS[B]


def test_plan_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.build_plan(8)


def test_plan_cache_and_callable_module():
    tplan.clear_cache()
    a = repro_torch.plan(8, device="cpu", V=2)
    b = tplan.plan(8, device="cpu", V=2)
    assert a is b and tplan.cache_stats()["hits"] == 1
    assert a.dwt_fn is b.dwt_fn and a.soft_plan is b.soft_plan
    assert tplan(8, device="cpu", V=4) is not a


def test_plan_refuses_a_transform_over_device_memory(monkeypatch):
    tplan.clear_cache()
    monkeypatch.setattr(autotune, "device_memory_bytes", lambda device: 1024)
    with pytest.raises(ValueError, match="estimate_batch_bytes"):
        tplan(8, device="cpu")
    tplan.clear_cache()


def test_schedule_and_describe():
    t = tplan(16, device="cpu")
    d = t.describe()
    assert d["impl"] == "fused" and d["device"] == "cpu"
    assert d["V"] == 8 and d["source"] == "static"   # tiny B: widest V fits
    assert d["streaming"] is False
    assert 0 < d["smem_bytes"] <= d["smem_limit"] == 232448
    assert set(d["kernel_launches"]) == {
        "dwt_fused", "idwt_fused", "build_windows", "dwt_streaming",
        "idwt_streaming", "dwt_onthefly", "idwt_onthefly", "dwt_dense",
        "idwt_dense", "dwt_ragged"}
    assert d["lchunk"] is None and d["precision"] == "fp32"
    assert d["window_bytes"] == 0
    assert "vmem_bytes" not in d and "vmem_limit" not in d
    # paper scale streams, as in the reference (no device work needed)
    assert tplan(128, device="cpu").soft_plan.streaming
    # f64 shared memory per block stays under Hopper's 227 KB up to B = 512
    assert autotune.estimate_smem_bytes(1024, 8, inverse=False) <= 232448


def test_executor_spans_recorded():
    """executor.chunk spans, one a chunk, are recorded while tracing is on
    and only then."""
    rec = obs.Recorder()
    old = obs.set_recorder(rec)
    try:
        t = tplan(4, device="cpu", V=2)
        t.inverse_batch(_stack(4, range(3)))
        assert not [e for e in rec.events() if e["name"] == "executor.chunk"]
        with obs.device_tracing():
            t.inverse_batch(_stack(4, range(3)))
    finally:
        obs.set_recorder(old)
    chunks = [e for e in rec.events() if e["name"] == "executor.chunk"]
    assert [e["args"]["lanes"] for e in chunks] == [2, 1]
    assert [e["args"]["chunk"] for e in chunks] == [0, 1]
    assert {e["args"]["mode"] for e in chunks} == {"local"}


@pytest.mark.parametrize("kwargs", [dict(tune="measure"),
                                    dict(mesh=object())])
def test_unported_options_raise(kwargs, tmp_path):
    """The two options that raised NotImplementedError before they were
    ported: tune="measure" now resolves a measured schedule, and a mesh
    plan without a torch.distributed process group raises instead of
    running locally."""
    if "mesh" in kwargs:
        with pytest.raises(RuntimeError, match="process group"):
            tplan(8, device="cpu", **kwargs)
        return
    t = tplan(8, device="cpu", tune_reps=1, tune_cache=tmp_path / "t.json",
              **kwargs)
    assert t.schedule.source == "measured" and t.schedule.per_transform_s > 0
    fhat = tsoft.random_coeffs(8, 2)
    np.testing.assert_allclose(t.forward(t.inverse(fhat)).numpy(), fhat,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "ragged", "onthefly"])
def test_other_schedules_plan_and_run(impl):
    """The schedules besides fused plan, run, and round-trip at the
    reference's f64 tolerance."""
    t = tplan(8, device="cpu", impl=impl, tl=4)
    assert t.schedule.impl == impl
    assert t.schedule.inverse_impl == ("dense" if impl == "ragged" else impl)
    assert t.soft_plan.streaming is False
    fhat = tsoft.random_coeffs(8, 3)
    back = t.forward(t.inverse(fhat)).numpy()
    np.testing.assert_allclose(back, fhat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kwargs", [dict(lchunk=4), dict(precision="bf16")])
def test_streaming_options_plan(kwargs):
    """lchunk= and precision="bf16" plan the streaming kernels."""
    t = tplan(8, device="cpu", **kwargs)
    assert t.schedule.lchunk == kwargs.get("lchunk", 8)
    assert t.schedule.precision == kwargs.get("precision", "fp32")
    fhat = tsoft.random_coeffs(8, 1)
    back = t.forward(t.inverse(fhat)).numpy()
    if "precision" in kwargs:      # bf16: the reference's gate, vs max|fhat|
        rel = np.abs(back - fhat).max() / np.abs(fhat).max()
        assert 0 < rel <= autotune.PRECISION_ERROR_BOUNDS[8]
    else:
        np.testing.assert_allclose(back, fhat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["engine", "s2_forward", "s2_inverse",
                                    "correlate"])
def test_so3_executors_match_reference(method):
    """The S^2 stage and correlation executors of a plan against the
    reference Transform's, on the same numpy inputs: S^2 transforms within
    rtol 1e-12 / atol 1e-13, matches with the same grid index, angles
    within 1e-9 rad and peak / score within rtol 1e-9."""
    from repro.so3.s2 import rotate_s2_coeffs
    B = 8
    t = tplan(B, device="cpu", V=2)
    j = jplan(B, V=2)
    flm = tsoft.random_s2_coeffs(B, seed=4)
    if method in ("s2_forward", "s2_inverse"):
        x = np.asarray(j.s2_inverse(flm)) if method == "s2_forward" else flm
        got = getattr(t, method)(x)
        assert got.device == t.device
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(j, method)(x)),
                                   rtol=1e-12, atol=1e-13)
        return
    f = rotate_s2_coeffs(flm, (0.7, 1.1, 2.9))
    if method == "engine":
        eng = t.engine()
        assert eng is t.engine() and eng.transform is t
        got, want = eng.match(f, flm), j.engine().match(f, flm)
        assert eng.stats["launches"] == 1
    else:
        got, want = t.correlate(f, flm), j.correlate(f, flm)
    assert got.index == want.index
    np.testing.assert_allclose(got.euler, want.euler, rtol=0, atol=1e-9)
    np.testing.assert_allclose([got.peak, got.score],
                               [want.peak, want.score], rtol=1e-9)


def test_bad_config_raises():
    with pytest.raises(ValueError, match="impl"):
        tplan(8, device="cpu", impl="nope")
    with pytest.raises(ValueError, match="V must"):
        tplan(8, device="cpu", V=0)
    with pytest.raises(ValueError, match="streaming"):
        tplan(8, device="cpu", impl="reference", streaming=True)
