"""repro_torch.so3 on the CPU against repro.so3: the Legendre table, the
S^2 transforms, the correlation grids and matching entry points, and the
device-side peak search, on the same numpy inputs in both packages.

Tolerances: the Legendre table and the seeded inputs are bit for bit the
reference's; the S^2 transforms agree within rtol 1e-12 / atol 1e-13
(measured: <= 4e-16 of max|x| at B <= 16) and round-trip at the
reference's rtol 1e-11 / atol 1e-12 (tests/test_so3.py); the correlation
grids agree within 1e-11 of max|C|; matching results share the grid
index and the bank winner, with angles within 1e-9 rad and peak / score
within rtol 1e-9 (the reference's own batched-vs-solo tolerance).
Inside the port, batched results equal direct ones bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import soft as jsoft  # noqa: E402
from repro.so3 import correlate as jcorr  # noqa: E402
from repro.so3 import s2 as js2  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import quadrature, wigner  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import dwt_fused as dwt_fused_mod  # noqa: E402
from repro_torch.so3 import CorrelationEngine, result_key, s2  # noqa: E402
from repro_torch.so3.correlate import (angle_error, peak_euler,  # noqa: E402
                                       random_rotation)

S2_RTOL, S2_ATOL = 1e-12, 1e-13
RT_RTOL, RT_ATOL = 1e-11, 1e-12
GRID_RTOL = 1e-11
ANGLE_ATOL, PEAK_RTOL = 1e-9, 1e-9


def planted_pair(B, seed):
    """(f, g, true): g random, f = Lambda(true) g."""
    true = random_rotation(seed)
    g = tsoft.random_s2_coeffs(B, seed=seed)
    return s2.rotate_s2_coeffs(g, true), g, true


def engine(B, V):
    return CorrelationEngine(B, lane_width=V, device="cpu")


def recovered(res, true, B):
    return all(angle_error(e, t) < 1.5 * np.pi / B
               for e, t in zip(res.euler, true))


def same_result(a, b):
    """Port and reference MatchResults of the same pair."""
    assert a.index == b.index
    np.testing.assert_allclose(a.euler, b.euler, rtol=0, atol=ANGLE_ATOL)
    np.testing.assert_allclose(a.peak, b.peak, rtol=PEAK_RTOL)
    np.testing.assert_allclose(a.score, b.score, rtol=PEAK_RTOL)


# ---------------------------------------------------------------------------
# tables and seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
def test_legendre_columns_equal_reference(B):
    got = s2.legendre_columns(B)
    assert np.array_equal(got, js2.legendre_columns(B))
    assert not got.flags.writeable and s2.legendre_columns(B) is got


@pytest.mark.parametrize("B", [4, 8, 16])
def test_reduced_march_equals_fundamental_rows(B):
    """The (m, 0) rows marched alone are bit for bit the fundamental
    table's rows m (m + 1) / 2, and the march over every pair is the
    table itself."""
    fund, pairs = wigner.wigner_d_fundamental(B)
    m = np.arange(B)
    rows = wigner.wigner_d_rows(B, np.stack([m, 0 * m], axis=1))
    assert np.array_equal(rows, fund[m * (m + 1) // 2])
    assert np.array_equal(wigner.wigner_d_rows(B, pairs), fund)


@pytest.mark.parametrize("seed", [0, 7])
def test_s2_inputs_equal_reference(seed):
    assert np.array_equal(tsoft.s2_coeff_mask(8), jsoft.s2_coeff_mask(8))
    a = tsoft.random_s2_coeffs(8, seed=seed)
    assert np.array_equal(a, jsoft.random_s2_coeffs(8, seed=seed))
    assert a[~tsoft.s2_coeff_mask(8)].max() == 0
    assert np.abs(a[tsoft.s2_coeff_mask(8)]).min() > 0
    assert random_rotation(seed) == jcorr.random_rotation(seed)


def test_soft_configs_are_the_reference_rows():
    """configs.SOFT_CONFIGS: the reference's soft_b32 .. soft_b512 names
    and bandwidths."""
    from repro.configs import soft as jconfigs
    from repro_torch import configs
    assert {k: c.bandwidth for k, c in configs.SOFT_CONFIGS.items()} == \
        {k: c.bandwidth for k, c in jconfigs.CONFIGS.items()}
    assert all(c.name == k for k, c in configs.SOFT_CONFIGS.items())


# ---------------------------------------------------------------------------
# S^2 transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
def test_s2_transforms_match_reference(B):
    flm = tsoft.random_s2_coeffs(B, seed=3)
    f = s2.s2_synthesis(flm, device="cpu")
    assert f.shape == (2 * B, 2 * B) and f.dtype == torch.complex128
    f_ref = np.asarray(js2.s2_synthesis(flm))
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=S2_RTOL, atol=S2_ATOL)
    back = s2.s2_analysis(f_ref, B, device="cpu")
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(js2.s2_analysis(f_ref, B)),
                               rtol=S2_RTOL, atol=S2_ATOL)
    true = random_rotation(B)
    np.testing.assert_allclose(s2.rotate_s2_coeffs(flm, true),
                               js2.rotate_s2_coeffs(flm, true),
                               rtol=S2_RTOL, atol=S2_ATOL)


@pytest.mark.parametrize("B", [4, 8, 16])
def test_s2_roundtrip(B):
    flm = tsoft.random_s2_coeffs(B, seed=3)
    f = s2.s2_synthesis(flm, device="cpu")
    back = s2.s2_analysis(f, B)                  # stays on f's device
    np.testing.assert_allclose(back.numpy(), flm, rtol=RT_RTOL, atol=RT_ATOL)
    np.testing.assert_allclose(s2.s2_synthesis(back).numpy(), f.numpy(),
                               rtol=RT_RTOL, atol=RT_ATOL)


@pytest.mark.parametrize("B", [4, 8])
def test_s2_synthesis_matches_lifted_so3_oracle(B):
    """An S^2 function is an SO(3) function constant in gamma: the m' = 0
    slice through the port's dense inverse_soft equals s2_synthesis."""
    flm = tsoft.random_s2_coeffs(B, seed=5)
    fhat = np.zeros((B, 2 * B - 1, 2 * B - 1), complex)
    fhat[:, :, B - 1] = flm
    F3 = tsoft.inverse_soft(torch.as_tensor(fhat)).numpy()
    f2 = s2.s2_synthesis(flm, device="cpu").numpy()
    assert np.abs(F3 - F3[:, :, :1]).max() < 1e-12
    np.testing.assert_allclose(F3[:, :, 0], f2, rtol=1e-12, atol=1e-12)


def test_rotate_rejects_beta_outside_open_interval():
    flm = tsoft.random_s2_coeffs(4)
    for bad in (4.0, -0.3, 0.0, np.pi):
        with pytest.raises(ValueError, match="beta"):
            s2.rotate_s2_coeffs(flm, (1.0, bad, 2.0))


def test_s2_needs_a_device_for_host_inputs(monkeypatch):
    """A numpy input goes to the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s2.s2_synthesis(tsoft.random_s2_coeffs(4))


# ---------------------------------------------------------------------------
# correlation grids and matching against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
def test_correlation_grids_match_reference(B):
    pairs = [planted_pair(B, seed=10 + n) for n in range(3)]
    eng = engine(B, 2)
    ref = jcorr.CorrelationEngine(B, lane_width=2, tk=8)
    fs = [eng.as_coeffs(f) for f, _, _ in pairs]
    gs = [eng.as_coeffs(g) for _, g, _ in pairs]
    C = eng.correlation_grids(fs, gs)
    assert C.shape == (3, 2 * B, 2 * B, 2 * B) and C.is_conj()
    want = ref.correlation_grids([ref.as_coeffs(f) for f, _, _ in pairs],
                                 [ref.as_coeffs(g) for _, g, _ in pairs])
    err = np.abs(C.resolve_conj().numpy() - want).max()
    assert err <= GRID_RTOL * np.abs(want).max(), err
    assert eng.stats == dict(launches=2, transforms=3, padded_lanes=1)
    assert eng.correlation_grids([], []).shape == (0,) + (2 * B,) * 3


@pytest.mark.parametrize("B", [4, 8, 16])
def test_match_recovers_hidden_rotation_like_reference(B):
    f, g, true = planted_pair(B, seed=2)
    eng = engine(B, 2)
    res = eng.match(f, g)
    assert recovered(res, true, B), (B, res, true)
    assert eng.stats["launches"] == 1 and eng.stats["padded_lanes"] == 1
    same_result(res, jcorr.CorrelationEngine(B, lane_width=2, tk=8)
                .match(f, g))


def test_match_batch_and_bank_match_reference():
    B = 8
    pairs = [planted_pair(B, seed=20 + n) for n in range(3)]
    eng, ref = engine(B, 2), jcorr.CorrelationEngine(B, lane_width=2, tk=8)
    got = eng.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
    want = ref.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
    for a, b in zip(got, want):
        same_result(a, b)
    bank = [tsoft.random_s2_coeffs(B, seed=30 + i) for i in range(4)]
    query = s2.rotate_s2_coeffs(bank[2], random_rotation(4))
    best, results = eng.match_bank(query, bank)
    best_ref, results_ref = ref.match_bank(query, bank)
    assert best == best_ref == 2
    for a, b in zip(results, results_ref):
        same_result(a, b)


@pytest.mark.parametrize("N", [1, 3, 4])
def test_match_batch_lanes_equal_direct_bitwise(N):
    """Each lane of a packed launch answers its own request, bit for bit
    the result of a one-lane engine."""
    B = 8
    pairs = [planted_pair(B, seed=10 + n) for n in range(N)]
    eng = engine(B, 2)
    results = eng.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
    solo = engine(B, 1)
    for res, (f, g, true) in zip(results, pairs):
        assert result_key(res) == result_key(solo.match(f, g))
        assert recovered(res, true, B)
    assert eng.stats["launches"] == (N + 1) // 2
    assert eng.stats["transforms"] == N


def test_match_bank_picks_planted_template():
    B = 8
    bank = [tsoft.random_s2_coeffs(B, seed=20 + i) for i in range(4)]
    query = s2.rotate_s2_coeffs(bank[2], random_rotation(4))
    eng = engine(B, 4)
    best, results = eng.match_bank(query, bank)
    assert best == 2
    assert results[2].peak > 1.5 * max(r.peak for i, r in enumerate(results)
                                       if i != 2)
    assert eng.stats["launches"] == 1
    with pytest.raises(ValueError, match="empty"):
        eng.match_bank(query, [])


def test_samples_enter_as_raw_grids():
    B = 8
    f, g, _ = planted_pair(B, seed=6)
    eng = engine(B, 1)
    r_coeff = eng.match(f, g)
    r_samp = eng.match(s2.s2_synthesis(f, device="cpu"),
                       s2.s2_synthesis(g, device="cpu").numpy())
    assert r_samp.index == r_coeff.index
    np.testing.assert_allclose(r_samp.peak, r_coeff.peak, rtol=1e-9)


def test_refinement_is_subgrid():
    B = 8
    f, g, true = planted_pair(B, seed=2)
    eng = engine(B, 1)
    coarse = eng.match(f, g, refine=False)
    fine = eng.match(f, g, refine=True)
    assert fine.index == coarse.index
    assert angle_error(fine.alpha, coarse.alpha) <= np.pi / (2 * B) + 1e-12
    assert angle_error(fine.gamma, coarse.gamma) <= np.pi / (2 * B) + 1e-12
    assert abs(fine.beta - coarse.beta) <= np.pi / (4 * B) + 1e-12
    assert coarse.alpha in quadrature.alphas(B)
    assert recovered(fine, true, B)


def test_match_rejects_bad_shapes():
    eng = engine(4, 1)
    with pytest.raises(ValueError, match="expected S\\^2"):
        eng.match(np.zeros((3, 3)), tsoft.random_s2_coeffs(4))
    with pytest.raises(ValueError, match="queries"):
        eng.match_batch([tsoft.random_s2_coeffs(4)] * 2,
                        [tsoft.random_s2_coeffs(4)])


@pytest.mark.parametrize("kwargs, match", [
    (dict(tk=4), "tk=4"), (dict(lane_width=0), "lane_width"),
    (dict(), "needs B")])
def test_engine_rejects_bad_config(kwargs, match):
    B = None if not kwargs else 8
    with pytest.raises(ValueError, match=match):
        CorrelationEngine(B, device="cpu", **kwargs)


def test_engine_mesh_raises_not_ported(tmp_path):
    """CorrelationEngine(mesh=): without a process group it raises (a
    mesh plan never runs locally); on a one-rank gloo mesh it matches
    planted pairs through the sharded inverse, every result_key equal to
    the local V = 1 engine's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with pytest.raises(RuntimeError, match="process group"):
        CorrelationEngine(8, device="cpu", mesh=object())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        eng = CorrelationEngine(8, lane_width=2, device="cpu", mesh=mesh,
                                axis=("data",))
        assert eng.transform.mesh is mesh and eng.transform.n_shards == 1
        pairs = [planted_pair(8, seed=70 + n) for n in range(3)]
        got = eng.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
        assert eng.stats["launches"] == 2
        ref = engine(8, 1)
        for res, (f, g, true) in zip(got, pairs):
            assert recovered(res, true, 8)
            assert result_key(res) == result_key(ref.match(f, g))
    finally:
        tplan.clear_cache()
        dist.destroy_process_group()


def test_correlation_runs_one_fused_launch_per_group(monkeypatch):
    """One match_batch of 3 requests on 3 lanes = ONE idwt_fused call
    whose lane axis carries V*C*2 = 3*8*2 columns."""
    calls = []
    orig = dwt_fused_mod.idwt_fused

    def spy(seeds, m, mp, cos_beta, lhs, l0s, **kw):
        calls.append(tuple(lhs.shape))
        return orig(seeds, m, mp, cos_beta, lhs, l0s, **kw)

    tplan.clear_cache()                  # the plan binds the kernel lazily
    monkeypatch.setattr(dwt_fused_mod, "idwt_fused", spy)
    try:
        B, V = 8, 3
        eng = engine(B, V)
        pairs = [planted_pair(B, seed=30 + n) for n in range(V)]
        eng.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
    finally:
        tplan.clear_cache()
    assert calls == [calls[0]] and calls[0][-1] == V * 8 * 2
    assert eng.impl == "fused"


# ---------------------------------------------------------------------------
# peak_euler: the device-side argmax + stencil against the numpy reference
# ---------------------------------------------------------------------------

def _grids(B):
    n = 2 * B
    rng = np.random.default_rng(B)
    base = rng.normal(size=(n, n, n)) + 1j * rng.normal(size=(n, n, n))
    tie = base.copy()
    tie.real[3, 4, 5] = tie.real[6, 1, 2] = base.real.max() + 1.0
    edge_lo, edge_hi = base.copy(), base.copy()
    edge_lo.real[2, 0, 7] = base.real.max() + 1.0      # beta edge j = 0
    edge_hi.real[0, n - 1, n - 1] = base.real.max() + 1.0
    ii, jj, kk = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    di = (ii - 5 - 0.3 + n / 2) % n - n / 2
    bump = np.exp(-0.5 * (di ** 2 + (jj - 7) ** 2 + (kk - 11) ** 2))
    return {"random": base, "tie": tie, "beta_edge_0": edge_lo,
            "beta_edge_last": edge_hi, "bump": bump.astype(complex)}


@pytest.mark.parametrize("name", ["random", "tie", "beta_edge_0",
                                  "beta_edge_last", "bump"])
@pytest.mark.parametrize("refine", [True, False])
def test_peak_euler_equals_reference(name, refine):
    B = 8
    C = _grids(B)[name]
    want = jcorr.peak_euler(np.conj(C), B, refine=refine, norm=3.0)
    # the engine's grids are lazy conjugate views; a resolved one and a
    # numpy one give the same result
    for got in (torch.as_tensor(C).conj(),
                torch.as_tensor(np.conj(C)), np.conj(C)):
        res = peak_euler(got, B, refine=refine, norm=3.0)
        assert result_key(res) == result_key(want)
    if name == "tie":
        assert want.index == (3, 4, 5)          # the first maximum wins
