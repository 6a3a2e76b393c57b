"""The summation schedule of the f64 recurrence block (csrc/dwt_block.cuh)
emulated on the CPU, against the reference package.

On the card the f64 block contracts on the FP64 tensor cores with
mma.sync.m16n8k4, and one such mma is, bit for bit, the ascending chain
acc = fma(a_k, b_k, acc) over its k (PERF.md §6).  This file models
that schedule exactly:

  * forward: warp w's partial out[l, c] is the chain over its 32 j in
    ascending order (8 mma k-steps of 4), from +0; the block adds the
    partials of its warps in ascending order, from +0;
  * inverse: g[j, c] is one chain over the degrees the block visits, in
    rounds of kMT = 16 degrees (4 mma k-steps each) from where the march
    starts: 0 (on-the-fly), the cluster's first degree (fused), or each
    l-chunk's start (streaming, one round sequence per chunk); a round
    past the range is padded with zero rows and zero lhs, fma(0, 0, acc).

Rows come from the port's recurrence twin (which the card's step matches
bit for bit), the streaming ones resumed from the window stack.  Python
3.12 has no math.fma: :func:`fma` emulates it with error-free
transformations and round-to-odd (Boldo & Melquiond, IEEE TC 2008), and
:func:`test_fma_emulation_is_correctly_rounded` holds it to
fractions.Fraction, whose float() rounds correctly.  The emulated
schedules must agree bit for bit (on-the-fly == fused == streaming at
every lchunk; lane k == the single transform) and stay within rtol 1e-11
of the JAX package's Pallas kernels (interpret mode) and of the direct
contraction with its dense Wigner table."""
import functools
from fractions import Fraction

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jb  # noqa: E402
from repro.kernels import dwt_fused as jdf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dwt_fused as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import streaming as tst  # noqa: E402
from repro_torch.kernels.wigner_rec import recurrence_step  # noqa: E402

TK = 4
WARP, MT, MMA_K = 32, 16, 4
RTOL = 1e-11


# ---------------------------------------------------------------------------
# fma, exactly
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    sa, sb = 134217729.0 * a, 134217729.0 * b      # Veltkamp, 2**27 + 1
    ah, bh = sa - (sa - a), sb - (sb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a, b):
    """a + b rounded to odd: RN's result where exact, else the neighbour
    of the exact sum whose last significand bit is 1."""
    s, e = _two_sum(a, b)
    even = (s.view(np.int64) & 1) == 0
    step = np.nextafter(s, np.where(e > 0, np.inf, -np.inf))
    return np.where((e != 0) & even, step, s)


def fma(a, b, c):
    """Elementwise a * b + c rounded once (float64 arrays, no overflow or
    underflow): uh + ul = a b and th + tl = c + uh exactly, then
    RN(th + RO(tl + ul))."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64)
                                    for x in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_odd_sum(tl, ul)


def mma_step(acc, a, b):
    """One m16n8k4 k-step as the card computes it: the ascending chain of
    fused multiply-adds over its k (a[..., k] b[..., k])."""
    for k in range(a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc)
    return acc


def test_fma_emulation_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 4000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 31, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 31, n)
    c = np.concatenate([
        rng.standard_normal(n // 2) * 2.0 ** rng.integers(-60, 61, n // 2),
        -(a[n // 2:] * b[n // 2:]) * (1 + rng.integers(-4, 5, n // 2)
                                      * 2.0 ** -52)])   # near cancellation
    a[:200], c[200:400] = 0.0, 0.0                     # zero operands
    got = fma(a, b, c)
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)
    assert not np.array_equal(a * b + c, want)   # the test can fail


# ---------------------------------------------------------------------------
# the block's schedule
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(B):
    """Identical kernel inputs for both packages (f64), clusters in the
    l-start-sorted launch order, and the direct (dense) Wigner table."""
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=TK)
    seeds, m, mp, cb = (np.asarray(x) for x in jops.onthefly_inputs(jp))
    perm, _, l0s = jops.fused_metadata(jp, TK)
    tin = tops.onthefly_inputs_from_arrays(seeds[perm], m[perm], mp[perm],
                                           cb, device="cpu")
    return dict(jax=(seeds[perm], m[perm], mp[perm], cb), torch=tin,
                l0s=l0s, d=np.asarray(jp.d)[perm])


def _operands(B, V):
    inp = _inputs(B)
    K, J = inp["jax"][0].shape
    rng = np.random.default_rng(100 * B + V)
    rhs = rng.normal(size=(K, J, V * 16)) * 0.3
    lhs = rng.normal(size=(K, B, V * 16))
    lhs *= (np.arange(B)[None, :] >= inp["jax"][1][:, None])[..., None]
    return rhs, lhs


@functools.lru_cache(maxsize=None)
def _reference(B, V):
    """The Pallas kernels (interpret mode) and the direct contraction."""
    inp = _inputs(B)
    rhs, lhs = _operands(B, V)
    l0s = inp["l0s"]
    return dict(
        fwd=np.asarray(jdf.dwt_fused(*inp["jax"], rhs, l0s, B=B, tk=TK,
                                     interpret=True)),
        inv=np.asarray(jdf.idwt_fused(*inp["jax"], lhs, l0s, B=B, tk=TK,
                                      interpret=True)),
        fwd_direct=np.asarray(jref.dwt_ref(inp["d"], rhs)),
        inv_direct=np.asarray(jref.idwt_ref(inp["d"], lhs)))


def _first_degrees(B, every):
    """Where each cluster's march starts: 0 (on-the-fly), else its m when
    m >= its tile's l0, else B (never seeded)."""
    inp = _inputs(B)
    m = inp["jax"][1].astype(np.int64)
    if every:
        return np.zeros_like(m)
    l0 = np.repeat(inp["l0s"].astype(np.int64), TK)[: len(m)]
    return np.where(m >= l0, m, B)


def _rows(B, lchunk=None):
    """(K, B, nj) Wigner rows as the block generates them, j padded with
    zeros to whole warps: one march from a zero state, or (lchunk) each
    chunk resumed from the window stack."""
    seeds, m, mp, cb = _inputs(B)["torch"]
    K, J = seeds.shape
    mf, mpf, cbf = m.double()[:, None], mp.double()[:, None], cb[None, :]
    win = None if lchunk is None else tst.build_windows_plain(
        seeds, m, mp, cb, L=B, lchunk=lchunk)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    rows = np.zeros((K, B, -(-J // WARP) * WARP))
    for l in range(B):
        if win is not None and l % lchunk == 0:
            d_prev, d_cur = win[l // lchunk, 0], win[l // lchunk, 1]
        row, d_prev, d_cur = recurrence_step(l, mf, mpf, cbf, d_prev, d_cur,
                                             seeds)
        rows[:, l, :J] = row.numpy()
    return rows


def _emulated_forward(rows, rhs, visited):
    """out[k, l, c]: warp partials chained over ascending j in mma
    k-steps, added across warps in ascending order; rows the block does
    not visit are written as +0."""
    K, L, nj = rows.shape
    rhs = np.concatenate([rhs, np.zeros((K, nj - rhs.shape[1],
                                         rhs.shape[2]))], axis=1)
    out = np.zeros((K, L, rhs.shape[2]))
    for w in range(nj // WARP):
        part = np.zeros_like(out)
        for j0 in range(w * WARP, (w + 1) * WARP, MMA_K):
            a = rows[:, :, None, j0:j0 + MMA_K]                  # (K, L, 1, k)
            b = np.moveaxis(rhs[:, j0:j0 + MMA_K, :], 1, 2)[:, None]
            part = mma_step(part, a, b)
        out = out + part
    return np.where(visited[..., None], out, 0.0)


def _degree_slots(lbeg, B, lchunk):
    """The degree each of a cluster's mma k-slots reads, in order: rounds
    of MT from each range's start, padded with -1 (zero row and lhs)."""
    ranges = [(lbeg, B)] if lchunk is None else [
        (max(lbeg, base), base + lchunk)
        for base in range(lbeg // lchunk * lchunk, B, lchunk)]
    slots = []
    for lo, hi in ranges:
        for lb in range(lo, hi, MT):
            slots += [lb + t if lb + t < hi else -1 for t in range(MT)]
    return slots


def _emulated_inverse(rows, lhs, lbeg, lchunk=None):
    """g[k, j, c]: one chain per cluster over its degree slots, MMA_K of
    them per mma k-step; a cluster past its last slot adds nothing."""
    K, B, nj = rows.shape
    seqs = [_degree_slots(int(lb), B, lchunk) for lb in lbeg]
    n = max(map(len, seqs), default=0)
    deg = np.array([s + [-2] * (n - len(s)) for s in seqs]).reshape(K, n)
    acc = np.zeros((K, nj, lhs.shape[2]))
    kk = np.arange(K)[:, None]
    for s0 in range(0, n, MMA_K):
        d = deg[:, s0:s0 + MMA_K]                                  # (K, k)
        a = np.where((d >= 0)[:, None, :],
                     np.moveaxis(rows[kk, d.clip(0)], 1, 2), 0.0)  # (K, nj, k)
        b = np.where((d >= 0)[:, None, :],
                     np.moveaxis(lhs[kk, d.clip(0)], 1, 2), 0.0)   # (K, C2, k)
        acc = np.where((d[:, 0] > -2)[:, None, None],
                       mma_step(acc, a[:, :, None, :], b[:, None, :, :]), acc)
    return acc


def _visited(B, lbeg, lchunk=None):
    del lchunk          # every chunk writes its own rows: the same set
    return np.arange(B)[None, :] >= lbeg[:, None]


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("lchunk", [1, 2, "B"])
def test_emulated_schedule(B, V, lchunk):
    lc = B if lchunk == "B" else lchunk
    J = 2 * B
    rhs, lhs = _operands(B, V)
    rows, rows_chunked = _rows(B), _rows(B, lc)
    every, first = _first_degrees(B, True), _first_degrees(B, False)
    fwd = {"onthefly": _emulated_forward(rows, rhs, _visited(B, every)),
           "fused": _emulated_forward(rows, rhs, _visited(B, first)),
           "streaming": _emulated_forward(rows_chunked, rhs,
                                          _visited(B, first, lc))}
    inv = {"onthefly": _emulated_inverse(rows, lhs, every),
           "fused": _emulated_inverse(rows, lhs, first),
           "streaming": _emulated_inverse(rows_chunked, lhs, first, lc)}
    for got in (fwd, inv):
        assert np.array_equal(got["onthefly"], got["fused"])
        assert np.array_equal(got["streaming"], got["fused"])
    fwd, inv = fwd["fused"], inv["fused"][:, :J]
    # lane k of the batch == the single transform on lane k's operands
    for k in range(V):
        lanes = slice(16 * k, 16 * k + 16)
        assert np.array_equal(
            _emulated_forward(rows, rhs[..., lanes], _visited(B, first)),
            fwd[..., lanes])
        assert np.array_equal(
            _emulated_inverse(rows, lhs[..., lanes], first)[:, :J],
            inv[..., lanes])
    ref = _reference(B, V)
    for got, want in ((fwd, ref["fwd"]), (fwd, ref["fwd_direct"]),
                      (inv, ref["inv"]), (inv, ref["inv_direct"])):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    # the ragged skip writes exact zeros
    for g, l0 in enumerate(_inputs(B)["l0s"]):
        assert not fwd[g * TK:(g + 1) * TK, :l0].any()


def test_emulated_schedule_equals_plain_version_within_tolerance():
    """The port's plain fused versions (einsum sums) and the emulated
    block differ only in summation order: within the reference's f64
    kernel tolerance (rtol 1e-10, atol 1e-11)."""
    B, V = 16, 3
    inp = _inputs(B)
    rhs, lhs = _operands(B, V)
    l0s = torch.as_tensor(inp["l0s"])
    first = _first_degrees(B, False)
    rows = _rows(B)
    np.testing.assert_allclose(
        _emulated_forward(rows, rhs, _visited(B, first)),
        tdf.dwt_fused(*inp["torch"], torch.as_tensor(rhs), l0s, B=B,
                      tk=TK).numpy(), rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(
        _emulated_inverse(rows, lhs, first)[:, :2 * B],
        tdf.idwt_fused(*inp["torch"], torch.as_tensor(lhs), l0s, B=B,
                       tk=TK).numpy(), rtol=1e-10, atol=1e-11)


def test_lane_slice_and_shared_memory_rule():
    """f64 blocks take 32 lanes, 16 when C2 <= 16, 8 in the 1024-thread
    forward; the f64 inverse splits J > 512 into blocks of 512 threads;
    f32 blocks take 32 lanes and one thread per j.  Every f64 block up to
    J = 1024 fits Hopper's 227 KB with its rows double buffered up to 512
    threads, two 256-thread blocks fit one SM (228 KB), and the f32
    figure is the scalar body's (kLT = 8 rows, per-warp partial sums or
    staged lhs rows, kLT coefficient triples)."""
    assert [autotune.lane_slice(256, c2, 8) for c2 in (16, 48, 128)] == \
        [16, 32, 32]
    assert autotune.lane_slice(1024, 16, 8) == 8
    assert autotune.lane_slice(1024, 128, 8, inverse=True) == 32
    assert {autotune.lane_slice(J, c2, 4, inverse=inv) for J in (8, 256, 1024)
            for c2 in (16, 128) for inv in (False, True)} == {32}
    assert [autotune.block_threads(J, 8, inverse=True)
            for J in (8, 256, 1024)] == [32, 256, 512]
    assert autotune.block_threads(1024, 8, inverse=False) == 1024
    assert autotune.block_threads(1024, 4, inverse=True) == 1024
    for J in (8, 256, 512, 1024):
        nj = -(-J // 32) * 32
        for inverse in (False, True):
            nt = autotune.block_threads(J, 8, inverse=inverse)
            bufs = 2 if nt <= 512 else 1
            for C2 in (16, 128):
                f64 = autotune.estimate_smem_bytes(J, 8, inverse=inverse,
                                                   C2=C2)
                cs = autotune.lane_slice(J, C2, 8, inverse=inverse)
                other = 32 * (cs + 4) if inverse else \
                    (nt // 32 * 16 * (cs + 2) if nt <= 512 else nt * cs)
                assert f64 == 8 * (bufs * 16 * (nt + 4) + other) \
                    + 24 * (J // 2)
                assert f64 <= autotune.SMEM_LIMIT_BYTES
                assert autotune.estimate_smem_bytes(
                    J, 8, inverse=inverse, C2=C2, L=4) == \
                    f64 - 24 * (J // 2 - 4)
            f32 = autotune.estimate_smem_bytes(J, 4, inverse=inverse)
            assert f32 == 4 * (8 * nj + (8 * 32 if inverse
                                         else nj // 32 * 8 * 32)) + 12 * 8
    assert 2 * (autotune.estimate_smem_bytes(256, 8, inverse=False) + 1024) \
        <= 233472
