"""The summation schedules of the table inverse (csrc/dwt_dense.cu,
idwt_dense) emulated on the CPU, against the reference package.

f64 runs dense_dmma<WN, true, false> on the FP64 tensor cores with
mma.sync.m16n8k4, one mma being, bit for bit, the ascending chain
acc = fma(a_k, b_k, acc) over its k (PERF.md §6); f32 runs dense_inv_f32,
a register-blocked body on the FP32 FMA pipes.  This file models both
exactly, with the exact fma of test_torch_dwt_block (and its float32
counterpart :func:`fma32`):

  * the grid: a block per (cluster, row tile of BR j, lane tile of BC),
    lanes fastest; the block stages the table chunk As[l][j] (16 l by BR
    j, as it lies in d) and the lhs chunk Bs[l][c], stage after stage of
    KC l in ascending order, zero past L, J and C2;
  * f64: one accumulator per output chained from +0 over ascending
    k-steps of 4 l, the A operand of (row j, index l) read as As[l][j];
  * f32: thread (ty, tx) owns rows 4 ty + i and BR / 2 + 4 ty + i (i < 4)
    and lanes 4 tx + q (q < 4), and adds a(l, j) * b(l, c) into each of
    its 32 registers once per l, ascending, from +0;
  * rows past J and lanes past C2 are not stored.

The emulations must equal a plain ascending-fma-chain reference bit for
bit at the kernels' tiles and at another (the tile changes no bit), give
lane k of a V-lane launch the single transform's bits, and stay within
rtol 1e-11 (f64) or FP32_ROUNDTRIP_BOUNDS (f32) of the JAX package's
Pallas idwt_dense (interpret mode) on the lhs that _gather_coeffs makes
(zero below each cluster's m).  The kernel computes every l of that lhs,
as the Pallas kernel does: no row l < m is skipped."""
import functools
from fractions import Fraction

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jb  # noqa: E402
from repro.core import soft as jsoft  # noqa: E402
from repro.kernels import dwt as jdwt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import autotune  # noqa: E402

from test_torch_dwt_block import _round_odd_sum, fma, mma_step  # noqa: E402

TK = 8
RTOL = 1e-11
MMA_K = 4
# the kernels' tiles: 128 j rows, ring stages of 16 l, lanes by C2
KERNEL_TILE = dict(br=128, kc=16, bc=None)
OTHER_TILE = dict(br=32, kc=8, bc=16)
NDT = {"f64": np.float64, "f32": np.float32}


def kernel_lanes(C2: int) -> int:
    """The lane tile both inverse bodies launch for C2."""
    return 16 if C2 <= 16 else 64


def fma32(a, b, c):
    """Elementwise fmaf: a * b + c of float32 values rounded once to
    float32.  The product of two floats is exact in float64; their sum
    with c rounded to odd in float64, then to float32, is rounded once
    (53 >= 24 + 2 bits; Boldo & Melquiond)."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64)
               for x in np.broadcast_arrays(a, b, c))
    return _round_odd_sum(a * b, c).astype(np.float32)


def _nearest_f32(q: Fraction) -> np.float32:
    """q rounded to the nearest float32, ties to even."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - q),
                                     int(x.view(np.int32)) & 1))


def test_fma32_emulation_is_correctly_rounded():
    rng = np.random.default_rng(1)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 21, n)) \
        .astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 21, n)) \
        .astype(np.float32)
    c = np.concatenate([
        rng.standard_normal(n // 2) * 2.0 ** rng.integers(-40, 41, n // 2),
        -(a[n // 2:].astype(np.float64) * b[n // 2:])
        * (1 + rng.integers(-4, 5, n // 2) * 2.0 ** -23)]).astype(np.float32)
    a[:100], c[100:200] = 0.0, 0.0                   # zero operands
    got = fma32(a, b, c)
    want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    assert not np.array_equal(a * b + c, want)       # the test can fail


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def blocks(K, J, C2, *, br, bc):
    """The kernels' blocks in grid order (lanes fastest, then row tiles,
    then clusters): (cluster, r0, c0)."""
    return [(k, rt * br, ct * bc) for k in range(K)
            for rt in range(-(-J // br)) for ct in range(-(-C2 // bc))]


def staged(d, lhs, blk, *, br, bc, kc):
    """Every stage of every block, concatenated along l: the table
    chunks As[l][j] (nb, lp, br) and lhs chunks Bs[l][c] (nb, lp, bc),
    zero past L, J and C2 (lp: L rounded up to whole stages)."""
    K, L, J = d.shape
    C2 = lhs.shape[-1]
    k, r0, c0 = (np.array(x) for x in zip(*blk))
    lp = -(-L // kc) * kc
    l = np.arange(lp)
    j = r0[:, None] + np.arange(br)                   # (nb, br)
    c = c0[:, None] + np.arange(bc)                   # (nb, bc)
    a = np.where((l < L)[None, :, None] & (j < J)[:, None, :],
                 d[k[:, None, None], np.minimum(l, L - 1)[None, :, None],
                   np.minimum(j, J - 1)[:, None, :]], 0)
    b = np.where((l < L)[None, :, None] & (c < C2)[:, None, :],
                 lhs[k[:, None, None], np.minimum(l, L - 1)[None, :, None],
                     np.minimum(c, C2 - 1)[:, None, :]], 0)
    return a.astype(d.dtype), b.astype(lhs.dtype)


def store(acc, blk, K, J, C2, rows, lanes, dtype):
    """g (K, J, C2), NaN where no block stores: acc[i, ..., rows, lanes]
    of block i lands at (its cluster, r0 + rows, c0 + lanes), rows past
    J and lanes past C2 dropped."""
    out = np.full((K, J, C2), np.nan, dtype)
    for i, (k, r0, c0) in enumerate(blk):
        j, c = r0 + rows, c0 + lanes
        ok = (j < J) & (c < C2)
        out[k, j[ok], c[ok]] = acc[i][ok]
    return out


def emulate_f64(d, lhs, *, br, kc, bc=None):
    """dense_dmma's inverse on numpy f64 arrays."""
    K, L, J = d.shape
    C2 = lhs.shape[-1]
    bc = bc or kernel_lanes(C2)
    blk = blocks(K, J, C2, br=br, bc=bc)
    a, b = staged(d, lhs, blk, br=br, bc=bc, kc=kc)
    acc = np.zeros((len(blk), br, bc))
    for s in range(0, a.shape[1], kc):                # ring stages, ascending
        for k0 in range(s, s + kc, MMA_K):            # mma k-steps, ascending
            # A[j][l] = As[l][j]; B[l][c] = Bs[l][c]
            acc = mma_step(acc,
                           np.swapaxes(a[:, k0:k0 + MMA_K], 1, 2)[:, :, None],
                           np.swapaxes(b[:, k0:k0 + MMA_K], 1, 2)[:, None])
    rows, lanes = np.meshgrid(np.arange(br), np.arange(bc), indexing="ij")
    return store(acc, blk, K, J, C2, rows, lanes, np.float64)


def micro_tiles(br, bc):
    """The f32 body's thread micro-tiles: rows (TY, 2, 4) -- 4 ty + i and
    br / 2 + 4 ty + i -- and lanes (TX, 4) -- 4 tx + q."""
    ty, i = np.arange(br // 8)[:, None, None], np.arange(4)
    rows = 4 * ty + np.array([0, br // 2])[None, :, None] + i
    lanes = 4 * np.arange(bc // 4)[:, None] + np.arange(4)
    return rows, lanes


def emulate_f32(d, lhs, *, br, kc, bc=None):
    """dense_inv_f32 on numpy f32 arrays: per thread an 8 x 4 register
    tile, one fmaf a register per l, l ascending."""
    K, L, J = d.shape
    C2 = lhs.shape[-1]
    bc = bc or kernel_lanes(C2)
    blk = blocks(K, J, C2, br=br, bc=bc)
    a, b = staged(d, lhs, blk, br=br, bc=bc, kc=kc)
    rows, lanes = micro_tiles(br, bc)
    # acc[block, ty, tx, half, i, q]
    acc = np.zeros((len(blk),) + rows.shape[:1] + lanes.shape[:1] + (2, 4, 4),
                   np.float32)
    for s in range(0, a.shape[1], kc):                # ring stages, ascending
        for t in range(s, s + kc):                    # l, ascending
            av = a[:, t][:, rows]                     # (nb, TY, 2, 4)
            bv = b[:, t][:, lanes]                    # (nb, TX, 4)
            acc = fma32(av[:, :, None, :, :, None],
                        bv[:, None, :, None, None, :], acc)
    r = np.broadcast_to(rows[:, None, :, :, None], acc.shape[1:])
    c = np.broadcast_to(lanes[None, :, None, None, :], acc.shape[1:])
    return store(acc, blk, K, J, C2, r, c, np.float32)


EMULATE = {"f64": emulate_f64, "f32": emulate_f32}


def chain(d, lhs):
    """The plain reference: each g[k, j, c] one fma chain over l
    ascending, from +0, in the input dtype."""
    K, L, J = d.shape
    f = fma32 if d.dtype == np.float32 else fma
    acc = np.zeros((K, J, lhs.shape[-1]), d.dtype)
    for l in range(L):
        acc = f(d[:, l, :, None], lhs[:, l, None, :], acc)
    return acc


@functools.lru_cache(maxsize=None)
def _plan(B):
    """The reference plan (K padded to TK) and its f64 table."""
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=TK)
    return jp, np.asarray(jp.d, np.float64)


def _inputs(B, V, dt, seed):
    """The table and an lhs as _gather_coeffs makes it (zero below each
    cluster's m), in dtype dt."""
    jp, d = _plan(B)
    lhs = np.asarray(jops.pack_lanes(jnp.stack(
        [jb._gather_coeffs(jp, jnp.asarray(jsoft.random_coeffs(B, seed + v)))
         for v in range(V)])))
    return d.astype(NDT[dt]), lhs.astype(NDT[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("tile", ["kernel", "other"])
def test_emulation_equals_fma_chain(dt, B, V, tile):
    d, lhs = _inputs(B, V, dt, seed=B + V)
    assert (np.abs(lhs).sum(-1) == 0).any()          # zero rows below m
    got = EMULATE[dt](d, lhs,
                      **(KERNEL_TILE if tile == "kernel" else OTHER_TILE))
    assert got.dtype == NDT[dt]
    assert np.array_equal(got, chain(d, lhs))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("B", [4, 8, 16])
def test_lane_equals_single_transform(dt, B):
    d, lhs = _inputs(B, 3, dt, seed=B)
    got = EMULATE[dt](d, lhs, **KERNEL_TILE)
    for k in range(3):
        grp = np.ascontiguousarray(lhs[..., 16 * k:16 * k + 16])
        assert np.array_equal(got[..., 16 * k:16 * k + 16],
                              EMULATE[dt](d, grp, **KERNEL_TILE))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
def test_emulation_matches_reference_kernel(dt, B, V):
    """Within rtol 1e-11 (f64) or the reference's FP32_ROUNDTRIP_BOUNDS
    (f32, relative to the largest output) of the Pallas idwt_dense
    (interpret mode), whose sums XLA orders otherwise."""
    d, lhs = _inputs(B, V, dt, seed=B + 2 * V)
    J = d.shape[2]
    want = np.asarray(jdwt.idwt_dense(d, lhs, tk=TK, tl=B, tj=J,
                                      interpret=True))
    got = EMULATE[dt](d, lhs, **KERNEL_TILE)
    scale = np.abs(want).max()
    if dt == "f64":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    else:
        assert np.abs(got.astype(np.float64) - want).max() <= \
            autotune.FP32_ROUNDTRIP_BOUNDS[max(B, 8)] * scale


@pytest.mark.parametrize("bc", [16, 64])
def test_f32_micro_tiles_cover_the_block_once(bc):
    """Every (row, lane) of a 128 x bc block is in exactly one thread's
    8 x 4 tile, and a thread's float4 reads are aligned quads."""
    rows, lanes = micro_tiles(128, bc)
    assert rows.shape == (16, 2, 4) and lanes.shape == (bc // 4, 4)
    assert np.array_equal(np.sort(rows.ravel()), np.arange(128))
    assert np.array_equal(np.sort(lanes.ravel()), np.arange(bc))
    assert (rows[..., 0] % 4 == 0).all() and (lanes[:, 0] % 4 == 0).all()
    assert 16 * (bc // 4) == (256 if bc == 64 else 64)   # threads a block


def test_inverse_shared_memory_rule():
    """The inverses' rings: 3 stages of a 16 x BR table chunk and a
    16 x BC lhs chunk, the same for every span; f64 rows padded by 4
    doubles, f32 rows unpadded."""
    for C2, bc in ((16, 16), (32, 64), (48, 64), (128, 64)):
        assert kernel_lanes(C2) == bc
        for span in (2, 16, 128, 256):
            assert autotune.dense_smem_bytes(span, C2, 8, inverse=True) == \
                8 * 3 * (16 * (128 + 4) + 16 * (bc + 4))
            assert autotune.dense_smem_bytes(span, C2, 4, inverse=True) == \
                4 * 3 * 16 * (128 + bc)
    # two f64 blocks and three f32 blocks an SM fit
    assert 2 * autotune.dense_smem_bytes(256, 128, 8, inverse=True) \
        <= autotune.SMEM_LIMIT_BYTES
    assert 3 * autotune.dense_smem_bytes(128, 128, 4, inverse=True) \
        <= autotune.SMEM_LIMIT_BYTES
