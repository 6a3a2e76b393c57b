"""The summation schedule of the f64 table forward on the FP64 tensor
cores (csrc/dwt_dense.cu, dense_dmma) emulated on the CPU, against
the reference package.

On the card the f64 dwt_dense / dwt_ragged contract with
mma.sync.m16n8k4, and one such mma is, bit for bit, the ascending chain
acc = fma(a_k, b_k, acc) over its k (PERF.md §6).  This file models the
kernel's schedule exactly, with the exact fma of test_torch_dwt_block:

  * the grid: a block per (unit, row tile, lane tile), lanes fastest;
    a unit is a launch cluster (dense) or a (work-list entry, cluster of
    its tile) pair (ragged), and a ragged unit works only where its entry
    starts a run of consecutive l-tiles of one cluster tile, over the
    rows of the whole run, the row tile anchored at the run's first row;
  * a block tile of BR rows by BC lanes, stages of KC j, k-steps of 4 in
    ascending j, the table and rhs zero past J, the run's end and C2, one
    accumulator per output chained from +0; rows past the run and lanes
    past C2 are not stored.

The emulation must equal a plain ascending-fma-chain reference bit for
bit at the kernel's tile and at another (the tile changes no bit), give
lane k of a V-lane launch the single transform's bits, give the ragged
forward the dense forward's bits on every row its work list visits and
leave the others unwritten, for any work list, and stay within rtol 1e-11
of the JAX package's Pallas kernels (interpret mode)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jb  # noqa: E402
from repro.kernels import dwt as jdwt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dwt as tdwt  # noqa: E402

from test_torch_dwt_block import fma, mma_step  # noqa: E402

TK = 8
RTOL = 1e-11
MMA_K = 4
# the kernel's tile: 128 rows, ring stages of 16 j, lanes by C2 (pick_dmma)
KERNEL_TILE = dict(br=128, kc=16, bc=None)
OTHER_TILE = dict(br=32, kc=8, bc=16)


def kernel_lanes(C2: int) -> int:
    """The lane tile pick_dmma launches for C2."""
    return 16 if C2 <= 16 else 64


def runs(kk, ll):
    """{entry g: run length} for every entry that starts a run, as
    dense_dmma finds them: g starts a run unless entry g - 1 names the
    same cluster tile and the l-tile before; the run goes on while the
    entries name that tile and the next l-tiles."""
    G, out = len(kk), {}
    for g in range(G):
        if g > 0 and kk[g - 1] == kk[g] and ll[g - 1] + 1 == ll[g]:
            continue
        n = 1
        while g + n < G and kk[g + n] == kk[g] and ll[g + n] == ll[g] + n:
            n += 1
        out[g] = n
    return out


def blocks(K, L, C2, *, br, bc, work=None, tk=TK, tl=None, perm=None):
    """The kernel's working blocks, grid order: (row, r0, rend, c0) with
    row the table / rhs / out row it reads and writes."""
    nC, nR = -(-C2 // bc), -(-L // br)
    if work is None:
        units = [(k, 0, L) for k in range(K)]
    else:
        kk, ll = work
        starts = runs(kk, ll)
        units = []
        for u in range(len(kk) * tk):
            g = u // tk
            if g not in starts:
                continue                      # inside a run: exits at once
            units.append((kk[g] * tk + u % tk, ll[g] * tl,
                          min((ll[g] + starts[g]) * tl, L)))
    out = []
    for kl, rbeg, rend in units:
        row = kl if perm is None else int(perm[kl])
        for rt in range(nR):
            r0 = rbeg + rt * br
            if r0 >= rend:
                continue
            out += [(row, r0, rend, ct * bc) for ct in range(nC)]
    return out


def emulate(d, rhs, *, br, kc, bc=None, work=None, tk=TK, tl=None,
            perm=None):
    """dense_dmma's forward on numpy f64 arrays; rows it does not write are
    NaN."""
    K, L, J = d.shape
    C2 = rhs.shape[-1]
    bc = bc or kernel_lanes(C2)
    out = np.full((K, L, C2), np.nan)
    blk = blocks(K, L, C2, br=br, bc=bc, work=work, tk=tk, tl=tl, perm=perm)
    if not blk:
        return out
    rows, r0s, rends, c0s = (np.array(x) for x in zip(*blk))
    jp = -(-J // kc) * kc                     # whole stages, zero past J
    nr = min(br, L)                           # rows past L are never stored
    r = r0s[:, None] + np.arange(nr)          # (nb, nr)
    c = c0s[:, None] + np.arange(bc)          # (nb, bc)
    j = np.arange(jp)
    ok_r = r < rends[:, None]
    ok_c = c < C2
    a = np.where(ok_r[:, :, None] & (j < J),
                 d[rows[:, None, None], np.minimum(r, L - 1)[:, :, None],
                   np.minimum(j, J - 1)], 0.0)             # (nb, nr, jp)
    b = np.where((j < J)[None, :, None] & ok_c[:, None, :],
                 rhs[rows[:, None, None], np.minimum(j, J - 1)[None, :, None],
                     np.minimum(c, C2 - 1)[:, None, :]], 0.0)  # (nb, jp, bc)
    acc = np.zeros((len(blk), nr, bc))
    for s in range(0, jp, kc):                # ring stages, ascending
        for k0 in range(s, s + kc, MMA_K):    # mma k-steps, ascending
            acc = mma_step(acc, a[:, :, None, k0:k0 + MMA_K],
                           np.swapaxes(b[:, k0:k0 + MMA_K, :], 1, 2)[:, None])
    for i, (row, r0, rend, c0) in enumerate(blk):
        nrow, ncol = min(nr, rend - r0), min(bc, C2 - c0)
        out[row, r0:r0 + nrow, c0:c0 + ncol] = acc[i, :nrow, :ncol]
    return out


def chain(d, rhs):
    """The plain reference: each out[k, l, c] one fma chain over j
    ascending, from +0."""
    K, L, J = d.shape
    acc = np.zeros((K, L, rhs.shape[-1]))
    for j in range(J):
        acc = fma(d[:, :, j, None], rhs[:, None, j, :], acc)
    return acc


@functools.lru_cache(maxsize=None)
def _table(B):
    """The reference plan (K padded to TK) and its f64 table."""
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=TK)
    return jp, np.asarray(jp.d, np.float64)


def _rhs(K, J, V, seed):
    return np.random.default_rng(seed).normal(size=(K, J, V * 16))


def _work(jp, tl):
    """The reference's ragged metadata (perm, kk, ll), which the port's
    build_work_list reproduces."""
    perm, l_start, kk, ll, _ = jops._ragged_metadata(jp, TK, tl)
    tkk, tll, _ = tdwt.build_work_list(l_start[perm], TK, tl, jp.B)
    assert np.array_equal(tkk, kk) and np.array_equal(tll, ll)
    return np.asarray(perm), np.asarray(kk), np.asarray(ll)


def _visited(kk, ll, K, L, tl, perm):
    seen = tdwt.visited_mask(torch.as_tensor(kk), torch.as_tensor(ll), K=K,
                             L=L, tk=TK, tl=tl).numpy()
    out = np.zeros_like(seen)
    out[perm] = seen                          # back to the caller's rows
    return out


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("tile", ["kernel", "other"])
def test_emulation_equals_fma_chain(B, V, tile):
    _, d = _table(B)
    rhs = _rhs(d.shape[0], 2 * B, V, seed=B + V)
    got = emulate(d, rhs, **(KERNEL_TILE if tile == "kernel" else OTHER_TILE))
    assert np.array_equal(got, chain(d, rhs))


@pytest.mark.parametrize("B", [4, 8, 16])
def test_lane_equals_single_transform(B):
    _, d = _table(B)
    rhs = _rhs(d.shape[0], 2 * B, 3, seed=B)
    got = emulate(d, rhs, **KERNEL_TILE)
    for k in range(3):
        grp = np.ascontiguousarray(rhs[..., 16 * k:16 * k + 16])
        assert np.array_equal(got[..., 16 * k:16 * k + 16],
                              emulate(d, grp, **KERNEL_TILE))


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("tl", [2, 4, 16])
def test_ragged_equals_dense_on_visited_rows(B, V, tl):
    jp, d = _table(B)
    K, L, J = d.shape
    _, tl, _ = tdwt.check_tiles(K, L, J, TK, tl, J)
    perm, kk, ll = _work(jp, tl)
    rhs = _rhs(K, J, V, seed=B + V + tl)
    dense = emulate(d, rhs, **KERNEL_TILE)
    rag = emulate(d, rhs, **KERNEL_TILE, work=(kk, ll), tl=tl, perm=perm)
    seen = _visited(kk, ll, K, L, tl, perm)
    assert np.array_equal(rag[seen], dense[seen])
    assert np.isnan(rag[~seen]).all()         # rows off the list unwritten
    # build_work_list gives each cluster tile one run: its rhs is staged
    # once per lane tile, not once per l-tile
    assert len(runs(kk, ll)) == len(np.unique(kk)) == K // TK


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("tl", [2, 4, 16])
def test_emulation_matches_reference_kernels(B, V, tl):
    """Within rtol 1e-11 of the Pallas dwt_dense / dwt_ragged (interpret
    mode), whose sums XLA orders otherwise."""
    jp, d = _table(B)
    K, L, J = d.shape
    _, tl, _ = tdwt.check_tiles(K, L, J, TK, tl, J)
    perm, kk, ll = _work(jp, tl)
    rhs = _rhs(K, J, V, seed=B + 2 * V + tl)
    want = np.asarray(jdwt.dwt_dense(d, rhs, tk=TK, tl=tl, tj=J,
                                     interpret=True))
    got = emulate(d, rhs, **KERNEL_TILE)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    want_r = np.empty_like(want)
    want_r[perm] = np.asarray(jdwt.dwt_ragged(d[perm], rhs[perm], kk, ll,
                                              tk=TK, tl=tl, tj=J,
                                              interpret=True))
    got_r = emulate(d, rhs, **KERNEL_TILE, work=(kk, ll), tl=tl, perm=perm)
    seen = _visited(kk, ll, K, L, tl, perm)
    np.testing.assert_allclose(got_r[seen], want_r[seen], rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["gaps", "repeats", "reversed", "shuffled"])
def test_any_work_list_is_computed_exactly(kind):
    """The ragged schedule relies on no property of the work list: gaps
    split a cluster tile's run, repeated entries write the same bits
    twice, and any order works.  Only the listed rows are written, each
    with the dense forward's bits."""
    B, tl = 16, 2
    jp, d = _table(B)
    K, L, J = d.shape
    perm, kk, ll = _work(jp, tl)
    rng = np.random.default_rng(len(kind))
    idx = np.arange(len(kk))
    if kind == "gaps":
        idx = idx[idx % 3 != 1]
    elif kind == "repeats":
        idx = np.concatenate([idx, idx[::5], idx[:4]])
    elif kind == "reversed":
        idx = idx[::-1]
    else:
        idx = rng.permutation(idx)
    kk2, ll2 = kk[idx], ll[idx]
    rhs = _rhs(K, J, 2, seed=7)
    dense = emulate(d, rhs, **KERNEL_TILE)
    rag = emulate(d, rhs, **KERNEL_TILE, work=(kk2, ll2), tl=tl, perm=perm)
    seen = _visited(kk2, ll2, K, L, tl, perm)
    assert 0 < seen.sum() < seen.size
    assert np.array_equal(rag[seen], dense[seen])
    assert np.isnan(rag[~seen]).all()
    # every listed entry lies in exactly one run
    covered = sorted(g + t for g, n in runs(kk2, ll2).items()
                     for t in range(n))
    assert covered == list(range(len(kk2)))


def test_ring_shared_memory_rule():
    """The f64 ring's shared memory: 3 stages of a table chunk -- forward
    128 l x (16 + 4) j, inverse 16 l x (128 + 4) j -- and a 16 x (BC + 4)
    operand chunk, the same for every span; the f32 inverse's ring holds
    the same chunks unpadded in floats."""
    for C2, bc in ((16, 16), (32, 64), (48, 64), (64, 64), (128, 64)):
        assert kernel_lanes(C2) == bc
        want = 8 * 3 * (128 * 20 + 16 * (bc + 4))
        for span in (2, 16, 128, 256):
            assert autotune.dense_smem_bytes(span, C2, 8) == want
            assert autotune.dense_smem_bytes(span, C2, 8, inverse=True) == \
                8 * 3 * (16 * 132 + 16 * (bc + 4)) == \
                2 * autotune.dense_smem_bytes(span, C2, 4, inverse=True) \
                + 8 * 3 * 16 * 8
    # two blocks an SM
    assert 2 * autotune.dense_smem_bytes(128, 128, 8) == 175104 <= \
        autotune.SMEM_LIMIT_BYTES
