"""The dense and ragged DWT / iDWT of the port (repro_torch.kernels.dwt),
their bindings and plans, against the reference package on identical
inputs.

On the CPU the wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as the reference's own tests
do.  Tolerances are the reference's (tests/test_dwt_fused.py): rtol
1e-10 / atol 1e-11 in f64, 5e-4 / 1e-4 in f32; the plans' f64
tolerance is tests/test_core_soft.py's rtol 1e-11 / atol 1e-12.  The
CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import batched as jb  # noqa: E402
from repro.core import clusters as jclusters  # noqa: E402
from repro.kernels import dwt as jdwt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dwt as tdwt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

NDT = {torch.float32: np.float32, torch.float64: np.float64}
RTOL, ATOL = 1e-11, 1e-12       # plans, f64 (tests/test_core_soft.py)


def _tol(dtype):
    return (5e-4, 1e-4) if dtype == torch.float32 else (1e-10, 1e-11)


def _table(B, dtype, tk=4):
    """The reference plan (K padded to tk) and its table in dtype."""
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=tk)
    return jp, np.asarray(jp.d).astype(NDT[dtype])


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("tl", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_forward_matches_reference(B, V, tl, dtype):
    tk, J = 4, 2 * B
    _, d = _table(B, dtype, tk)
    K = d.shape[0]
    rhs = np.random.default_rng(B + V).normal(size=(K, J, V * 16)) \
        .astype(NDT[dtype])
    out = tdwt.dwt_dense(torch.as_tensor(d), torch.as_tensor(rhs), tk=tk,
                         tl=tl, tj=J).numpy()
    want = np.asarray(jdwt.dwt_dense(d, rhs, tk=tk, tl=tl, tj=J,
                                     interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(out, np.asarray(jref.dwt_ref(d, rhs)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("tl", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_inverse_matches_reference(B, V, tl, dtype):
    tk, J = 4, 2 * B
    _, d = _table(B, dtype, tk)
    K = d.shape[0]
    lhs = np.random.default_rng(B + V + 1).normal(size=(K, B, V * 16)) \
        .astype(NDT[dtype])
    out = tdwt.idwt_dense(torch.as_tensor(d), torch.as_tensor(lhs), tk=tk,
                          tl=tl, tj=J).numpy()
    want = np.asarray(jdwt.idwt_dense(d, lhs, tk=tk, tl=tl, tj=J,
                                      interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(out, np.asarray(jref.idwt_ref(d, lhs)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("tl", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ragged_forward_matches_reference(B, V, tl, dtype):
    """The port reads d and rhs and writes out through perm; the
    reference contracts permuted copies.  Compared on the blocks the work
    list visits (the rest is undefined in both)."""
    tk, J = 4, 2 * B
    jp, d = _table(B, dtype, tk)
    perm, _, kk, ll, n_dense = jops._ragged_metadata(jp, tk, tl)
    K = d.shape[0]
    rhs = np.random.default_rng(B + V + 2).normal(size=(K, J, V * 16)) \
        .astype(NDT[dtype])
    out = tdwt.dwt_ragged(torch.as_tensor(d), torch.as_tensor(rhs),
                          torch.as_tensor(kk), torch.as_tensor(ll), tk=tk,
                          tl=tl, tj=J, perm=torch.as_tensor(perm)).numpy()
    want = np.asarray(jdwt.dwt_ragged(d[perm], rhs[perm], kk, ll, tk=tk,
                                      tl=tl, tj=J, interpret=True))
    seen = tdwt.visited_mask(torch.as_tensor(kk), torch.as_tensor(ll), K=K,
                             L=B, tk=tk, tl=tl).numpy()
    assert len(kk) < n_dense or tl >= B       # the work list skips blocks
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out[perm][seen], want[seen], rtol=rtol,
                               atol=atol)
    dense = np.asarray(jref.dwt_ref(d, rhs))
    np.testing.assert_allclose(out[perm][seen], dense[perm][seen],
                               rtol=rtol, atol=atol)
    assert not out[perm][~seen].any()      # the plain version's zeros


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("tk", [4, 8])
@pytest.mark.parametrize("tl", [2, 4])
def test_work_list_and_ragged_metadata_equal_reference(B, tk, tl):
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=tk)
    tp = tb.build_plan(B, pad_to=tk, device="cpu")
    want = jops._ragged_metadata(jp, tk, tl)
    got = tops._ragged_metadata(tp, tk, tl)
    for name, w in zip(("perm", "l_start", "kk", "ll"), want[:4]):
        np.testing.assert_array_equal(getattr(got, name), w)
        assert getattr(got, name).dtype == w.dtype
    assert got.n_dense == want[4]
    assert torch.equal(got.kk_t, torch.as_tensor(want[2]))
    assert torch.equal(got.perm_t, torch.as_tensor(want[0]))
    # the mask is l >= l_start in the plan's order
    np.testing.assert_array_equal(
        got.mask.numpy(), np.arange(B)[None, :] >= want[1][:, None])
    assert tops._ragged_metadata(tp, tk, tl) is got      # memoized
    l_start = np.sort(want[1])
    for a, b in zip(tdwt.build_work_list(l_start, tk, tl, B),
                    jdwt.build_work_list(l_start, tk, tl, B)):
        np.testing.assert_array_equal(a, b)


def test_tiles_must_divide():
    d = torch.zeros(8, 4, 8, dtype=torch.float64)
    for fn, x in ((tdwt.dwt_dense, torch.zeros(8, 8, 16)),
                  (tdwt.idwt_dense, torch.zeros(8, 4, 16))):
        with pytest.raises(ValueError, match="not divisible by tiles"):
            fn(d, x.double(), tk=3)
        with pytest.raises(ValueError, match="not divisible by tiles"):
            fn(d, x.double(), tl=3)
        with pytest.raises(ValueError, match="not divisible by tiles"):
            fn(d, x.double(), tj=3)
    assert tdwt.check_tiles(8, 4, 8, 8, 128, 512) == (8, 4, 8)


def test_cpu_wrappers_launch_no_kernel():
    d = torch.zeros(8, 4, 8, dtype=torch.float64)
    before = dict(tdwt.LAUNCHES)
    tdwt.dwt_dense(d, torch.zeros(8, 8, 16, dtype=torch.float64))
    tdwt.idwt_dense(d, torch.zeros(8, 4, 16, dtype=torch.float64))
    kk = torch.zeros(1, dtype=torch.int32)
    tdwt.dwt_ragged(d, torch.zeros(8, 8, 16, dtype=torch.float64), kk, kk,
                    tk=8, tl=4)
    assert tdwt.LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    d = torch.zeros(8, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tdwt.dwt_dense(d, torch.zeros(8, 8, 16, device="meta"))


# ---------------------------------------------------------------------------
# bindings: make_dwt_fn / make_idwt_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("direction", ["dwt", "idwt"])
def test_make_fn_matches_reference(impl, batch, direction):
    B = 8
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8)
    tp = tb.build_plan(B, dtype=torch.float64, pad_to=8, device="cpu")
    A = 2 * B if direction == "dwt" else B
    lead = () if batch is None else (batch,)
    x = np.random.default_rng(B).normal(size=lead + (jp.n_padded, A, 8, 2))
    jimpl = "dense" if (impl, direction) == ("ragged", "idwt") else impl
    jfn = getattr(jops, f"make_{direction}_fn")(jp, jimpl, tk=8, tl=2,
                                               tj=2 * B, batch=batch,
                                               interpret=True)
    maker = getattr(tops, f"make_{direction}_fn")
    if jimpl != impl:
        with pytest.raises(ValueError, match="no inverse kernel"):
            maker(tp, impl, tk=8, tl=2, batch=batch)
    tfn = maker(tp, jimpl, tk=8, tl=2, batch=batch)
    np.testing.assert_allclose(tfn(tp, torch.as_tensor(x)).numpy(),
                               np.asarray(jfn(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-11)


def test_table_schedules_refuse_streaming_plans():
    sp = tb.build_plan(8, pad_to=8, streaming=True, device="cpu")
    for consumer in (lambda: tops.make_dwt_fn(sp, "dense"),
                     lambda: tops.make_dwt_fn(sp, "ragged"),
                     lambda: tops.make_idwt_fn(sp, "dense"),
                     lambda: tb.make_bucketed_dwt_fn(sp)):
        with pytest.raises(ValueError, match="streaming"):
            consumer()


@pytest.mark.parametrize("kwargs", [dict(lchunk=4), dict(precision="bf16")])
@pytest.mark.parametrize("impl", ["dense", "ragged", "onthefly"])
def test_streaming_options_need_fused(impl, kwargs):
    tp = tb.build_plan(8, pad_to=8, device="cpu")
    with pytest.raises(ValueError, match="impl='fused'"):
        tops.make_dwt_fn(tp, impl, **kwargs)


# ---------------------------------------------------------------------------
# the bucketed DWT (plain torch, core.batched)
# ---------------------------------------------------------------------------

def _bucketed_pair(B, n_shards, n_buckets):
    order = jb.shard_balanced_order(
        jclusters.build_cluster_table(B).rep[:, 0], n_shards)
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=n_shards, order=order)
    tp = tb.build_plan(B, pad_to=n_shards, order=order, device="cpu")
    rhs = np.random.default_rng(B).normal(size=(tp.n_padded, 2 * B, 8, 2))
    got = tb.make_bucketed_dwt_fn(tp, n_shards, n_buckets)(
        tp, torch.as_tensor(rhs)).numpy()
    want = np.asarray(jb.make_bucketed_dwt_fn(jp, n_shards, n_buckets)(
        jp, jnp.asarray(rhs)))
    assert tb.bucket_boundaries(tp, n_shards, n_buckets) == \
        jb.bucket_boundaries(jp, n_shards, n_buckets)
    plain = tb.dwt_apply(tp, torch.as_tensor(rhs)).numpy()
    return got, want, plain


@pytest.mark.parametrize("B,n_shards,n_buckets",
                         [(4, 1, 8), (8, 2, 3), (16, 1, 8), (16, 4, 6)])
def test_bucketed_dwt_matches_reference(B, n_shards, n_buckets):
    got, want, plain = _bucketed_pair(B, n_shards, n_buckets)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)


def test_bucketed_dwt_exact_property():
    """The reference's property (tests/test_properties.py): the
    extent-bucketed DWT equals the plain contraction for any shard /
    bucket split."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=10, deadline=None)
    @hyp.given(st.integers(3, 16), st.integers(1, 4), st.integers(1, 6))
    def prop(B, n_shards, n_buckets):
        got, want, plain = _bucketed_pair(B, n_shards, n_buckets)
        np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    prop()


def test_bucket_boundaries_from_lstart_equal_reference():
    rng = np.random.default_rng(0)
    for n_shards, n_buckets in ((1, 8), (2, 3), (4, 5)):
        l_start = np.sort(rng.integers(0, 16, (n_shards, 12)), axis=1)
        l_start = l_start.reshape(-1)
        assert tb.bucket_boundaries_from_lstart(l_start, n_shards,
                                                n_buckets) == \
            jb.bucket_boundaries_from_lstart(l_start, n_shards, n_buckets)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _stack(B, seeds):
    return np.stack([tsoft.random_coeffs(B, s) for s in seeds])


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_plan_matches_reference_plan(B, impl):
    t = tplan(B, device="cpu", impl=impl, tl=2, V=2)
    j = jplan(B, impl=impl, tl=2, V=2)
    # tl is the ragged work list's tile; the dense schedule has none
    assert t.schedule.tl == (2 if impl == "ragged" else B)
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
    np.testing.assert_allclose(backs.numpy(), fhats, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_batched_lane_equals_single_bitwise(impl):
    t = tplan(8, device="cpu", impl=impl, tl=2, V=4)
    fhats = _stack(8, range(3))
    fs = t.inverse_batch(fhats)
    backs = t.forward_batch(fs)
    for k in range(3):
        assert torch.equal(fs[k], t.inverse(fhats[k]))
        assert torch.equal(backs[k], t.forward(fs[k]))


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_table_plans_refuse_streaming(impl):
    with pytest.raises(ValueError, match="streaming"):
        tplan(8, device="cpu", impl=impl, streaming=True)
    # the auto rule never streams a table schedule
    assert not tplan(8, device="cpu", impl=impl).soft_plan.streaming


def test_dense_plan_over_device_memory_is_refused(monkeypatch):
    """The table enters estimate_batch_bytes: a dense plan whose table
    does not fit is refused before anything is built, while the same B
    planned onthefly (streaming, no table) fits."""
    B, itemsize = 8, 8
    monkeypatch.setenv("REPRO_PLAN_DENSE_TABLE_BYTES", "0")
    tplan.clear_cache()
    K = 40
    stream = autotune.estimate_batch_bytes(B, K, 1, itemsize)
    table = autotune.estimate_batch_bytes(B, K, 1, itemsize, table=True)
    assert table - stream >= autotune.table_bytes(B, K, itemsize) == \
        K * B * 2 * B * itemsize
    monkeypatch.setattr(autotune, "device_memory_bytes",
                        lambda device: (stream + table) // 2)
    misses = tb.plan_cache_stats()["misses"]
    with pytest.raises(ValueError, match="dense table"):
        tplan(B, device="cpu", impl="dense")
    assert tb.plan_cache_stats()["misses"] == misses     # nothing built
    t = tplan(B, device="cpu", impl="onthefly")
    assert t.soft_plan.streaming and t.soft_plan.n_padded == K
    tplan.clear_cache()


def test_describe_table_schedule():
    t = tplan(8, device="cpu", impl="ragged", tl=4, V=2)
    d = t.describe()
    assert d["impl"] == "ragged" and d["inverse_impl"] == "dense"
    assert d["tl"] == 4 and "tj" not in d
    assert d["smem_bytes"] == max(autotune.dense_smem_bytes(s, 32, 8)
                                  for s in (4, 16))
    assert d["batch_bytes"] == autotune.estimate_batch_bytes(
        8, 40, 2, 8, table=True)
    with pytest.raises(ValueError, match="not divisible"):
        tplan(8, device="cpu", impl="dense", tl=3)


@pytest.mark.parametrize("impl", ["dense", "onthefly", "fused"])
def test_tl_keys_only_the_ragged_plan(impl):
    """tl changes only the ragged schedule: another impl planned with any
    tl that divides B is the same Transform (and the same table)."""
    t = tplan(8, device="cpu", impl=impl)
    assert tplan(8, device="cpu", impl=impl, tl=2) is t
    assert t.schedule.tl == 8
    r2 = tplan(8, device="cpu", impl="ragged", tl=2)
    r4 = tplan(8, device="cpu", impl="ragged", tl=4)
    assert r2 is not r4 and (r2.schedule.tl, r4.schedule.tl) == (2, 4)
    assert r2.soft_plan is r4.soft_plan


def test_plan_memos_go_with_their_plan():
    """The per-plan memos (ragged work list, seeds, bucket slices) are
    weak: once the caches are cleared and the caller drops its Transform,
    the plan and its dense table are freed."""
    tplan.clear_cache()
    t = tplan(8, device="cpu", impl="ragged", tl=2, V=2)
    t.forward(t.inverse(_stack(8, [0])[0]))
    sp = t.soft_plan
    meta = tops._ragged_metadata(sp, 8, 2)
    assert tops._ragged_metadata(sp, 8, 2) is meta
    tops.onthefly_inputs(sp)
    tb.bucket_boundaries(sp, 1, 4)
    plan_ref, table_ref = weakref.ref(sp), weakref.ref(sp.d)
    del t, sp, meta
    gc.collect()
    assert plan_ref() is not None            # the caches still hold it
    tplan.clear_cache()
    assert tb.plan_cache_stats()["plans"] == 0
    gc.collect()
    assert plan_ref() is None and table_ref() is None
