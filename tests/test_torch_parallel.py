"""repro_torch.core.parallel on the CPU against repro.core.parallel and
repro.plan: the pipeline schedule, the shard layout (shard-balanced
order, per-shard l-starts, the fused kernels' l0s) exactly equal to the
reference's, the packed <-> dense layout, the bucketed local DWT, and
the DistExecutor on a one-rank gloo group in this process against the
reference's single-device transform (rtol 1e-11 / atol 1e-11, the
reference's tests/test_parallel.py tolerance), pipelined == off bit for
bit.  More ranks: tests/test_torch_dist.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import batched as jb  # noqa: E402
from repro.core import clusters as jclusters  # noqa: E402
from repro.core import parallel as jpar  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import parallel as tpar  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dwt_fused as tdf  # noqa: E402

RTOL = ATOL = 1e-11


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo process group in this process and its mesh."""
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        tplan.clear_cache()
        dist.destroy_process_group()


def _order(B, n_shards):
    l_start = jclusters.build_cluster_table(B).rep[:, 0]
    n_padded = -(-len(l_start) // n_shards) * n_shards
    return l_start, n_padded


def _plans(B, n_shards):
    """The reference's and the port's mesh-ordered plans (the planner's
    mesh path: pad_to = n_shards, the pad-aware shard-balanced deal)."""
    l_start, n_padded = _order(B, n_shards)
    order = jb.shard_balanced_order(l_start, n_shards, n_padded=n_padded)
    return (jb.build_plan(B, pad_to=n_shards, order=order),
            tb.build_plan(B, pad_to=n_shards, order=order, device="cpu"))


# ---------------------------------------------------------------------------
# the pipeline schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5])
def test_pipeline_schedule_matches_reference(n_chunks):
    assert tpar.pipeline_steps(n_chunks) == jpar.pipeline_steps(n_chunks)
    assert tpar.pipeline_slots(n_chunks) == jpar.pipeline_slots(n_chunks)
    # every interior step overlaps one collective with the previous
    # chunk's kernel, on different slots
    for (read, write) in tpar.pipeline_slots(n_chunks)[1:-1]:
        assert read != write


def test_pipeline_and_overlap_validation():
    for fn in (tpar.pipeline_steps, tpar.pipeline_slots):
        with pytest.raises(ValueError, match="n_chunks"):
            fn(0)
    assert tpar.OVERLAP_MODES == jpar.OVERLAP_MODES
    assert tpar.check_overlap_mode("pipelined") == "pipelined"
    with pytest.raises(ValueError, match="overlap"):
        tpar.check_overlap_mode("async")


# ---------------------------------------------------------------------------
# shard layout, exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, n_shards", [(8, 1), (8, 2), (8, 4), (8, 8),
                                         (16, 3), (16, 4), (32, 8)])
@pytest.mark.parametrize("padded", [False, True])
def test_shard_balanced_order_matches_reference(B, n_shards, padded):
    l_start, n_padded = _order(B, n_shards)
    kw = dict(n_padded=n_padded) if padded else {}
    want = jb.shard_balanced_order(l_start, n_shards, **kw)
    got = tb.shard_balanced_order(l_start, n_shards, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B, n_shards", [(8, 2), (8, 8), (16, 4)])
def test_shard_lstart_matches_reference(B, n_shards):
    jp, tp = _plans(B, n_shards)
    want = jb.shard_lstart(jp, n_shards)
    got = tb.shard_lstart(tp, n_shards)
    assert got.shape == (n_shards, tp.n_padded // n_shards)
    np.testing.assert_array_equal(got, want)
    for row in got:                     # extent-sorted within each shard
        assert (np.diff(row) >= 0).all()


@pytest.mark.parametrize("B, n_shards, tk", [(8, 2, None), (8, 2, 3),
                                             (8, 4, None), (16, 4, 2),
                                             (16, 2, None), (16, 1, None)])
def test_fused_shard_meta_matches_reference(B, n_shards, tk):
    jp, tp = _plans(B, n_shards)
    want = jpar.fused_shard_meta(jp, n_shards, tk)
    got = tpar.fused_shard_meta(tp, n_shards, tk)
    assert got.tk == want.tk
    assert got.l0s.dtype == np.int32
    np.testing.assert_array_equal(got.l0s, np.asarray(want.l0s))
    np.testing.assert_array_equal(got.l0s_t.numpy(), got.l0s)
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
    np.testing.assert_array_equal(got.mp.numpy(), np.asarray(want.mp))
    np.testing.assert_allclose(got.seeds.numpy(), np.asarray(want.seeds),
                               rtol=1e-13, atol=1e-15)
    assert tpar.fused_shard_meta(tp, n_shards, tk) is got     # memoized
    with pytest.raises(ValueError, match="not divisible"):
        tpar.fused_shard_meta(tp, n_shards, tp.n_padded // n_shards + 1)


# ---------------------------------------------------------------------------
# packed <-> dense and the local contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8])
def test_packed_dense_matches_reference(B):
    jp, tp = _plans(B, 2)
    fhats = np.stack([tsoft.random_coeffs(B, s) for s in range(3)])
    want = np.asarray(jpar.dense_to_packed_batch(jp, jnp.asarray(fhats)))
    got = tpar.dense_to_packed_batch(tp, fhats)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpar.dense_to_packed(tp, fhats[1]).numpy(),
                                  want[1])
    back = tpar.packed_to_dense_batch(tp, got)
    np.testing.assert_array_equal(back.numpy(), fhats)
    np.testing.assert_array_equal(
        tpar.packed_to_dense(tp, got[2]).numpy(),
        np.asarray(jpar.packed_to_dense(jp, jnp.asarray(want[2]))))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_bucketed_local_dwt_matches_reference(n_shards):
    B = 8
    jp, tp = _plans(B, n_shards)
    kloc = tp.n_padded // n_shards
    slices = tb.bucket_boundaries(tp, n_shards, 4)
    assert slices == jb.bucket_boundaries(jp, n_shards, 4)
    rng = np.random.default_rng(n_shards)
    rhs = rng.normal(size=(kloc, 2 * B, 48))
    d = np.array(jp.d)[kloc * (n_shards - 1):]         # the last shard
    want = np.asarray(jpar.make_bucketed_local_dwt(slices, B)(
        jnp.asarray(d), jnp.asarray(rhs)))
    got = tpar.make_bucketed_local_dwt(slices, B)(torch.as_tensor(d),
                                                  torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_fused_local_kernels_on_each_shard(n_shards):
    """Each shard's block through make_fused_local_dwt / _idwt equals the
    full plan's fused kernel on the same clusters."""
    B = 8
    _, tp = _plans(B, n_shards)
    meta = tpar.fused_shard_meta(tp, n_shards)
    fwd = tpar.make_fused_local_dwt(tp, n_shards, meta=meta)
    inv = tpar.make_fused_local_idwt(tp, n_shards, meta=meta)
    rng = np.random.default_rng(0)
    rhs = torch.as_tensor(rng.normal(size=(tp.n_padded, 2 * B, 32)))
    lhs = torch.as_tensor(rng.normal(size=(tp.n_padded, B, 32)))
    kloc = tp.n_padded // n_shards
    outs, gs = [], []
    for s in range(n_shards):
        ops = fwd.local_operands(s, n_shards)
        outs.append(fwd.fn(*ops, rhs[s * kloc:(s + 1) * kloc]))
        gs.append(inv.fn(*inv.local_operands(s, n_shards),
                         lhs[s * kloc:(s + 1) * kloc]))
    full_l0 = torch.zeros(tp.n_padded, dtype=torch.int32)
    want = tdf.dwt_fused_plain(meta.seeds, meta.m, meta.mp, meta.cb, rhs,
                               full_l0, B=B, tk=1)
    np.testing.assert_allclose(torch.cat(outs).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-13)
    want = tdf.idwt_fused_plain(meta.seeds, meta.m, meta.mp, meta.cb, lhs,
                                full_l0, B=B, tk=1)
    np.testing.assert_allclose(torch.cat(gs).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-13)


# ---------------------------------------------------------------------------
# the executor on a one-rank gloo group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("impl", ["auto", "dense", "ragged", "reference"])
def test_one_rank_mesh_plan_matches_reference(mesh, B, impl):
    t = tplan(B, device="cpu", mesh=mesh, axis=("data",), impl=impl, V=2)
    j = jplan(B, V=2)
    assert t.n_shards == 1 and t.schedule.n_shards == 1
    fhats = np.stack([tsoft.random_coeffs(B, s) for s in range(3)])
    f = t.inverse(fhats[0])
    np.testing.assert_allclose(f.numpy(), np.asarray(j.inverse(fhats[0])),
                               rtol=RTOL, atol=ATOL)
    f_in = np.array(j.inverse(fhats[0]))
    np.testing.assert_allclose(
        t.forward(f_in).numpy(), np.asarray(j.forward(jnp.asarray(f_in))),
        rtol=RTOL, atol=ATOL)
    t.reset_stats()
    fs = t.inverse_batch(fhats)
    assert t.stats == dict(launches=2, transforms=3, padded_lanes=1)
    want = np.array(j.inverse_batch(fhats))
    np.testing.assert_allclose(fs.numpy(), want, rtol=RTOL, atol=ATOL)
    backs = t.forward_batch(want)
    np.testing.assert_allclose(
        backs.numpy(), np.asarray(j.forward_batch(jnp.asarray(want))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(backs.numpy(), fhats, rtol=1e-10, atol=ATOL)


@pytest.mark.parametrize("B", [8, 16])
def test_pipelined_equals_off_bitwise(mesh, B):
    t = tplan(B, device="cpu", mesh=mesh, axis=("data",), V=2)
    fhats = np.stack([tsoft.random_coeffs(B, s) for s in range(5)])
    stats = {m: dict(launches=0, transforms=0, padded_lanes=0)
             for m in tpar.OVERLAP_MODES}
    fs = {m: t.inverse_batch(fhats, overlap=m, stats=stats[m])
          for m in tpar.OVERLAP_MODES}
    assert torch.equal(fs["off"], fs["pipelined"])
    backs = {m: t.forward_batch(fs["off"], overlap=m, stats=stats[m])
             for m in tpar.OVERLAP_MODES}
    assert torch.equal(backs["off"], backs["pipelined"])
    assert stats["off"] == stats["pipelined"] == \
        dict(launches=6, transforms=10, padded_lanes=2)


def test_one_all_to_all_per_chunk_and_direction(mesh):
    t = tplan(8, device="cpu", mesh=mesh, axis=("data",), V=2)
    fhats = np.stack([tsoft.random_coeffs(8, s) for s in range(5)])
    for mode in tpar.OVERLAP_MODES:
        tpar.reset_all_to_alls()
        fs = t.inverse_batch(fhats, overlap=mode)
        assert tpar.ALL_TO_ALLS == {"forward": 0, "inverse": 3}
        t.forward_batch(fs, overlap=mode)
        assert tpar.ALL_TO_ALLS == {"forward": 3, "inverse": 3}


def test_executor_lanes_and_validation(mesh):
    B = 8
    _, tp = _plans(B, 1)
    ex = tpar.dist_executor(tp, mesh, ("data",))
    assert ex is tpar.dist_executor(tp, mesh, "data")
    assert (ex.n_shards, ex.rank, ex.kloc, ex.jloc) == (1, 0, tp.n_padded,
                                                       2 * B)
    with pytest.raises(ValueError, match="lane_width"):
        tpar.DistExecutor(tp, mesh, ("data",), lane_width=0)
    with pytest.raises(ValueError, match="no dims"):
        tpar.DistExecutor(tp, mesh, ("model",))
    C = tp.gather_m.shape[1]
    assert ex.forward_batch(np.zeros((0,) + (2 * B,) * 3)).shape == \
        (0, tp.n_padded, B, C)
    assert ex.inverse_batch(np.zeros((0, tp.n_padded, B, C))).shape == \
        (0,) + (2 * B,) * 3
    # the shims and the lanes agree with the executor's global forms
    fhat = tsoft.random_coeffs(B, 4)
    packed = tpar.dense_to_packed(tp, fhat)
    f = tpar.distributed_inverse(tp, packed, mesh, ("data",))
    assert torch.equal(f, ex.inverse_lanes(packed[None])[0])
    assert torch.equal(tpar.distributed_forward(tp, f, mesh, ("data",)),
                       ex.forward(f))


@pytest.mark.parametrize("impl, table", [("auto", False), ("fused", False),
                                         ("onthefly", False),
                                         ("dense", True), ("ragged", True)])
def test_mesh_plan_builds_the_table_only_where_read(mesh, impl, table):
    """The recurrence family's local kernels read the seeds alone, so its
    mesh plans build no dense table; the table schedules' bucketed
    contraction reads it, so theirs do.  Either way the batch estimate
    counts whole grids, as the executor runs them."""
    t = tplan(8, device="cpu", mesh=mesh, axis=("data",), impl=impl)
    assert t.soft_plan.streaming is (not table)
    assert (t.soft_plan.d is not None) is table
    # the executor's stages run on whole grids, table or not
    assert t.describe()["batch_bytes"] == autotune.estimate_batch_bytes(
        8, t.soft_plan.n_padded, t.V, 8, table=table, whole_grids=True)
    with pytest.raises(ValueError, match="streaming=True needs"):
        tplan(8, device="cpu", mesh=mesh, axis=("data",), impl="dense",
              streaming=True)
    # an explicit streaming=False keeps the table on a fused mesh plan
    assert tplan(8, device="cpu", mesh=mesh, axis=("data",),
                 streaming=False).soft_plan.d is not None


def test_local_mesh_evicts_its_plans(mesh):
    """local_mesh over the caller's one-rank group: on exit the plans
    cached on its mesh go, the group and the plans of other meshes stay
    (tests/test_torch_so3_service.py checks the group local_mesh starts
    itself, through serve_so3 --mesh-shards 1)."""
    tplan.clear_cache()          # room under the cache's 16 entries
    other = tplan(4, device="cpu", mesh=mesh, axis=("data",))
    loc = tplan(4, device="cpu")
    before = tplan.cache_stats()["mesh_size"]
    with tpar.local_mesh(1, torch.device("cpu")) as m:
        assert m is not mesh
        t = tplan(4, device="cpu", mesh=m, axis=("data",))
        assert tplan(4, device="cpu", mesh=m, axis=("data",)) is t
        assert tplan.cache_stats()["mesh_size"] == before + 1
    assert dist.is_initialized()
    assert tplan.cache_stats()["mesh_size"] == before
    assert tplan(4, device="cpu", mesh=mesh, axis=("data",)) is other
    assert tplan(4, device="cpu") is loc
    assert tplan.evict_mesh(mesh) >= 1
    assert tplan.cache_stats()["mesh_size"] == 0
    with pytest.raises(RuntimeError, match="process group of 2"):
        with tpar.local_mesh(2, torch.device("cpu")):
            pass


def test_mesh_plan_describe_and_cache(mesh):
    t = tplan(8, device="cpu", mesh=mesh, axis=("data",))
    assert tplan(8, device="cpu", mesh=mesh, axis="data") is t
    d = t.describe()
    assert d["mesh_axes"] == ["data"] and d["mesh_shape"] == [1]
    assert d["shard_clusters"] == t.soft_plan.n_padded
    assert d["shard_beta"] == 16 and d["overlap"] == "off"
    assert d["n_shards"] == 1 and d["lane_width"] == t.V
    assert tplan.cache_stats()["mesh_size"] >= 1
    assert t.executor() is t.executor()
    assert t.shard_meta() is t.shard_meta()
    with pytest.raises(ValueError, match="without a mesh"):
        tplan(8, device="cpu").executor()
    with pytest.raises(ValueError, match="not wired"):
        tplan(8, device="cpu", mesh=mesh, axis=("data",), lchunk=4)
    with pytest.raises(ValueError, match="needs a mesh plan"):
        tplan(8, device="cpu", overlap="pipelined")
    with pytest.raises(ValueError, match="needs a mesh plan"):
        tplan(8, device="cpu").inverse_batch(
            tsoft.random_coeffs(8, 0)[None], overlap="pipelined")


# ---------------------------------------------------------------------------
# the pipelined batch's memory estimate and the executor's annotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, V", [(8, 1), (8, 4), (128, 8)])
def test_pipelined_estimate_adds_the_pipeline_buffers(B, V):
    """estimate_batch_bytes(overlap="pipelined") exceeds the "off" count
    by exactly the buffers its docstring names, per lane: the second
    receive slot and the next chunk's send buffer (K x 2B rows of 16 lanes
    each) and the next chunk's stage-1 working set, the larger of the
    forward's (the FFT output grid (2B)^3 complex and the member gather,
    K x 2B x 16) and the inverse's (the packed operand K x B x 16, the
    kernel result and its flipped copy, 2 x K x 2B x 16)."""
    K, itemsize = B * (B + 1) // 2, 8
    off = autotune.estimate_batch_bytes(B, K, V, itemsize, whole_grids=True)
    pipe = autotune.estimate_batch_bytes(B, K, V, itemsize, whole_grids=True,
                                         overlap="pipelined")
    slot = K * 2 * B * 16 * itemsize
    grid = (2 * B) ** 3 * 2 * itemsize
    narrow = K * B * 16 * itemsize
    stage1 = max(grid + slot, narrow + 2 * slot)
    assert pipe - off == V * (2 * slot + stage1) \
        == autotune.pipeline_extra_bytes(B, K, V, itemsize)
    assert autotune.estimate_batch_bytes(B, K, V, itemsize,
                                         overlap="off") == \
        autotune.estimate_batch_bytes(B, K, V, itemsize)


def test_mesh_plan_counts_its_overlap_mode(mesh):
    """A mesh plan's describe()["batch_bytes"] is the estimate in its own
    overlap mode: "off" (the one-shard default) and an explicit
    "pipelined"."""
    kw = dict(device="cpu", mesh=mesh, axis=("data",), V=2)
    off = tplan(8, **kw)
    pipe = tplan(8, overlap="pipelined", **kw)
    K = off.soft_plan.n_padded
    assert off.describe()["overlap"] == "off"
    assert off.describe()["batch_bytes"] == autotune.estimate_batch_bytes(
        8, K, 2, 8, whole_grids=True)
    assert pipe.describe()["overlap"] == "pipelined"
    assert pipe.describe()["batch_bytes"] == off.describe()["batch_bytes"] \
        + autotune.pipeline_extra_bytes(8, K, 2, 8)


def test_executor_annotates_its_dispatch(mesh, monkeypatch):
    """Each chunk of an "off" batch and each pipelined batch runs inside
    obs.device_annotation("executor.chunk.<direction>" /
    "executor.pipeline.<direction>"), as the reference's executor does."""
    import contextlib
    from repro_torch import obs
    seen = []

    def record(name):
        seen.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(obs, "device_annotation", record)
    t = tplan(8, device="cpu", mesh=mesh, axis=("data",), V=2)
    fhats = np.stack([tsoft.random_coeffs(8, s) for s in range(3)])
    fs = t.inverse_batch(fhats, overlap="off")
    t.forward_batch(fs, overlap="off")
    assert seen == ["executor.chunk.inverse"] * 2 + \
        ["executor.chunk.forward"] * 2
    seen.clear()
    fs = t.inverse_batch(fhats, overlap="pipelined")
    t.forward_batch(fs, overlap="pipelined")
    assert seen == ["executor.pipeline.inverse", "executor.pipeline.forward"]
