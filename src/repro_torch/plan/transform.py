"""Planner/executor layer of the port: ``plan(B)`` resolves a schedule,
builds the plan's tables on the device once, and returns a memoized
:class:`Transform` whose executors run the clustered FSOFT / iFSOFT
through the CUDA kernels.

    from repro_torch import plan
    t = plan(B)                            # on the card, fused kernels
    fhat = t.forward(f)                    # single transform
    grids = t.inverse_batch(fhats)         # V-lane packed launches
    t16 = plan(B, lchunk=16)               # l-chunked streaming kernels
    tb = plan(B, torch.float32, precision="bf16")   # bf16 rows / windows
    to = plan(B, impl="onthefly")          # every degree, no ragged skip
    td = plan(B, impl="dense")             # resident (K, L, J) table
    tr = plan(B, impl="ragged", tl=16)     # table, work-list forward
    t.engine().match_batch(fs, gs)         # rotational matching (so3/)
    tm = plan(B, tune="measure")           # measured sweep, cached on disk
    tx = plan(B, mesh=mesh, axis=("data",))  # sharded over a DeviceMesh

The port of ``repro.plan.transform``.  A mesh plan
(``mesh=`` a ``torch.distributed.device_mesh.DeviceMesh``) runs every
executor through the plan's :class:`repro_torch.core.parallel.DistExecutor`
(one all-to-all per V-chunk and direction, ``overlap="off"`` or
``"pipelined"``) and keeps the local plan's contract: every rank passes
and gets the whole tensors.  ``tune="measure"`` (or
``$REPRO_PLAN_TUNE=measure``) resolves the schedule by the measured sweep
of :mod:`repro_torch.kernels.autotune`.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import torch

from repro_torch import obs
from repro_torch.core import batched, clusters as clusters_mod, parallel
from repro_torch.core.batched import SoftPlan, resolve_device
from repro_torch.kernels import autotune, dwt_fused, ops, wigner_rec
from repro_torch.kernels import dwt as dwt_kernels
from repro_torch.kernels import streaming as streaming_kernels

__all__ = ["Transform", "Schedule", "plan", "clear_cache", "cache_stats",
           "warm_bandwidths", "dense_table_bytes_limit", "IMPLS",
           "AUTO_IMPL_CANDIDATES", "AUTO_V_CANDIDATES"]

# impl="auto" resolves to "fused"; "reference" is the plain einsum oracle
IMPLS = ("reference", "dense", "ragged", "onthefly", "fused")
# the measured sweep of impl="auto" times the recurrence schedules (the
# table ones stay available by explicit request)
AUTO_IMPL_CANDIDATES = ("fused", "onthefly")
AUTO_V_CANDIDATES = autotune.V_CANDIDATES

# the schedules that read the plan's dense (K, L, J) Wigner table
_TABLE_IMPLS = ("reference", "dense", "ragged")

# cluster tile of the l0 schedule; plans pad K to a multiple of it
_DEF_TK = 8

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Resolved execution schedule of one Transform.

    ``source``: "explicit" (the caller fixed V), "static" (the
    :data:`repro_torch.kernels.autotune.V_RULE` lane-width rule) or
    "measured" (:func:`repro_torch.kernels.autotune.autotune_dwt`'s sweep,
    cached on disk; ``per_transform_s`` is the winner's time).
    ``smem_bytes``: shared memory of the largest block the schedule's
    kernels launch (0 for the reference einsum).  ``tk``: the cluster tile
    of the l0 schedule (on a mesh plan, of the per-rank cluster shard).
    ``tl``: the degree tile of the ragged work list (B for every other
    schedule, which has none to set).  ``lchunk``: None for the monolithic
    fused kernels, else the l-chunk of the streaming kernels;
    ``precision``: "fp32" (the plan dtype) or "bf16".  ``n_shards``: the
    mesh decomposition the schedule was resolved for; ``overlap``: the
    mesh batch executors' mode ("off" | "pipelined"; "off" without a
    mesh).
    """

    impl: str               # one of IMPLS
    V: int                  # lane width of the batch executors
    tk: int                 # cluster tile of the l0 schedule
    tl: int
    source: str
    smem_bytes: int
    batch_bytes: int        # device bytes of one V-lane batch call
    lchunk: int | None = None
    precision: str = "fp32"
    window_bytes: int = 0   # the streaming kernels' window stack
    n_shards: int = 1
    overlap: str = "off"
    per_transform_s: float | None = None    # tune="measure" only

    @property
    def inverse_impl(self) -> str:
        """iDWT twin: the ragged grid has no inverse kernel; its plans
        run the inverse on the dense grid with the same tiles."""
        return "dense" if self.impl == "ragged" else self.impl


def _tune_mode(tune) -> str:
    if tune is None:
        tune = os.environ.get("REPRO_PLAN_TUNE", "static")
    if tune not in ("static", "measure"):
        raise ValueError(f"tune must be 'static' or 'measure', got {tune!r}")
    return tune


def _shard_tk(tk: int, K_local: int) -> int:
    """Largest cluster tile <= tk dividing the per-rank cluster count."""
    return max(t for t in range(1, min(tk, K_local) + 1) if K_local % t == 0)


def _resolve_overlap(overlap, n_shards: int) -> str:
    """Explicit overlap= passthrough, else the static rule (mesh plans of
    more than one shard pipeline)."""
    if overlap is None:
        return autotune.static_overlap(n_shards)
    return parallel.check_overlap_mode(overlap)


def _padded_clusters(B: int) -> int:
    """K of a plan: the B (B + 1) / 2 clusters padded to the tile."""
    return -(-(B * (B + 1) // 2) // _DEF_TK) * _DEF_TK


def _check_device_memory(B: int, itemsize: int, device, *, table: bool,
                         lchunk, precision: str, mesh: bool,
                         overlap: str = "off") -> None:
    """Refuse a plan whose V = 1 transform does not fit the device (the
    dense table included; a mesh plan's executor on whole grids, in its
    overlap mode), before anything is built."""
    need = autotune.estimate_batch_bytes(
        B, _padded_clusters(B), 1, itemsize, lchunk=lchunk,
        precision=precision, table=table, whole_grids=mesh or None,
        overlap=overlap)
    have = autotune.device_memory_bytes(device)
    if need > have:
        raise ValueError(
            f"one B={B} transform needs ~{need} bytes of {device} memory "
            f"(autotune.estimate_batch_bytes at V=1"
            f"{', with the dense table' if table else ''}), over its {have}")


def _static_schedule(soft_plan: SoftPlan, impl: str, V, tl: int, lchunk,
                     precision: str, n_shards: int = 1,
                     overlap=None, mesh: bool = False) -> Schedule:
    """The kernels' block against Hopper's per-block budget and the
    widest lane width whose batch buffers -- with the plan's dense table,
    when it has one -- fit (V="auto").  ``lchunk`` is resolved by the
    caller (:func:`repro_torch.kernels.autotune.static_lchunk`: an
    explicit lchunk is honoured, bf16 always streams, fp32 streams only
    when asked to).  A mesh plan's tile divides the per-rank cluster
    count (that is the kernel each rank launches), its batch buffers are
    counted on whole grids (the executor's stages do not run in slabs),
    and its batch mode resolves by :func:`_resolve_overlap` unless the
    caller fixed it.
    """
    K, B = soft_plan.n_padded, soft_plan.B
    itemsize = torch.empty((), dtype=soft_plan.dtype).element_size()
    impl = "fused" if impl == "auto" else impl
    if soft_plan.streaming and impl in _TABLE_IMPLS:
        raise ValueError(
            f"impl={impl!r} needs the dense Wigner table, but this "
            f"B={B} plan was built streaming (d=None); use the recurrence "
            f"family (impl='fused'/'onthefly') or plan with "
            f"streaming=False")
    omode = _resolve_overlap(overlap, n_shards)
    mem = dict(lchunk=lchunk, precision=precision,
               table=not soft_plan.streaming, whole_grids=mesh or None,
               overlap=omode if mesh else "off")
    if V == "auto":
        V = autotune.static_lane_width(B, K, itemsize, soft_plan.device,
                                       **mem)
        source = "static"
    else:
        source = "explicit"
    smem = autotune.schedule_smem_bytes(impl, B, V, itemsize, lchunk=lchunk,
                                        tl=tl)
    tk = _shard_tk(_DEF_TK, K // n_shards) if n_shards > 1 else \
        max(t for t in (1, 2, 4, _DEF_TK) if K % t == 0)
    return Schedule(impl, V, tk, tl, source, smem,
                    autotune.estimate_batch_bytes(B, K, V, itemsize, **mem),
                    lchunk, precision,
                    autotune.window_bytes(B, K, lchunk, precision, itemsize),
                    n_shards=n_shards, overlap=omode)


def _measured_schedule(soft_plan: SoftPlan, impl: str, V, tl: int, lchunk,
                       precision: str, reps: int, cache, n_shards: int = 1,
                       overlap=None, mesh=None, axis=None) -> Schedule:
    """Resolve by the measured sweep (disk-cached winners).

    Mesh plans of several shards sweep the per-rank cluster shard: their
    local kernel is always the fused family, so "auto" times one fused
    sweep.  When the overlap mode is not fixed, those plans also time the
    distributed batch under both modes
    (:func:`repro_torch.kernels.autotune.autotune_overlap`) and take the
    faster.  On a mesh the first rank's winner is every rank's: the
    ranks must launch the same chunks.
    """
    if lchunk is not None or precision == "bf16":
        impls = ("fused",)      # only the fused family has a streaming kernel
    elif n_shards > 1:
        impls = ("fused",) if impl == "auto" else (impl,)
    else:
        impls = AUTO_IMPL_CANDIDATES if impl == "auto" else (impl,)
    Vs = AUTO_V_CANDIDATES if V == "auto" else (V,)
    best, best_impl = None, None
    for im in impls:
        cfg = autotune.autotune_dwt(soft_plan, im, Vs=Vs, reps=reps,
                                    cache=cache, n_shards=n_shards,
                                    lchunk=lchunk,
                                    precision=precision if im == "fused"
                                    else "fp32", overlap=overlap)
        if best is None or cfg["per_transform_s"] < best["per_transform_s"]:
            best, best_impl = cfg, im
    if mesh is not None:
        best, best_impl = parallel.broadcast_object(
            (best, best_impl), parallel.shard_group(mesh, axis))
    if overlap is None and n_shards > 1 and mesh is not None:
        omode = autotune.autotune_overlap(
            soft_plan, mesh, axis, V=best["V"],
            tk=_shard_tk(best["tk"], soft_plan.n_padded // n_shards),
            reps=reps, cache=cache)["overlap"]
    else:
        omode = _resolve_overlap(overlap, n_shards)
    base = _static_schedule(soft_plan, best_impl, best["V"],
                            best["tl"] if best_impl == "ragged" else tl,
                            lchunk, precision, n_shards, omode,
                            mesh=mesh is not None)
    return dataclasses.replace(base, tk=best["tk"], source="measured",
                               per_transform_s=best["per_transform_s"])


class Transform:
    """One planned SO(3) FFT configuration: schedule + owned resources +
    executors.

    Build via :func:`plan` (or ``repro_torch.plan(...)``).  Executors:

      forward / inverse              single transform, dense coefficient
                                     layout in/out; sharded over ``mesh``
                                     when one was planned
      forward_batch / inverse_batch  any request count, chunked onto the
                                     V-lane kernel launches (partial
                                     chunks zero-padded); on a mesh plan
                                     one all-to-all per chunk, serially
                                     or pipelined (``overlap=``)
      s2_forward / s2_inverse        the S^2 stage (repro_torch.so3.s2)
      engine / correlate             rotational matching on this plan
                                     (repro_torch.so3.CorrelationEngine)

    Inputs may be numpy arrays or tensors; they are moved to the plan's
    device.  Results are tensors on that device.  ``stats`` counts
    launches / packed transforms / padded lanes.
    """

    def __init__(self, *, soft_plan: SoftPlan, schedule: Schedule,
                 mesh=None, axis=None, n_shards: int = 1, n_buckets: int = 8,
                 tune: str = "static"):
        self.soft_plan = soft_plan
        self.schedule = schedule
        self.B = soft_plan.B
        self.dtype = soft_plan.dtype
        self.device = soft_plan.device
        self.mesh = mesh
        self.axis = axis
        self.n_shards = n_shards
        self.n_buckets = n_buckets
        self.tune = tune
        self.reset_stats()
        self._resources: dict = {}

    @property
    def impl(self) -> str:
        return self.schedule.impl

    @property
    def V(self) -> int:
        return self.schedule.V

    @property
    def cdtype(self) -> torch.dtype:
        return self.soft_plan.cdtype

    def reset_stats(self) -> None:
        self.stats = dict(launches=0, transforms=0, padded_lanes=0)

    def describe(self) -> dict:
        """One flat dict for logs / benchmark rows.

        ``smem_bytes`` is the kernels' shared memory per block, ``tl`` the
        ragged work list's degree tile and ``inverse_impl`` the schedule
        the inverse runs (ragged plans invert on the dense kernel),
        ``batch_bytes`` / ``v_rule`` how V was chosen (``tune`` the
        requested mode, ``source`` the resolved one, ``per_transform_s``
        a measured winner's time), ``lchunk`` /
        ``precision`` / ``window_bytes`` the streaming schedule (lchunk
        None: the monolithic fused kernels), and ``kernel_launches`` the
        process-wide launch counts of the CUDA kernels
        (the ``LAUNCHES`` of :mod:`repro_torch.kernels.dwt_fused`,
        ``.streaming``, ``.wigner_rec`` and ``.dwt``; zero on the CPU,
        where the plain versions run).  ``precision_bound_extrapolated``
        flags a bf16 schedule whose error bound is not a measurement.
        ``overlap`` is the mesh batch mode ("off" without a mesh); mesh
        plans also report the shard axes, the mesh shape along them, the
        per-rank cluster and beta counts, the lane width and the
        process-wide all-to-all counts
        (:data:`repro_torch.core.parallel.ALL_TO_ALLS`).  ``obs`` holds
        the process Recorder's plan / autotune / obs / ``so3.*`` counters
        (``so3.forward.slab_spectra``: the beta-slab forward's slab FFTs)
        and its plan, autotune, executor and ``so3.*`` stage histograms
        (the last two filled while tracing is on,
        :func:`repro_torch.obs.stage`)."""
        s = self.schedule
        sp = self.soft_plan
        rec = obs.get_recorder()
        out = {
            "B": self.B, "dtype": str(self.dtype).replace("torch.", ""),
            "device": str(self.device),
            "impl": s.impl, "inverse_impl": s.inverse_impl, "V": s.V,
            "tk": s.tk, "tl": s.tl, "tune": self.tune, "source": s.source,
            "per_transform_s": s.per_transform_s, "overlap": s.overlap,
            "n_shards": self.n_shards,
            "v_rule": autotune.V_RULE, "batch_bytes": s.batch_bytes,
            "streaming": sp.streaming,
            "lchunk": s.lchunk, "precision": s.precision,
            "window_bytes": s.window_bytes,
            "precision_bound_extrapolated": s.precision == "bf16" and
            self.B in autotune.PRECISION_BOUND_EXTRAPOLATED,
            "smem_bytes": s.smem_bytes,
            "smem_limit": autotune.SMEM_LIMIT_BYTES,
            "n_clusters": sp.n_clusters, "n_padded": sp.n_padded,
            "kernel_launches": {**dwt_fused.LAUNCHES,
                                **streaming_kernels.LAUNCHES,
                                **wigner_rec.LAUNCHES,
                                **dwt_kernels.LAUNCHES},
            "obs": {
                "counters": {k: v for k, v in rec.counters().items()
                             if k.startswith(("plan.", "autotune.", "obs.",
                                              "so3."))},
                "spans": rec.summary(prefix=("plan.", "autotune.",
                                             "executor.", "so3.")),
            },
        }
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names
            out.update({
                "mesh_axes": list(self.axis),
                "mesh_shape": [self.mesh.size(names.index(a))
                               for a in self.axis],
                "shard_clusters": sp.n_padded // self.n_shards,
                "shard_beta": 2 * self.B // self.n_shards,
                "lane_width": s.V,
                "all_to_alls": dict(parallel.ALL_TO_ALLS),
            })
        return out

    # -- owned resources (built once, cached on the Transform) ----------

    def _res(self, name, build):
        if name not in self._resources:
            self._resources[name] = build()
        return self._resources[name]

    def _make(self, maker, impl, batch):
        if self.schedule.impl == "reference":
            return None
        s = self.schedule
        return maker(self.soft_plan, impl, tk=s.tk, tl=s.tl,
                     lchunk=s.lchunk, precision=s.precision, batch=batch)

    @property
    def dwt_fn(self):
        """Single-transform (plan, rhs) DWT closure; None = einsum oracle."""
        return self._res("dwt_1", lambda: self._make(
            ops.make_dwt_fn, self.schedule.impl, None))

    @property
    def idwt_fn(self):
        return self._res("idwt_1", lambda: self._make(
            ops.make_idwt_fn, self.schedule.inverse_impl, None))

    @property
    def dwt_fn_batch(self):
        """V-lane batch DWT closure ((V, K, J, C, 2) rhs, one launch)."""
        return self._res("dwt_V", lambda: self._make(
            ops.make_dwt_fn, self.schedule.impl, self.schedule.V))

    @property
    def idwt_fn_batch(self):
        return self._res("idwt_V", lambda: self._make(
            ops.make_idwt_fn, self.schedule.inverse_impl, self.schedule.V))

    def shard_meta(self) -> parallel.ShardMeta:
        """Fused-kernel shard metadata (seeds / orders / per-tile l0s),
        computed once per plan and shared by both directions of the
        mesh executor.  The local cluster tile follows schedule.tk,
        shrunk to the largest divisor of the per-rank cluster count."""
        if self.mesh is None:
            raise ValueError("shard_meta() on a plan built without a mesh")
        kloc = self.soft_plan.n_padded // self.n_shards
        tk = _shard_tk(self.schedule.tk, kloc)
        return self._res("shard_meta", lambda: parallel.fused_shard_meta(
            self.soft_plan, self.n_shards, tk))

    def _local_dwt(self):
        def build():
            impl = self.schedule.impl
            if impl in ("fused", "onthefly"):
                return parallel.make_fused_local_dwt(
                    self.soft_plan, self.n_shards, meta=self.shard_meta())
            if impl in ("dense", "ragged"):
                slices = batched.bucket_boundaries(
                    self.soft_plan, self.n_shards, self.n_buckets)
                return parallel.make_bucketed_local_dwt(slices, self.B)
            return None          # reference: the plain einsum
        return self._res("local_dwt", build)

    def _local_idwt(self):
        def build():
            if self.schedule.impl in ("fused", "onthefly"):
                return parallel.make_fused_local_idwt(
                    self.soft_plan, self.n_shards, meta=self.shard_meta())
            return None          # the dense einsum (no bucketed inverse)
        return self._res("local_idwt", build)

    def executor(self) -> parallel.DistExecutor:
        """The mesh-resident :class:`repro_torch.core.parallel.DistExecutor`
        of this plan, built once: the shard group, the rank's table
        blocks and the local kernel closures.  Its batch default is the
        schedule's ``overlap`` (per-call ``overlap=`` overrides)."""
        if self.mesh is None:
            raise ValueError("executor() on a plan built without a mesh")
        return self._res("executor", lambda: parallel.DistExecutor(
            self.soft_plan, self.mesh, self.axis,
            lane_width=self.schedule.V, overlap=self.schedule.overlap,
            local_dwt=self._local_dwt(), local_idwt=self._local_idwt()))

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.cdtype)

    # -- executors: single transform ------------------------------------

    def forward(self, f, *, stats=None) -> torch.Tensor:
        """FSOFT: samples (2B, 2B, 2B) -> dense coefficients
        (B, 2B-1, 2B-1).  A mesh plan runs the sharded executor and
        returns the whole result on every rank."""
        stats = self.stats if stats is None else stats
        stats["launches"] += 1
        stats["transforms"] += 1
        f = self._as_input(f)
        if self.mesh is not None:
            return parallel.packed_to_dense(self.soft_plan,
                                            self.executor().forward(f))
        return batched.forward_clustered(self.soft_plan, f,
                                         dwt_fn=self.dwt_fn)

    def inverse(self, fhat, *, stats=None) -> torch.Tensor:
        """iFSOFT: dense coefficients -> samples (2B, 2B, 2B)."""
        stats = self.stats if stats is None else stats
        stats["launches"] += 1
        stats["transforms"] += 1
        fhat = self._as_input(fhat)
        if self.mesh is not None:
            return self.executor().inverse(
                parallel.dense_to_packed(self.soft_plan, fhat))
        return batched.inverse_clustered(self.soft_plan, fhat,
                                         idwt_fn=self.idwt_fn)

    # -- executors: V-lane batches --------------------------------------

    def forward_batch(self, fs, *, stats=None, overlap=None) -> torch.Tensor:
        """FSOFT of any request count: (n, 2B, 2B, 2B) -> (n, B, 2B-1,
        2B-1).  Chunks of V ride one lane-packed kernel launch; the final
        partial chunk is zero-padded to V lanes.  On a mesh plan each
        chunk is one sharded launch (one all-to-all for all V lanes),
        run serially or through the executor's two-slot pipeline as the
        schedule's ``overlap`` says; ``overlap=`` overrides it for one
        call (mesh plans only)."""
        return self._batch(fs, batched.forward_clustered_batch,
                           lambda: self.dwt_fn_batch, "dwt_fn",
                           out_shape=(self.B, 2 * self.B - 1, 2 * self.B - 1),
                           stats=stats, overlap=overlap)

    def inverse_batch(self, fhats, *, stats=None,
                      overlap=None) -> torch.Tensor:
        """iFSOFT of any request count: (n, B, 2B-1, 2B-1) -> (n, 2B,
        2B, 2B); see :meth:`forward_batch`."""
        return self._batch(fhats, batched.inverse_clustered_batch,
                           lambda: self.idwt_fn_batch, "idwt_fn",
                           out_shape=(2 * self.B,) * 3, stats=stats,
                           overlap=overlap)

    def _batch(self, xs, engine, get_fn, fn_kw, out_shape, stats,
               overlap=None):
        stats = self.stats if stats is None else stats
        if overlap is not None:
            parallel.check_overlap_mode(overlap)   # typos before routing
            if overlap != "off" and self.mesh is None:
                raise ValueError(
                    f"overlap={overlap!r} needs a mesh plan; local "
                    "batches have no collective to pipeline")
        xs = self._as_input(xs)
        n_total = xs.shape[0]
        if n_total == 0:
            return torch.zeros((0,) + out_shape, dtype=self.cdtype,
                               device=self.device)
        if self.mesh is not None:     # lane-packed sharded launches
            ex = self.executor()
            if fn_kw == "dwt_fn":
                packed = ex.forward_batch(xs, stats=stats, overlap=overlap)
                return parallel.packed_to_dense_batch(self.soft_plan, packed)
            packed = parallel.dense_to_packed_batch(self.soft_plan, xs)
            return ex.inverse_batch(packed, stats=stats, overlap=overlap)
        V = self.schedule.V
        fn = get_fn()
        outs = []
        direction = "forward" if fn_kw == "dwt_fn" else "inverse"
        lanes = f"so3.{direction}.lanes"
        for n0 in range(0, n_total, V):
            with obs.stage(lanes, self.device):
                chunk, n = ops.pad_lanes(xs[n0: n0 + V], V)
            # the chunk's device time, while tracing is on (the stages
            # inside it tile it; no sync here)
            with obs.stage("executor.chunk", self.device, mode="local",
                           direction=direction, chunk=n0 // V, lanes=n):
                out = engine(self.soft_plan, chunk, **{fn_kw: fn})
            stats["launches"] += 1
            stats["transforms"] += n
            stats["padded_lanes"] += V - n
            outs.append(out[:n])
        # one chunk: its output as it is, without a copy of every grid
        if len(outs) == 1:
            return outs[0]
        with obs.stage(lanes, self.device):
            return torch.cat(outs, dim=0)

    # -- executors: S^2 stage and correlation ---------------------------

    def s2_forward(self, samples) -> torch.Tensor:
        """S^2 analysis: samples (2B, 2B) -> coefficients (B, 2B-1) on
        the plan's device."""
        from repro_torch.so3 import s2
        return s2.s2_analysis(samples, self.B, device=self.device)

    def s2_inverse(self, flm) -> torch.Tensor:
        """S^2 synthesis: coefficients (B, 2B-1) -> samples (2B, 2B) on
        the plan's device."""
        from repro_torch.so3 import s2
        return s2.s2_synthesis(flm, device=self.device)

    def engine(self):
        """The rotational-matching engine bound to this plan (cached)."""
        from repro_torch.so3.correlate import CorrelationEngine
        return self._res("engine", lambda: CorrelationEngine(transform=self))

    def correlate(self, f, g, *, refine: bool = True):
        """Rotation maximizing <f, Lambda(R) g> for one S^2 pair."""
        return self.engine().match(f, g, refine=refine)


# ---------------------------------------------------------------------------
# the planner entry point + plan cache
# ---------------------------------------------------------------------------

_CACHE: collections.OrderedDict = collections.OrderedDict()
_CACHE_MAX = 16
_CACHE_STATS = {"hits": 0, "misses": 0, "mesh_hits": 0, "mesh_misses": 0}


def clear_cache() -> None:
    """Drop memoized Transforms and built plans (testing / benchmarking
    hook).  The per-plan memos of :mod:`repro_torch.kernels.ops` and
    :mod:`repro_torch.core.batched` are weak: what a plan alone held --
    its dense table, seeds, windows, work lists -- is freed with the last
    Transform or plan the caller still holds."""
    _CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0
    batched.clear_plan_cache()


def evict_mesh(mesh) -> int:
    """Drop the memoized Transforms planned on ``mesh`` (and what they
    alone held: the shard group's executor, the seeds on the device);
    returns how many went.  Code that ends a mesh's process group calls
    it (:func:`repro_torch.core.parallel.local_mesh` does on exit): a
    cached plan of a dead group would fail at its first collective, and
    the cache keys meshes by identity, which a later mesh may reuse."""
    gone = [k for k, t in _CACHE.items() if t.mesh is mesh]
    for k in gone:
        del _CACHE[k]
    return len(gone)


def warm_bandwidths() -> dict[int, int]:
    """{B: count of memoized Transforms at that bandwidth} -- the
    plan-cache-aware scheduling hook of the serving tier: a scheduler
    (:class:`repro_torch.so3.SO3Service`) prefers bandwidths whose plans
    are already built over cold ones that would stall a lane behind a
    plan construction."""
    out: dict[int, int] = {}
    for t in _CACHE.values():
        out[t.B] = out.get(t.B, 0) + 1
    return out


def cache_stats() -> dict:
    """Planner cache counters.  hits / misses count every lookup;
    mesh_hits / mesh_misses the mesh plans among them, and mesh_size is
    how many cached Transforms hold a mesh.  ``soft_plan_cache`` surfaces
    the core.batched plan memo."""
    return dict(_CACHE_STATS, size=len(_CACHE),
                mesh_size=sum(1 for t in _CACHE.values()
                              if t.mesh is not None),
                soft_plan_cache=batched.plan_cache_stats())


# Dense-table host-footprint threshold (bytes) above which plan() builds
# without the dense Wigner table (the reference's threshold).
_DEF_DENSE_TABLE_BYTES = 512 * 1024 * 1024


_LAST_PEAK_RSS = 0


def dense_table_bytes_limit() -> int:
    """Auto-streaming threshold; override with $REPRO_PLAN_DENSE_TABLE_BYTES."""
    return int(os.environ.get("REPRO_PLAN_DENSE_TABLE_BYTES",
                              _DEF_DENSE_TABLE_BYTES))


def _host_peak_rss() -> int | None:
    """The process's peak RSS in bytes: VmHWM of /proc/self/status (which
    a spawned process does not inherit), getrusage where there is no
    /proc, None on a host with neither."""
    peak = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    if peak is None:
        try:
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):      # non-POSIX host
            return None
    return peak


def _bump_host_peak_rss() -> None:
    """Advance the monotonic ``plan.host_peak_rss`` counter to the
    process's peak RSS, sampled after every plan build and incremented
    only when the peak grew: its total is the peak as of the last build
    that raised it, and a dense table sneaking into a streaming path shows
    as a jump of the counter."""
    global _LAST_PEAK_RSS
    peak = _host_peak_rss()
    if peak is not None and peak > _LAST_PEAK_RSS:
        obs.inc("plan.host_peak_rss", peak - _LAST_PEAK_RSS)
        _LAST_PEAK_RSS = peak


def reset_host_peak_rss() -> None:
    """Restart the ``plan.host_peak_rss`` baseline, as in a fresh process:
    the next build charges the whole peak.  A caller that clears the
    recorder calls it, so the counter's total again reads the peak (and
    shows only if a plan is built after it)."""
    global _LAST_PEAK_RSS
    _LAST_PEAK_RSS = 0


def plan(B: int, dtype=torch.float64, *, impl: str = "auto", V="auto",
         tl: int | None = None, streaming: bool | None = None, device=None,
         lchunk: int | None = None, precision: str | None = None,
         mesh=None, axis=("data", "model"), tune: str | None = None,
         overlap: str | None = None, n_buckets: int = 8,
         tune_reps: int = 3, tune_cache=None) -> Transform:
    """Plan one SO(3) FFT configuration; returns a memoized Transform.

    dtype: torch.float64 (default) or torch.float32.
    impl: "auto" (= "fused"), or one of :data:`IMPLS`: "fused" (the
          ragged on-the-fly CUDA kernels), "onthefly" (the same
          recurrence over every degree of every cluster, no skip),
          "dense" (a tiled contraction against the plan's resident
          (K, L, J) Wigner table), "ragged" (the dense forward on the
          host work list of (cluster-tile, l-tile) blocks; its inverse
          runs on "dense") or "reference" (the plain einsum oracle on the
          table).
    V:    "auto" (:data:`repro_torch.kernels.autotune.V_RULE`) or an
          explicit lane width for the batch executors.
    tl:   the degree tile of the "ragged" work list (default B; it must
          divide B, as in the reference, whatever the impl).  The other
          schedules have no tile to set: they ignore it.
    streaming: build the plan WITHOUT the dense (K, L, J) Wigner table.
          None -- the default -- engages it for recurrence-family plans
          ("auto", "fused", "onthefly") without a mesh whose dense
          table's host footprint would exceed
          $REPRO_PLAN_DENSE_TABLE_BYTES (512 MiB: B <= 64 builds dense,
          B >= 128 streams), as the reference does, and every
          recurrence-family mesh plan (its local kernels read the
          recurrence seeds only; the reference builds the table there
          too).  The table schedules always build the table, on a mesh
          too; streaming=True with one of them raises ValueError.
    device: None means the card (raises if there is none); pass "cpu" to
          run the kernels' plain versions on the CPU.
    lchunk: run the l-chunked streaming kernels with chunks of lchunk
          degrees (must divide B; fused only, no mesh).  None: the
          monolithic fused kernels under fp32, one chunk of B under bf16
          (:func:`repro_torch.kernels.autotune.static_lchunk`).  A block
          fits the card's per-block budget at every B <= 512; past it the
          plan raises ValueError, whatever the l-chunk.
    precision: None / "fp32" (the plan dtype throughout), "bf16" (bf16
          window storage and Wigner rows, plan-dtype recurrence and sums;
          always streaming; fused only), or "auto" (bf16 only for
          float32 plans at B >= 128; see
          :func:`repro_torch.kernels.autotune.static_precision`).  None
          never downgrades.
    mesh / axis: plan the sharded executors on a
          ``torch.distributed.device_mesh.DeviceMesh`` whose device type
          is ``device``'s, sharded over the flattened ``axis`` dims (n
          shards): the cluster axis is padded to a multiple of n and
          dealt in the shard-balanced order
          (:func:`repro_torch.core.batched.shard_balanced_order`), and
          every executor runs through :meth:`Transform.executor`.  2B
          must divide by n.  Without a process group this raises; a mesh
          plan never runs locally.
    overlap: None (mesh plans of more than one shard pipeline; measured
          under tune="measure") or "off" | "pipelined" (mesh plans only).
    n_buckets: extent buckets of a dense / ragged mesh plan's local
          contraction.
    tune: "static" (default) or "measure" (the measured sweep of
          :func:`repro_torch.kernels.autotune.autotune_dwt`, winners
          cached on disk at ``tune_cache`` or
          :func:`repro_torch.kernels.autotune.cache_path`, ``tune_reps``
          timed calls a candidate).  $REPRO_PLAN_TUNE sets the default.
          An explicit tl pins the schedule, which then resolves
          statically.

    A plan whose V = 1 transform does not fit the device's memory
    (:func:`repro_torch.kernels.autotune.estimate_batch_bytes`, the dense
    table included) raises ValueError before anything is built.
    Identical configurations return the SAME Transform object (meshes are
    told apart by identity).
    """
    mode = _tune_mode(tune)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    precision = autotune.static_precision(B, precision, dtype=dtype)
    if impl == "reference":
        if lchunk is not None or precision == "bf16":
            raise ValueError("lchunk / precision='bf16' run the streaming "
                             "kernels, which exist only for impl='fused' "
                             "(impl='reference' is the plain einsum)")
    else:
        ops.check_impl("fused" if impl == "auto" else impl, lchunk,
                       precision)
    if lchunk is not None:
        lchunk = streaming_kernels.check_lchunk(B, lchunk)
    if V != "auto" and (not isinstance(V, int) or V < 1):
        raise ValueError(f"V must be 'auto' or a positive int, got {V!r}")
    if overlap is not None:
        parallel.check_overlap_mode(overlap)       # typos before mesh advice
        if overlap != "off" and mesh is None:
            raise ValueError(
                f"overlap={overlap!r} needs a mesh plan; local batches "
                "have no collective to pipeline")
    tl_given = tl
    _, tl, _ = dwt_kernels.check_tiles(_padded_clusters(B), B, 2 * B,
                                       _DEF_TK, B if tl is None else tl,
                                       2 * B)
    if impl != "ragged":
        tl = B
    axis = parallel.mesh_axes(axis)
    n_shards = 1
    if mesh is not None:
        if lchunk is not None or precision == "bf16":
            raise ValueError(
                "streaming schedules (lchunk/bf16) are not wired into the "
                "sharded executor; plan without a mesh")
        n_shards = parallel.mesh_shards(mesh, axis)   # raises without a group
        if (2 * B) % n_shards:
            raise ValueError(
                f"mesh with {n_shards} shards cannot split the beta axis: "
                f"2B = {2 * B} is not divisible by {n_shards} (use a mesh "
                f"whose shard-axis product divides {2 * B})")
    device = resolve_device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if streaming is None:
        streaming = impl not in _TABLE_IMPLS and (
            mesh is not None or autotune.dense_table_host_bytes(
                B, itemsize) > dense_table_bytes_limit())
    elif streaming and impl in _TABLE_IMPLS:
        raise ValueError(f"streaming=True needs a recurrence-family plan "
                         f"(impl 'auto'/'fused'/'onthefly'); impl={impl!r} "
                         f"reads the dense Wigner table")
    key = (B, dtype, impl, V, tl, bool(streaming), str(device), lchunk,
           precision, None if mesh is None else (id(mesh), axis), mode,
           overlap, n_buckets, None if tune_cache is None else
           str(tune_cache))
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        obs.inc("plan.cache.hit")
        if mesh is not None:
            _CACHE_STATS["mesh_hits"] += 1
        _CACHE.move_to_end(key)
        return hit
    _CACHE_STATS["misses"] += 1
    obs.inc("plan.cache.miss")
    if mesh is not None:
        _CACHE_STATS["mesh_misses"] += 1
    if impl in ("auto", "fused", "onthefly"):
        # raises where no recurrence block fits; onthefly never streams
        auto = autotune.static_lchunk(B=B, itemsize=itemsize,
                                      precision=precision)
        lchunk = auto if lchunk is None else lchunk
    _check_device_memory(B, itemsize, device, table=not streaming,
                         lchunk=lchunk, precision=precision,
                         mesh=mesh is not None,
                         overlap="off" if mesh is None
                         else _resolve_overlap(overlap, n_shards))
    with obs.span("plan.build", B=B, impl=impl, tune=mode,
                  mesh=mesh is not None, streaming=bool(streaming),
                  device=str(device)):
        if mesh is not None:
            # pad_to = n_shards keeps the padding minimal, and the
            # shard-balanced order is dealt over the PADDED count so every
            # shard's block stays extent-sorted
            l_start = clusters_mod.build_cluster_table(B).rep[:, 0]
            n_padded = -(-len(l_start) // n_shards) * n_shards
            order = batched.shard_balanced_order(l_start, n_shards,
                                                 n_padded=n_padded)
            soft_plan = batched.build_plan(B, dtype=dtype, pad_to=n_shards,
                                           order=order,
                                           streaming=bool(streaming),
                                           device=device)
            parallel.check_mesh_compat(soft_plan, n_shards)
        else:
            soft_plan = batched.build_plan(
                B, dtype=dtype, pad_to=_DEF_TK, streaming=bool(streaming),
                device=device)
        # the measured sweep exists for the recurrence family on a mesh
        # of several shards; other impls there resolve statically
        measurable = impl in ("auto", "fused", "onthefly") or n_shards == 1
        with obs.span("plan.schedule", B=B, impl=impl, tune=mode,
                      n_shards=n_shards):
            if mode == "measure" and impl != "reference" and measurable \
                    and tl_given is None:
                schedule = _measured_schedule(
                    soft_plan, impl, V, tl, lchunk, precision, tune_reps,
                    tune_cache, n_shards, overlap, mesh, axis)
            else:
                schedule = _static_schedule(soft_plan, impl, V, tl, lchunk,
                                            precision, n_shards, overlap,
                                            mesh=mesh is not None)
        t = Transform(soft_plan=soft_plan, schedule=schedule, mesh=mesh,
                      axis=axis if mesh is not None else None,
                      n_shards=n_shards, n_buckets=n_buckets, tune=mode)
    _bump_host_peak_rss()
    _CACHE[key] = t
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return t
