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

The port of ``repro.plan.transform`` for one device.  Options of the
reference that this port does not run yet raise NotImplementedError
naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import torch

from repro_torch import obs
from repro_torch.core import batched
from repro_torch.core.batched import SoftPlan, resolve_device
from repro_torch.kernels import autotune, dwt_fused, ops, wigner_rec
from repro_torch.kernels import dwt as dwt_kernels
from repro_torch.kernels import streaming as streaming_kernels

__all__ = ["Transform", "Schedule", "plan", "clear_cache", "cache_stats",
           "warm_bandwidths", "dense_table_bytes_limit", "IMPLS"]

# impl="auto" resolves to "fused"; "reference" is the plain einsum oracle
IMPLS = ("reference", "dense", "ragged", "onthefly", "fused")

# the schedules that read the plan's dense (K, L, J) Wigner table
_TABLE_IMPLS = ("reference", "dense", "ragged")

# cluster tile of the l0 schedule; plans pad K to a multiple of it
_DEF_TK = 8

_NOT_PORTED = {
    "mesh": "ROADMAP.md queue 1 item 8 (DistExecutor on torch.distributed)",
    "measure": "ROADMAP.md queue 1 item 7 (measured autotuning)",
}


def _not_ported(what: str, key: str):
    return NotImplementedError(f"{what} is not ported yet: "
                               f"{_NOT_PORTED[key]}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Resolved execution schedule of one Transform.

    ``source``: "explicit" (the caller fixed V) or "static" (the
    :data:`repro_torch.kernels.autotune.V_RULE` lane-width rule).
    ``smem_bytes``: shared memory of the largest block the schedule's
    kernels launch (0 for the reference einsum).  ``tl``: the degree tile
    of the ragged work list (B for every other schedule, which has none
    to set).  ``lchunk``: None for the monolithic fused
    kernels, else the l-chunk of the streaming kernels; ``precision``:
    "fp32" (the plan dtype) or "bf16".
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

    @property
    def inverse_impl(self) -> str:
        """iDWT twin: the ragged grid has no inverse kernel; its plans
        run the inverse on the dense grid with the same tiles."""
        return "dense" if self.impl == "ragged" else self.impl


def _padded_clusters(B: int) -> int:
    """K of a plan: the B (B + 1) / 2 clusters padded to the tile."""
    return -(-(B * (B + 1) // 2) // _DEF_TK) * _DEF_TK


def _check_device_memory(B: int, itemsize: int, device, *, table: bool,
                         lchunk, precision: str) -> None:
    """Refuse a plan whose V = 1 transform does not fit the device (the
    dense table included), before anything is built."""
    need = autotune.estimate_batch_bytes(
        B, _padded_clusters(B), 1, itemsize, lchunk=lchunk,
        precision=precision, table=table)
    have = autotune.device_memory_bytes(device)
    if need > have:
        raise ValueError(
            f"one B={B} transform needs ~{need} bytes of {device} memory "
            f"(autotune.estimate_batch_bytes at V=1"
            f"{', with the dense table' if table else ''}), over its {have}")


def _static_schedule(soft_plan: SoftPlan, impl: str, V, tl: int, lchunk,
                     precision: str) -> Schedule:
    """The kernels' block against Hopper's per-block budget and the
    widest lane width whose batch buffers -- with the plan's dense table,
    when it has one -- fit (V="auto").  ``lchunk`` is resolved by the
    caller (:func:`repro_torch.kernels.autotune.static_lchunk`: an
    explicit lchunk is honoured, bf16 always streams, fp32 streams only
    when asked to).
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
    mem = dict(lchunk=lchunk, precision=precision,
               table=not soft_plan.streaming)
    if V == "auto":
        V = autotune.static_lane_width(B, K, itemsize, soft_plan.device,
                                       **mem)
        source = "static"
    else:
        source = "explicit"
    smem = 0
    if impl in ("fused", "onthefly"):
        smem = max(autotune.estimate_smem_bytes(
            2 * B, itemsize, inverse=inv, C2=V * 16,
            L=lchunk if lchunk is not None and not inv else B)
            for inv in (False, True))
    elif impl in ("dense", "ragged"):
        spans = ((tl if impl == "ragged" else B, False), (2 * B, True))
        smem = max(autotune.dense_smem_bytes(sp, V * 16, itemsize,
                                             inverse=inv)
                   for sp, inv in spans)
    return Schedule(impl, V, _DEF_TK, tl, source, smem,
                    autotune.estimate_batch_bytes(B, K, V, itemsize, **mem),
                    lchunk, precision,
                    autotune.window_bytes(B, K, lchunk, precision, itemsize))


class Transform:
    """One planned SO(3) FFT configuration on one device: schedule +
    owned resources + executors.

    Build via :func:`plan` (or ``repro_torch.plan(...)``).  Executors:

      forward / inverse              single transform, dense coefficient
                                     layout in/out
      forward_batch / inverse_batch  any request count, chunked onto the
                                     V-lane kernel launches (partial
                                     chunks zero-padded)
      s2_forward / s2_inverse        the S^2 stage (repro_torch.so3.s2)
      engine / correlate             rotational matching on this plan
                                     (repro_torch.so3.CorrelationEngine)

    Inputs may be numpy arrays or tensors; they are moved to the plan's
    device.  Results are tensors on that device.  ``stats`` counts
    launches / packed transforms / padded lanes.
    """

    def __init__(self, *, soft_plan: SoftPlan, schedule: Schedule):
        self.soft_plan = soft_plan
        self.schedule = schedule
        self.B = soft_plan.B
        self.dtype = soft_plan.dtype
        self.device = soft_plan.device
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
        ``batch_bytes`` / ``v_rule`` how V was chosen, ``lchunk`` /
        ``precision`` / ``window_bytes`` the streaming schedule (lchunk
        None: the monolithic fused kernels), and ``kernel_launches`` the
        process-wide launch counts of the CUDA kernels
        (the ``LAUNCHES`` of :mod:`repro_torch.kernels.dwt_fused`,
        ``.streaming``, ``.wigner_rec`` and ``.dwt``; zero on the CPU,
        where the plain versions run).  ``precision_bound_extrapolated``
        flags a bf16 schedule whose error bound is not a measurement."""
        s = self.schedule
        sp = self.soft_plan
        rec = obs.get_recorder()
        return {
            "B": self.B, "dtype": str(self.dtype).replace("torch.", ""),
            "device": str(self.device),
            "impl": s.impl, "inverse_impl": s.inverse_impl, "V": s.V,
            "tk": s.tk, "tl": s.tl, "source": s.source,
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
                             if k.startswith("plan.")},
                "spans": rec.summary(prefix=("plan.", "executor.")),
            },
        }

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

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.cdtype)

    # -- executors: single transform ------------------------------------

    def forward(self, f, *, stats=None) -> torch.Tensor:
        """FSOFT: samples (2B, 2B, 2B) -> dense coefficients
        (B, 2B-1, 2B-1)."""
        stats = self.stats if stats is None else stats
        stats["launches"] += 1
        stats["transforms"] += 1
        return batched.forward_clustered(self.soft_plan, self._as_input(f),
                                         dwt_fn=self.dwt_fn)

    def inverse(self, fhat, *, stats=None) -> torch.Tensor:
        """iFSOFT: dense coefficients -> samples (2B, 2B, 2B)."""
        stats = self.stats if stats is None else stats
        stats["launches"] += 1
        stats["transforms"] += 1
        return batched.inverse_clustered(self.soft_plan,
                                         self._as_input(fhat),
                                         idwt_fn=self.idwt_fn)

    # -- executors: V-lane batches --------------------------------------

    def forward_batch(self, fs, *, stats=None) -> torch.Tensor:
        """FSOFT of any request count: (n, 2B, 2B, 2B) -> (n, B, 2B-1,
        2B-1).  Chunks of V ride one lane-packed kernel launch; the final
        partial chunk is zero-padded to V lanes."""
        return self._batch(fs, batched.forward_clustered_batch,
                           lambda: self.dwt_fn_batch, "dwt_fn",
                           out_shape=(self.B, 2 * self.B - 1, 2 * self.B - 1),
                           stats=stats)

    def inverse_batch(self, fhats, *, stats=None) -> torch.Tensor:
        """iFSOFT of any request count: (n, B, 2B-1, 2B-1) -> (n, 2B,
        2B, 2B); see :meth:`forward_batch`."""
        return self._batch(fhats, batched.inverse_clustered_batch,
                           lambda: self.idwt_fn_batch, "idwt_fn",
                           out_shape=(2 * self.B,) * 3, stats=stats)

    def _batch(self, xs, engine, get_fn, fn_kw, out_shape, stats):
        stats = self.stats if stats is None else stats
        xs = self._as_input(xs)
        n_total = xs.shape[0]
        if n_total == 0:
            return torch.zeros((0,) + out_shape, dtype=self.cdtype,
                               device=self.device)
        V = self.schedule.V
        fn = get_fn()
        outs = []
        direction = "forward" if fn_kw == "dwt_fn" else "inverse"
        for n0 in range(0, n_total, V):
            chunk, n = ops.pad_lanes(xs[n0: n0 + V], V)
            # host-side dispatch span (launches stay async; no sync here)
            with obs.span("executor.chunk", mode="local",
                          direction=direction, chunk=n0 // V, lanes=n):
                out = engine(self.soft_plan, chunk, **{fn_kw: fn})
            stats["launches"] += 1
            stats["transforms"] += n
            stats["padded_lanes"] += V - n
            outs.append(out[:n])
        # one chunk: its output as it is, without a copy of every grid
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

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
_CACHE_STATS = {"hits": 0, "misses": 0}


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
    """Planner cache counters; ``soft_plan_cache`` surfaces the
    core.batched plan memo."""
    return dict(_CACHE_STATS, size=len(_CACHE),
                soft_plan_cache=batched.plan_cache_stats())


# Dense-table host-footprint threshold (bytes) above which plan() builds
# without the dense Wigner table (the reference's threshold).
_DEF_DENSE_TABLE_BYTES = 512 * 1024 * 1024


def dense_table_bytes_limit() -> int:
    """Auto-streaming threshold; override with $REPRO_PLAN_DENSE_TABLE_BYTES."""
    return int(os.environ.get("REPRO_PLAN_DENSE_TABLE_BYTES",
                              _DEF_DENSE_TABLE_BYTES))


def plan(B: int, dtype=torch.float64, *, impl: str = "auto", V="auto",
         tl: int | None = None, streaming: bool | None = None, device=None,
         lchunk: int | None = None, precision: str | None = None,
         mesh=None, tune: str | None = None) -> Transform:
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
          ("auto", "fused", "onthefly") whose dense table's host
          footprint would exceed $REPRO_PLAN_DENSE_TABLE_BYTES (512 MiB:
          B <= 64 builds dense, B >= 128 streams), as the reference
          does; the table schedules always build the table.
          streaming=True with one of them raises ValueError.
    device: None means the card (raises if there is none); pass "cpu" to
          run the kernels' plain versions on the CPU.
    lchunk: run the l-chunked streaming kernels with chunks of lchunk
          degrees (must divide B; fused only).  None: the monolithic
          fused kernels under fp32, one chunk of B under bf16
          (:func:`repro_torch.kernels.autotune.static_lchunk`).  A block
          fits the card's per-block budget at every B <= 512; past it the
          plan raises ValueError, whatever the l-chunk.
    precision: None / "fp32" (the plan dtype throughout), "bf16" (bf16
          window storage and Wigner rows, plan-dtype recurrence and sums;
          always streaming; fused only), or "auto" (bf16 only for
          float32 plans at B >= 128; see
          :func:`repro_torch.kernels.autotune.static_precision`).  None
          never downgrades.

    A plan whose V = 1 transform does not fit the device's memory
    (:func:`repro_torch.kernels.autotune.estimate_batch_bytes`, the dense
    table included) raises ValueError before anything is built.
    Identical configurations return the SAME Transform object.
    """
    if mesh is not None:
        raise _not_ported("plan(mesh=...)", "mesh")
    if tune not in (None, "static"):
        if tune == "measure":
            raise _not_ported("plan(tune='measure')", "measure")
        raise ValueError(f"tune must be 'static' or 'measure', got {tune!r}")
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
    _, tl, _ = dwt_kernels.check_tiles(_padded_clusters(B), B, 2 * B,
                                       _DEF_TK, B if tl is None else tl,
                                       2 * B)
    if impl != "ragged":
        tl = B
    device = resolve_device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if streaming is None:
        streaming = impl not in _TABLE_IMPLS and \
            autotune.dense_table_host_bytes(B, itemsize) > \
            dense_table_bytes_limit()
    elif streaming and impl in _TABLE_IMPLS:
        raise ValueError(f"streaming=True needs a recurrence-family plan "
                         f"(impl 'auto'/'fused'/'onthefly'); impl={impl!r} "
                         f"reads the dense Wigner table")
    key = (B, dtype, impl, V, tl, bool(streaming), str(device), lchunk,
           precision)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        obs.inc("plan.cache.hit")
        _CACHE.move_to_end(key)
        return hit
    _CACHE_STATS["misses"] += 1
    obs.inc("plan.cache.miss")
    if impl in ("auto", "fused", "onthefly"):
        # raises where no recurrence block fits; onthefly never streams
        auto = autotune.static_lchunk(B=B, itemsize=itemsize,
                                      precision=precision)
        lchunk = auto if lchunk is None else lchunk
    _check_device_memory(B, itemsize, device, table=not streaming,
                         lchunk=lchunk, precision=precision)
    with obs.span("plan.build", B=B, impl=impl, streaming=bool(streaming),
                  device=str(device)):
        soft_plan = batched.build_plan(
            B, dtype=dtype, pad_to=_DEF_TK, streaming=bool(streaming),
            device=device)
        with obs.span("plan.schedule", B=B, impl=impl):
            schedule = _static_schedule(soft_plan, impl, V, tl, lchunk,
                                        precision)
        t = Transform(soft_plan=soft_plan, schedule=schedule)
    _CACHE[key] = t
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return t
