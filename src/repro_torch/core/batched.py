"""Clustered / batched FSOFT & iFSOFT on torch -- the port of
``repro.core.batched``.

The whole DWT stage (all clusters) is ONE batched contraction

    forward :  out[k, l, c] = sum_j  d[k, l, j] * rhs[k, j, c]
    inverse :  g[k, j, c]   = sum_l  d[k, l, j] * lhs[k, l, c]

where k runs over symmetry clusters (the paper's work packages,
kappa-ordered), c over the <= 8 cluster members, and d is the
fundamental-domain Wigner table.  Gather/scatter/sign metadata comes
from :mod:`clusters`.  Complex arithmetic is carried as a trailing
real/imag axis so the contraction is real.

Every stage takes optional leading batch dimensions: a stack of V
transforms is a leading (V, ...) axis, and a batch-aware ``dwt_fn``
(:func:`repro_torch.kernels.ops.make_dwt_fn` with ``batch=V``) contracts
all V in one kernel launch.

Each call is traced (:func:`repro_torch.obs.stage`, recorded only while
tracing is on) as stages named ``so3.<forward|inverse>.<stage>`` that
tile its device work without overlap: ``fft`` (the grid FFTs and their
per-lane stacks), ``gather`` (member bins into the DWT's operand, or
coefficients into the iDWT's), ``dwt`` (the contraction) and ``scatter``
(its result into coefficients, or into FFT bins); in a slab loop the
stages repeat.  ``Transform._batch`` adds ``lanes``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import weakref

import numpy as np
import torch

from repro_torch import obs

from . import clusters as clusters_mod
from . import quadrature, wigner

__all__ = ["SoftPlan", "build_plan", "soft_plan_from_arrays",
           "resolve_device", "plan_cache_stats", "plan_cache_bytes_limit",
           "clear_plan_cache",
           "plan_memo", "plan_lstart", "shard_balanced_order",
           "shard_lstart",
           "bucket_boundaries_from_lstart", "bucket_boundaries",
           "make_bucketed_dwt_fn",
           "fft_analysis", "fft_synthesis",
           "fft_analysis_slab", "streamed_rhs", "streamed_synthesis",
           "dwt_apply", "idwt_apply",
           "forward_clustered", "inverse_clustered",
           "forward_clustered_batch", "inverse_clustered_batch"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one, raise: the port never moves
    to the CPU unless the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True, eq=False)   # eq=False: identity hash
class SoftPlan:
    """Device tables for the clustered transforms.

    All tensors live on ``device``; shapes use K = #clusters (padded to
    `pad_to` if given), L = B, J = 2B, C = 8 member slots.

    ``d is None`` marks a STREAMING plan (build_plan(streaming=True)):
    the dense (K, L, J) Wigner table is never materialized, and the
    fused recurrence kernels, seeded from ``table.rep``, are the only
    executor.  The dense-table consumers (the reference einsum) reject
    streaming plans loudly.
    """

    B: int
    table: clusters_mod.ClusterTable        # host metadata (numpy)
    d: torch.Tensor | None    # (K, L, J)  fundamental Wigner blocks, or None
    gather_m: torch.Tensor    # (K, C) int64  FFT bins
    gather_mp: torch.Tensor   # (K, C)
    scatter_m: torch.Tensor   # (K, C) int64  dense-layout bins (trash = 2B-1)
    scatter_mp: torch.Tensor  # (K, C)
    sign: torch.Tensor        # (K, C) plan dtype; 0 marks unused slots
    reflected: torch.Tensor   # (K, C) bool
    w: torch.Tensor           # (J,)   quadrature weights
    scale: torch.Tensor       # (L,)   (2l+1)/(8 pi B)
    parity: torch.Tensor      # (L,)   (-1)^l
    n_padded: int             # K after padding
    device: torch.device
    plan_dtype: torch.dtype = torch.float64

    @property
    def n_clusters(self) -> int:
        return self.table.n_clusters

    @property
    def streaming(self) -> bool:
        """True when the dense Wigner table was never built (d is None)."""
        return self.d is None

    @property
    def dtype(self) -> torch.dtype:
        """The plan's real dtype (dense and streaming plans alike)."""
        return self.plan_dtype

    @property
    def cdtype(self) -> torch.dtype:
        return (torch.complex64 if self.plan_dtype == torch.float32
                else torch.complex128)

    def require_dense(self, consumer: str) -> torch.Tensor:
        """The dense (K, L, J) table, or a loud error on streaming plans."""
        if self.d is None:
            raise ValueError(
                f"{consumer} needs the dense (K, L, J) Wigner table, but "
                f"this B={self.B} plan was built streaming (d=None); use "
                f"impl='fused' or rebuild with build_plan(streaming=False)")
        return self.d


# The tensor fields, in the order of repro.core.batched._PLAN_LEAVES.
PLAN_LEAVES = ("d", "gather_m", "gather_mp", "scatter_m", "scatter_mp",
               "sign", "reflected", "w", "scale", "parity")


def _plan_tensors(arrays: dict, dtype: torch.dtype, device) -> dict:
    """Numpy plan arrays -> the SoftPlan's tensor fields on ``device``."""
    def t(x, dt=None):      # a copy: the plan owns its tables
        return torch.tensor(np.asarray(x), device=device, dtype=dt)

    d = arrays["d"]
    return dict(
        d=None if d is None else t(d, dtype),
        gather_m=t(arrays["gather_m"], torch.int64),
        gather_mp=t(arrays["gather_mp"], torch.int64),
        scatter_m=t(arrays["scatter_m"], torch.int64),
        scatter_mp=t(arrays["scatter_mp"], torch.int64),
        sign=t(arrays["sign"], dtype),
        reflected=t(arrays["reflected"], torch.bool),
        w=t(arrays["w"], dtype),
        scale=t(arrays["scale"], dtype),
        parity=t(arrays["parity"], dtype),
    )


_TABLE_FIELDS = tuple(f.name for f in dataclasses.fields(
    clusters_mod.ClusterTable))


def soft_plan_from_arrays(B: int, arrays: dict, *, n_padded: int,
                          plan_dtype, device=None) -> SoftPlan:
    """A SoftPlan from the numpy arrays of another plan of the same
    layout, e.g. a ``repro.core.batched.SoftPlan`` ``p``::

        arrays = {n: np.asarray(getattr(p, n)) for n in PLAN_LEAVES}
        arrays["table"] = dataclasses.asdict(p.table)

    ``arrays["table"]`` holds the ClusterTable fields (``B``, ``rep``,
    ``fund_row``, ``member_m``, ...); ``d`` may be None (streaming).
    Lets both packages run on identical tables."""
    device = resolve_device(device)
    dtype = _torch_dtype(plan_dtype)
    tab = arrays["table"]
    table = clusters_mod.ClusterTable(
        **{f: (tab[f] if f in ("B", "n_regular") else np.asarray(tab[f]))
           for f in _TABLE_FIELDS})
    return SoftPlan(B=B, table=table, n_padded=n_padded, device=device,
                    plan_dtype=dtype, **_plan_tensors(arrays, dtype, device))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


# Byte-bounded LRU memo of built plans, as the reference's: a dense plan
# holds the full (K, L, J) Wigner table on the device (2.16 GB at B = 128
# f64), so a count bound would keep a B-sweep's tables resident.  Entries
# are (plan, nbytes); a put evicts the least recently used plans while
# more than one is held and the total exceeds $REPRO_PLAN_CACHE_BYTES (the
# newest plan is always kept, even if it alone exceeds the bound).
_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_PLAN_CACHE_DEFAULT_BYTES = 2 * 1024 ** 3
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def plan_cache_bytes_limit() -> int:
    """Memo bound in bytes; override with $REPRO_PLAN_CACHE_BYTES (the
    reference reads the same variable)."""
    return int(os.environ.get("REPRO_PLAN_CACHE_BYTES",
                              _PLAN_CACHE_DEFAULT_BYTES))


def _plan_nbytes(plan: SoftPlan) -> int:
    """The bytes of a plan's tensors (numel * element_size)."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(plan, n) for n in PLAN_LEAVES)
               if t is not None)


def plan_cache_stats() -> dict:
    """Counters and byte accounting of the build_plan memo."""
    return dict(_PLAN_CACHE_STATS, plans=len(_PLAN_CACHE),
                bytes=sum(n for _, n in _PLAN_CACHE.values()),
                bytes_limit=plan_cache_bytes_limit())


def _plan_cache_put(key, plan: SoftPlan) -> None:
    _PLAN_CACHE[key] = (plan, _plan_nbytes(plan))
    limit = plan_cache_bytes_limit()
    while len(_PLAN_CACHE) > 1 and \
            sum(n for _, n in _PLAN_CACHE.values()) > limit:
        _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE_STATS["evictions"] += 1


def clear_plan_cache() -> None:
    """Drop the build_plan memo and zero its counters.  A plan nobody
    else holds is then freed, and with it every :func:`plan_memo` entry
    made for it."""
    _PLAN_CACHE.clear()
    for k in _PLAN_CACHE_STATS:
        _PLAN_CACHE_STATS[k] = 0


def plan_memo(fn):
    """Memoize ``fn(plan, *args)`` per plan identity, weakly: a plan's
    entries go when the plan does, so no memo keeps a plan's tables (a
    dense plan's (K, L, J) table) alive.  The memoized values must not
    hold the plan."""
    memo: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    @functools.wraps(fn)
    def memoized(plan, *args):
        per_plan = memo.setdefault(plan, {})
        if args not in per_plan:
            per_plan[args] = fn(plan, *args)
        return per_plan[args]
    return memoized


def plan_arrays(B: int, *, pad_to: int | None = None,
                order: np.ndarray | None = None,
                streaming: bool = False) -> tuple[dict, int]:
    """Host (numpy) tables of a plan and its padded cluster count.

    Float tables are float64 here; :func:`build_plan` casts them to the
    plan dtype on the device."""
    tab = clusters_mod.build_cluster_table(B)
    if order is not None:
        tab = _permute_table(tab, np.asarray(order))
    K = tab.n_clusters
    Kp = K if pad_to is None else ((K + pad_to - 1) // pad_to) * pad_to

    def padk(x, fill=0):
        if Kp == len(x):
            return x
        pad = np.full((Kp - len(x),) + x.shape[1:], fill, dtype=x.dtype)
        return np.concatenate([x, pad], axis=0)

    if streaming:
        d = None
    else:
        fund, _ = wigner.wigner_d_fundamental(B)      # (P, L, J) f64
        d = padk(fund[tab.fund_row])
    trash = 2 * B - 1
    arrays = dict(
        d=d,
        gather_m=padk(tab.gather_m), gather_mp=padk(tab.gather_mp),
        scatter_m=padk(tab.scatter_m, fill=trash),
        scatter_mp=padk(tab.scatter_mp, fill=trash),
        sign=padk(tab.sign), reflected=padk(tab.reflected),
        w=quadrature.weights(B),
        scale=(2 * np.arange(B) + 1) / (8 * np.pi * B),
        parity=(-1.0) ** np.arange(B),
        table=dataclasses.asdict(tab),
    )
    return arrays, Kp


def build_plan(B: int, dtype=torch.float64, pad_to: int | None = None,
               order: np.ndarray | None = None, streaming: bool = False,
               device=None) -> SoftPlan:
    """Precompute the clustered-DWT plan on ``device`` (default: the card).

    pad_to: pad the cluster axis to a multiple; padded rows have sign 0
    everywhere and a zero Wigner block.  order: optional cluster
    permutation.  streaming: build WITHOUT the dense (K, L, J) Wigner
    table (d=None) -- no O(B^3) host or device array is touched; all
    other tables are identical to the dense build.

    Plans are memoized by (B, dtype, pad_to, order, streaming, device)
    in a byte-bounded LRU ($REPRO_PLAN_CACHE_BYTES, :func:`plan_cache_stats`);
    a SoftPlan is frozen and its tensors are never written, so sharing
    is safe.
    """
    device = resolve_device(device)
    dtype = _torch_dtype(dtype)
    key = (B, dtype, pad_to,
           None if order is None else np.asarray(order).tobytes(),
           bool(streaming), str(device))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE.move_to_end(key)
        _PLAN_CACHE_STATS["hits"] += 1
        return hit[0]
    _PLAN_CACHE_STATS["misses"] += 1
    arrays, Kp = plan_arrays(B, pad_to=pad_to, order=order,
                             streaming=streaming)
    plan = soft_plan_from_arrays(B, arrays, n_padded=Kp, plan_dtype=dtype,
                                 device=device)
    _plan_cache_put(key, plan)
    return plan


def _permute_table(tab, perm):
    """Reorder every per-cluster array of a ClusterTable."""
    kw = {}
    for f in dataclasses.fields(tab):
        v = getattr(tab, f.name)
        kw[f.name] = v[perm] if isinstance(v, np.ndarray) and \
            v.ndim >= 1 and len(v) == tab.n_clusters else v
    return clusters_mod.ClusterTable(**kw)


def plan_lstart(plan: SoftPlan) -> np.ndarray:
    """(Kp,) l-start per cluster.  Padded rows get B-1 (their Wigner rows
    are zero, so any start is correct; B-1 sorts them last)."""
    l_start = np.full(plan.n_padded, plan.B - 1, np.int32)
    l_start[: plan.n_clusters] = plan.table.rep[:, 0]
    return l_start


def shard_balanced_order(l_start: np.ndarray, n_shards: int,
                         n_padded: int | None = None) -> np.ndarray:
    """Cluster permutation whose contiguous 1/n-th blocks (what each rank
    of a mesh owns) are (a) work-balanced across shards and (b)
    extent-sorted within each shard: the extent-sorted clusters are dealt
    round-robin (the paper's balanced static schedule) and shard s's hand
    is laid out as global block s.

    n_padded: the cluster count after build_plan's pad_to padding.  Pad
    rows are appended at the global end, in the tail of the last
    shard(s); sizing the hands by it keeps every shard boundary on a hand
    boundary, so each block stays extent-sorted (pad rows carry
    l_start = B-1 and no work)."""
    K = len(l_start)
    work_sorted = np.argsort(l_start, kind="stable")  # ascending m = desc work
    if n_padded is None or n_padded == K:
        return np.concatenate([work_sorted[s::n_shards]
                               for s in range(n_shards)]).astype(np.int64)
    if n_padded % n_shards:
        raise ValueError(f"n_padded={n_padded} % n_shards={n_shards}")
    kloc = n_padded // n_shards
    # real-cluster capacity per hand: pad rows fill the last shards' tails
    sizes = [kloc] * n_shards
    rem = n_padded - K
    s = n_shards - 1
    while rem > 0:
        take = min(kloc, rem)
        sizes[s] -= take
        rem -= take
        s -= 1
    hands: list[list[int]] = [[] for _ in range(n_shards)]
    idx = 0
    for c in work_sorted:
        while len(hands[idx % n_shards]) >= sizes[idx % n_shards]:
            idx += 1            # this hand is full of real clusters
        hands[idx % n_shards].append(int(c))
        idx += 1
    return np.concatenate(hands).astype(np.int64)


def shard_lstart(plan: SoftPlan, n_shards: int) -> np.ndarray:
    """(n_shards, kloc) per-shard l-start blocks in the contiguous layout
    each rank owns.  With :func:`shard_balanced_order` every row ascends
    in l-start, which the per-local-tile l0 schedules
    (``core.parallel.fused_shard_meta``, :func:`bucket_boundaries_from_lstart`)
    rely on."""
    return plan_lstart(plan).reshape(n_shards, plan.n_padded // n_shards)


def bucket_boundaries_from_lstart(l_start: np.ndarray, n_shards: int,
                                  n_buckets: int):
    """Static (k0, k1, l0) LOCAL bucket slices for the bucketed DWT.

    l_start: (Kp,) per-cluster first valid degree in the (padded,
    permuted) global order.  Every contiguous Kp/n_shards block must be
    extent-sorted (a shard-balanced order), so boundaries computed at
    local offsets hold for every shard at once (l0 = min over shards)."""
    K = len(l_start)
    kloc = K // n_shards
    per_shard = np.asarray(l_start).reshape(n_shards, kloc)
    bounds = np.linspace(0, kloc, n_buckets + 1).astype(int)
    out = []
    for i in range(n_buckets):
        k0, k1 = int(bounds[i]), int(bounds[i + 1])
        if k0 == k1:
            continue
        out.append((k0, k1, int(per_shard[:, k0:k1].min())))
    return tuple(out)


@plan_memo
def bucket_boundaries(plan: SoftPlan, n_shards: int, n_buckets: int):
    """:func:`bucket_boundaries_from_lstart` of the plan, memoized per
    (plan, n_shards, n_buckets)."""
    return bucket_boundaries_from_lstart(plan_lstart(plan), n_shards,
                                         n_buckets)


def make_bucketed_dwt_fn(plan: SoftPlan, n_shards: int = 1,
                         n_buckets: int = 8):
    """dwt_fn with a static l-truncation per extent bucket (the ragged
    skip as plain torch): each bucket contracts only its rows l >= l0,
    skipping the zero triangle.  Dense plans only."""
    plan.require_dense("make_bucketed_dwt_fn")
    slices = bucket_boundaries(plan, n_shards, n_buckets)
    kloc = plan.n_padded // n_shards

    def fn(p: SoftPlan, rhs):
        # per shard block, so the local slices line up (one block for 1)
        K, J, C, _ = rhs.shape
        rhs2 = rhs.reshape(n_shards, kloc, J, C * 2)
        d3 = p.d.reshape(n_shards, kloc, p.d.shape[1], J)
        outs = []
        for k0, k1, l0 in slices:
            o = torch.einsum("sklj,skjc->sklc", d3[:, k0:k1, l0:, :],
                             rhs2[:, k0:k1])
            outs.append(torch.nn.functional.pad(o, (0, 0, l0, 0)))
        return torch.cat(outs, dim=1).reshape(K, -1, C, 2)

    return fn


# ---------------------------------------------------------------------------
# stage 1: grid FFTs (cuFFT on the card)
# ---------------------------------------------------------------------------

def _per_grid(fn):
    """Apply a 3-D grid FFT stage to each grid of a (V, ...) stack on its
    own.  An FFT library may order its arithmetic differently for another
    batch count: pocketfft on the CPU does, and so does cuFFT on an H100
    for the analysis stages (``chip_smoke.py`` phase 3b).  Transforming
    lane by lane keeps lane k of a batch bitwise equal to the single
    transform."""
    @functools.wraps(fn)
    def stage(x: torch.Tensor, *args) -> torch.Tensor:
        if x.ndim == 3:
            return fn(x, *args)
        return torch.stack([stage(xi, *args) for xi in x])
    return stage


def _ifft2(x: torch.Tensor) -> torch.Tensor:
    """(2B)^2 * ifft2 over the alpha and gamma axes (dims -3 and -1) of
    (..., 2B, j, 2B) samples: both transforms unnormalized
    (``norm="forward"``), with no scaling pass.  Where 2B is a power of
    two this is bitwise the scaled form (each ifft by 1 / 2B, the result
    by (2B)^2), as scaling by a power of two is exact short of underflow;
    for another 2B it differs from it by rounding."""
    return torch.fft.ifft(torch.fft.ifft(x, dim=-3, norm="forward"), dim=-1,
                          norm="forward")


@_per_grid
def fft_analysis(f: torch.Tensor) -> torch.Tensor:
    """Samples (..., 2B, 2B, 2B) -> S[..., mbin, j, m'bin]: (2B)^2 * ifft2."""
    return _ifft2(f)


@_per_grid
def fft_synthesis(gbin: torch.Tensor) -> torch.Tensor:
    """g bins (..., 2B, J, 2B) -> samples: unnormalized forward fft2."""
    return torch.fft.fft(torch.fft.fft(gbin, dim=-3), dim=-1)


# ---------------------------------------------------------------------------
# beta-slab streaming of the grid FFT stages
#
# Both FFT stages transform the alpha and gamma axes only -- the beta axis
# (j) rides along untouched -- so the (2B)^3 grid can be processed in
# j-slabs: each length-2B 1-D FFT sees the same input column whether it is
# batched over 2B or over a slab's worth of columns.  The only j-coupling
# in the surrounding gather/scatter is the beta reflection: a reflected
# member's output slab [j0, j1) reads the MIRROR slab [J-j1, J-j0)
# reversed.  The forward computes each slab's spectrum once and writes its
# rows and its mirror's from the pair.
# ---------------------------------------------------------------------------

GRID_N_SLABS = 4
SLAB_SPECTRA = "so3.forward.slab_spectra"     # obs counter: slab FFTs made


@functools.lru_cache(maxsize=64)
def _slab_bounds(J: int, n_slabs: int = GRID_N_SLABS):
    """Beta slabs [j0, j1) that cover [0, J) and are mirror-symmetric: the
    mirror [J - j1, J - j0) of a slab is a slab.  The lower half's cuts are
    np.linspace's and the upper half's their reflections, so for 4 | J the
    slabs are linspace's J / 4 rows each."""
    n = min(n_slabs, J)
    low = np.linspace(0, J, n + 1).astype(int)[: n // 2 + 1]
    cuts = sorted({int(c) for c in low} | {J - int(c) for c in low})
    return tuple(zip(cuts[:-1], cuts[1:]))


@_per_grid
def fft_analysis_slab(f: torch.Tensor, j0: int, j1: int) -> torch.Tensor:
    """fft_analysis restricted to beta rows [j0, j1)."""
    return _ifft2(f[..., j0:j1, :])


def _at_members(plan: SoftPlan, S: torch.Tensor) -> torch.Tensor:
    """S[..., mbin, j, m'bin] at every member's bins: (..., K, C, j)."""
    return S.movedim(-2, -1)[..., plan.gather_m, plan.gather_mp, :]


def _rhs_from_members(plan: SoftPlan, Sm: torch.Tensor, w: torch.Tensor):
    """(..., K, C, j) complex -> rhs (..., K, j, C, 2) real, a view of the
    weighted member values."""
    Sm = Sm * (plan.sign[..., None] * w)
    return torch.view_as_real(Sm).transpose(-3, -2)       # (..., K, j, C, 2)


def _write_slab_rows(plan: SoftPlan, rows: torch.Tensor, j0: int, j1: int,
                     own: torch.Tensor, mirror: torch.Tensor) -> None:
    """rhs rows [j0, j1) from the members of slab [j0, j1) (``own``) and
    of its mirror slab (``mirror``), as _gather_rhs computes them: a
    beta-reflected member reads the mirror's values in reverse order.
    ``rows`` is rhs as a complex (..., K, C, J) view; the choice is made in
    the flip's buffer and the weighted product goes straight into rhs."""
    Sm = mirror.flip(-1)
    torch.where(plan.reflected[..., None], Sm, own, out=Sm)
    torch.mul(Sm, plan.sign[..., None] * plan.w[j0:j1], out=rows[..., j0:j1])


def streamed_rhs(plan: SoftPlan, f: torch.Tensor) -> torch.Tensor:
    """FFT-analysis + gather, streamed in beta slabs: equal to
    _gather_rhs(plan, fft_analysis(f)), written slab by slab into one
    (..., K, J, C, 2) buffer, with O((2B)^2 * slab) intermediates.  The
    slabs go in mirror pairs: each slab's spectrum is computed once
    (counted by the obs counter ``so3.forward.slab_spectra``), gathered and
    freed, and the pair's members give both slabs' rows."""
    J = 2 * plan.B
    K, C = plan.gather_m.shape
    dev = plan.device
    rhs = torch.empty(f.shape[:-3] + (K, J, C, 2), dtype=plan.dtype,
                      device=f.device)
    rows = torch.view_as_complex(rhs).transpose(-2, -1)  # (..., K, C, J)
    bounds = _slab_bounds(J)
    n = len(bounds)
    for i in range((n + 1) // 2):
        a, b = bounds[i], bounds[n - 1 - i]       # slab i and its mirror
        with obs.stage("so3.forward.fft", dev):
            S = fft_analysis_slab(f, *a)
        obs.inc(SLAB_SPECTRA)
        if b != a:
            with obs.stage("so3.forward.gather", dev):
                own = _at_members(plan, S)
                del S
            with obs.stage("so3.forward.fft", dev):
                S = fft_analysis_slab(f, *b)
            obs.inc(SLAB_SPECTRA)
        with obs.stage("so3.forward.gather", dev):   # and the pair's rows
            mirror = _at_members(plan, S)
            del S
            if b == a:
                own = mirror             # the middle slab is its own mirror
            _write_slab_rows(plan, rows, *a, own, mirror)
            if b != a:
                _write_slab_rows(plan, rows, *b, mirror, own)
            del own, mirror
    return rhs


def streamed_synthesis(plan: SoftPlan, gc: torch.Tensor) -> torch.Tensor:
    """Scatter-to-bins + FFT-synthesis, streamed in beta slabs: equal to
    fft_synthesis(_scatter_bins(plan, gc)), written slab by slab into one
    (..., 2B, 2B, 2B) grid, without the monolithic (2B+1, 2B, 2B+1) bin
    buffer."""
    J = 2 * plan.B
    dev = plan.device
    out = torch.empty(gc.shape[:-3] + (J, J, J), dtype=gc.dtype,
                      device=gc.device)
    for j0, j1 in _slab_bounds(J):
        with obs.stage("so3.inverse.scatter", dev):
            direct = gc[..., j0:j1, :]
            mirror = gc[..., J - j1:J - j0, :].flip(-2)
            gs = torch.where(plan.reflected[:, None, :], mirror, direct)
            del mirror
            bins = _scatter_bins_nomirror(plan, gs)
            del gs
        with obs.stage("so3.inverse.fft", dev):
            out[..., j0:j1, :] = fft_synthesis(bins)
            del bins
    return out


# ---------------------------------------------------------------------------
# stage 2: clustered DWT (forward) / iDWT (inverse)
# ---------------------------------------------------------------------------

def _gather_rhs(plan: SoftPlan, S: torch.Tensor) -> torch.Tensor:
    """Build rhs[..., k, j, c, ri] from S[..., mbin, j, m'bin] (complex).

    rhs column c of cluster k = sign * w * S(member), with j reversed for
    beta-reflected members.
    """
    Sm = _at_members(plan, S)                             # (..., K, C, J)
    Sm = torch.where(plan.reflected[..., None], Sm.flip(-1), Sm)
    return _rhs_from_members(plan, Sm, plan.w)


def dwt_apply(plan: SoftPlan, rhs: torch.Tensor) -> torch.Tensor:
    """The clustered DWT contraction as a plain einsum (the port's oracle):
    (K,L,J) x (..., K,J,C,2) -> (..., K,L,C,2)."""
    d = plan.require_dense("dwt_apply")
    return torch.einsum("klj,...kjcr->...klcr", d, rhs)


def idwt_apply(plan: SoftPlan, lhs: torch.Tensor) -> torch.Tensor:
    """The clustered iDWT contraction: (K,L,J) x (..., K,L,C,2) ->
    (..., K,J,C,2)."""
    d = plan.require_dense("idwt_apply")
    return torch.einsum("klj,...klcr->...kjcr", d, lhs)


def _out_sign(plan: SoftPlan) -> torch.Tensor:
    """(K, L, C): (-1)^l on reflected members, 1 elsewhere."""
    return torch.where(plan.reflected[:, None, :], plan.parity[None, :, None],
                       torch.ones((), dtype=plan.dtype, device=plan.device))


def _scatter_coeffs(plan: SoftPlan, out: torch.Tensor) -> torch.Tensor:
    """Scatter out[..., k, l, c] (complex) into the dense coefficient
    layout.  Unused slots land on the trash cell (2B-1, 2B-1) of a buffer
    that keeps it; the slice drops it."""
    B = plan.B
    out = out * (_out_sign(plan) * plan.scale[None, :, None])
    lead = out.shape[:-3]
    buf = torch.zeros(lead + (B, 2 * B, 2 * B), dtype=out.dtype,
                      device=out.device)
    vals = out.transpose(-1, -2).reshape(lead + (-1, B))   # (..., K*C, L)
    buf.movedim(-3, -1)[..., plan.scatter_m.reshape(-1),
                        plan.scatter_mp.reshape(-1), :] = vals
    return buf[..., : 2 * B - 1, : 2 * B - 1]


def _gather_coeffs(plan: SoftPlan, fhat: torch.Tensor) -> torch.Tensor:
    """Gather lhs[..., k, l, c] = sign * (-1)^{l if reflected} * fhat(member)
    as a contiguous (..., K, L, C, 2) real view of one complex buffer."""
    fpad = torch.nn.functional.pad(fhat, (0, 1, 0, 1))   # trash cell reads 0
    ls = torch.arange(plan.B, device=fhat.device)[None, :, None]
    lhs = fpad[..., ls, plan.scatter_m[:, None, :],
               plan.scatter_mp[:, None, :]]               # (..., K, L, C)
    del fpad
    lhs = lhs * (_out_sign(plan) * plan.sign[:, None, :])
    return torch.view_as_real(lhs)                        # (..., K, L, C, 2)


def _scatter_bins_nomirror(plan: SoftPlan, g: torch.Tensor) -> torch.Tensor:
    """Scatter g[..., k, j, c] (complex, reflection already applied) into
    FFT bins (..., 2B, j, 2B).  j-independent, so slab callers pass
    partial-j g.  Unused slots land on the trash bin 2B (sliced off)."""
    B = plan.B
    lead, nj = g.shape[:-3], g.shape[-2]
    buf = torch.zeros(lead + (2 * B + 1, nj, 2 * B + 1), dtype=g.dtype,
                      device=g.device)
    trash = torch.full_like(plan.gather_m, 2 * B)
    gm = torch.where(plan.sign != 0, plan.gather_m, trash).reshape(-1)
    gmp = torch.where(plan.sign != 0, plan.gather_mp, trash).reshape(-1)
    vals = g.transpose(-1, -2).reshape(lead + (-1, nj))     # (..., K*C, j)
    buf.movedim(-2, -1)[..., gm, gmp, :] = vals
    return buf[..., : 2 * B, :, : 2 * B]


def _scatter_bins(plan: SoftPlan, g: torch.Tensor) -> torch.Tensor:
    """Scatter g[..., k, j, c] (complex) into FFT bins (..., 2B, j, 2B)."""
    g = torch.where(plan.reflected[:, None, :], g.flip(-2), g)
    return _scatter_bins_nomirror(plan, g)


# ---------------------------------------------------------------------------
# full transforms
# ---------------------------------------------------------------------------

def _require_recurrence_fn(plan: SoftPlan, fn, which: str):
    if plan.streaming and fn is None:
        raise ValueError(
            f"streaming plan (B={plan.B}, d=None) has no dense Wigner table "
            f"for the einsum oracle; pass a fused {which} "
            f"(kernels.ops.make_{which}(..., impl='fused'))")


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) real -> complex: a view where the strides allow one (the
    kernels' outputs), else a view of a contiguous copy."""
    if x.stride(-1) != 1 or x.storage_offset() % 2 or \
            any(st % 2 for st in x.stride()[:-1]):
        x = x.contiguous()
    return torch.view_as_complex(x)


# Each stage below drops its operand as soon as the next buffer exists:
# at B = 512 one (K, J, C, 2) f64 stack is 17 GB of the card's 80.

def _forward(plan: SoftPlan, f: torch.Tensor, dwt_fn) -> torch.Tensor:
    _require_recurrence_fn(plan, dwt_fn, "dwt_fn")
    dev = plan.device
    if plan.streaming:
        rhs = streamed_rhs(plan, f)
    else:
        with obs.stage("so3.forward.fft", dev):
            S = fft_analysis(f)
        with obs.stage("so3.forward.gather", dev):
            rhs = _gather_rhs(plan, S)
            del S
    with obs.stage("so3.forward.dwt", dev):
        out = dwt_apply(plan, rhs) if dwt_fn is None else dwt_fn(plan, rhs)
    del rhs
    with obs.stage("so3.forward.scatter", dev):
        return _scatter_coeffs(plan, _as_complex(out))


def _inverse(plan: SoftPlan, fhat: torch.Tensor, idwt_fn) -> torch.Tensor:
    _require_recurrence_fn(plan, idwt_fn, "idwt_fn")
    dev = plan.device
    with obs.stage("so3.inverse.gather", dev):
        lhs = _gather_coeffs(plan, fhat)
    with obs.stage("so3.inverse.dwt", dev):
        g = idwt_apply(plan, lhs) if idwt_fn is None else idwt_fn(plan, lhs)
    del lhs
    with obs.stage("so3.inverse.scatter", dev):
        gc = _as_complex(g)
        del g
        if not plan.streaming:
            bins = _scatter_bins(plan, gc)
    if plan.streaming:
        return streamed_synthesis(plan, gc)
    with obs.stage("so3.inverse.fft", dev):
        return fft_synthesis(bins)


def _check_ndim(x: torch.Tensor, ndim: int, what: str):
    if x.ndim != ndim:
        raise ValueError(f"{what} expects a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")


def forward_clustered(plan: SoftPlan, f: torch.Tensor, dwt_fn=None):
    """FSOFT via the clustered DWT: samples (2B, 2B, 2B) -> coefficients
    (B, 2B-1, 2B-1).  ``dwt_fn`` swaps in the fused kernel (same
    (plan, rhs) -> out contract); None runs the einsum oracle (dense
    plans only).  Streaming plans run the FFT+gather stage in beta slabs.
    """
    _check_ndim(f, 3, "forward_clustered")
    return _forward(plan, f, dwt_fn)


def inverse_clustered(plan: SoftPlan, fhat: torch.Tensor, idwt_fn=None):
    """iFSOFT via the clustered iDWT; see :func:`forward_clustered`."""
    _check_ndim(fhat, 3, "inverse_clustered")
    return _inverse(plan, fhat, idwt_fn)


def forward_clustered_batch(plan: SoftPlan, f: torch.Tensor, dwt_fn=None):
    """FSOFT of a batch: f (V, 2B, 2B, 2B) -> (V, B, 2B-1, 2B-1).  The
    stack rides a leading batch axis through every stage; a batch-aware
    dwt_fn (ops.make_dwt_fn(..., batch=V)) contracts all V in ONE launch."""
    _check_ndim(f, 4, "forward_clustered_batch")
    return _forward(plan, f, dwt_fn)


def inverse_clustered_batch(plan: SoftPlan, fhat: torch.Tensor, idwt_fn=None):
    """iFSOFT of a batch: fhat (V, B, 2B-1, 2B-1) -> (V, 2B, 2B, 2B)."""
    _check_ndim(fhat, 4, "inverse_clustered_batch")
    return _inverse(plan, fhat, idwt_fn)
