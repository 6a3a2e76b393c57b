"""Mesh-resident distributed executor for FSOFT / iFSOFT on
``torch.distributed`` -- the port of ``repro.core.parallel`` (paper
Sec. 3).

:class:`DistExecutor` owns everything one (plan, mesh, axis) pairing
needs to run sharded transforms -- the shard group, the rank's blocks of
the reflection / sign / weight tables and of the local kernels'
operands, and the device-local DWT / iDWT closures -- built ONCE when the
executor is constructed and reused by every call.  Executors are
normally owned by a :class:`repro_torch.plan.Transform`
(``plan(B, mesh=...)``); :func:`dist_executor` memoizes standalone ones.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``; ``axis``
names its ``mesh_dim_names``, and several axes flatten into one shard
group of n ranks.  Rank s of the group owns beta rows [s J/n, (s+1) J/n)
of the sample grids and clusters [s K/n, (s+1) K/n) of the packed
coefficients (K padded to a multiple of n, shard-balanced order).

Pipeline (forward; the inverse is the exact mirror):

  stage 1  beta-local:   the rank FFTs its own beta rows of the sample
           grid (j is untouched by the (alpha, gamma) FFT) and gathers the
           cluster RHS columns for ALL clusters on its j-range.
  reshard  ONE ``all_to_all_single`` on the shard group swaps (cluster,
           j) ownership: afterwards the rank owns the full j-range of ITS
           clusters.  This is the only communication in the transform.
  stage 2  cluster-local: beta reflections become local j-reversals and
           the clustered DWT runs on the rank's device alone.

Batches ride the kernel's lane axis: ``forward_lanes`` / ``inverse_lanes``
take a (V, ...) stack of RANK-LOCAL shards, fold the V lanes into the
contraction axis (C2 = V*C*2) and issue ONE all-to-all and one local
kernel launch for the whole stack.  ``forward`` / ``inverse`` /
``forward_batch`` / ``inverse_batch`` keep the global-array contract:
every rank passes the whole input and gets the whole output; the rank
slices its shard at the entry and the shards are all-gathered at the
exit (nothing to gather on one rank).

``overlap="pipelined"`` runs the ceil(n/V) chunks of a batch through the
two-slot schedule of :func:`pipeline_steps` / :func:`pipeline_slots`:
chunk i+1's all-to-all is issued with ``async_op=True`` while chunk i's
local kernel runs, and waited on before its slot is read.  On NCCL the
collective runs on its own stream (a wait makes the compute stream wait
on it; nothing synchronizes the host), on gloo in the background.
``overlap="off"`` launches the chunks serially.  Both modes run the same
arithmetic on the same chunks, so their results are equal bit for bit.

Coefficients live in the *packed* layout out[k, l, c];
:func:`packed_to_dense` / :func:`dense_to_packed` convert at the edges.
The fused local kernels (:func:`make_fused_local_dwt` /
:func:`make_fused_local_idwt`) carry recurrence seeds, so no Wigner
table shard enters the executor.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs

from .batched import (SoftPlan, _as_complex, _at_members,
                      _scatter_bins_nomirror, fft_analysis, fft_synthesis,
                      plan_memo, shard_lstart)

__all__ = [
    "DistExecutor", "dist_executor", "check_mesh_compat",
    "distributed_forward", "distributed_inverse",
    "LocalDWT", "ShardMeta", "fused_shard_meta", "make_bucketed_local_dwt",
    "make_fused_local_dwt", "make_fused_local_idwt", "packed_to_dense",
    "dense_to_packed", "packed_to_dense_batch", "dense_to_packed_batch",
    "OVERLAP_MODES", "check_overlap_mode", "pipeline_steps",
    "pipeline_slots", "mesh_axes", "mesh_shards", "shard_group",
    "broadcast_object", "local_mesh", "start_local_group", "ALL_TO_ALLS",
    "reset_all_to_alls",
]

# batch-executor execution modes: "off" launches the V-chunks serially,
# "pipelined" runs them through the two-slot schedule (chunk i+1's
# all-to-all in flight while chunk i's local kernel runs)
OVERLAP_MODES = ("off", "pipelined")

# all-to-alls issued per direction, process-wide (one per V-chunk)
ALL_TO_ALLS = {"forward": 0, "inverse": 0}


def reset_all_to_alls() -> None:
    for k in ALL_TO_ALLS:
        ALL_TO_ALLS[k] = 0


def check_overlap_mode(overlap: str) -> str:
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap must be one of {OVERLAP_MODES}, "
                         f"got {overlap!r}")
    return overlap


def pipeline_steps(n_chunks: int) -> list[tuple]:
    """Static step schedule of the two-slot pipeline over ``n_chunks``
    V-chunks.  Each step is a tuple of ("collective", chunk) /
    ("compute", chunk) halves that run concurrently (no data dependence
    between them):

      step 0                (("collective", 0),)              prologue
      step 1..n_chunks-1    (("collective", i), ("compute", i-1))
      step n_chunks         (("compute", n_chunks-1),)        epilogue
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    steps: list[tuple] = [(("collective", 0),)]
    steps += [(("collective", i + 1), ("compute", i))
              for i in range(n_chunks - 1)]
    steps.append((("compute", n_chunks - 1),))
    return steps


def pipeline_slots(n_chunks: int) -> list[tuple]:
    """Two-slot buffer rotation behind :func:`pipeline_steps`: per step,
    (read_slot, write_slot) (None for the half a prologue / epilogue step
    does not have).  Chunk i lives in slot i % 2, so the collective in
    flight never writes the slot the overlapping kernel reads."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    slots: list[tuple] = [(None, 0)]
    slots += [((i % 2), (i + 1) % 2) for i in range(n_chunks - 1)]
    slots.append(((n_chunks - 1) % 2, None))
    return slots


def check_mesh_compat(plan: SoftPlan, n_shards: int) -> None:
    if plan.n_padded % n_shards:
        raise ValueError(
            f"cluster axis {plan.n_padded} not divisible by {n_shards} shards"
            " -- build the plan with pad_to=n_shards")
    if (2 * plan.B) % n_shards:
        raise ValueError(
            f"beta axis {2 * plan.B} not divisible by {n_shards} shards")


# ---------------------------------------------------------------------------
# the mesh and its shard group
# ---------------------------------------------------------------------------

def mesh_axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh plan needs a torch.distributed process group: call "
            "torch.distributed.init_process_group (and build the mesh with "
            "init_device_mesh) on every rank first; a mesh plan never runs "
            "locally")


def mesh_shards(mesh, axis) -> int:
    """Shard count of the flattened ``axis`` dims of a DeviceMesh.  Raises
    RuntimeError when no process group is up."""
    _require_process_group()
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the mesh needs mesh_dim_names "
                         "(init_device_mesh(..., mesh_dim_names=...))")
    missing = [a for a in axis if a not in names]
    if missing:
        raise ValueError(f"mesh has no dims {missing}; it has {names}")
    return int(np.prod([mesh.size(names.index(a)) for a in axis]))


def shard_group(mesh, axis):
    """The process group of the flattened ``axis`` dims: rank s of it owns
    shard s."""
    _require_process_group()
    if len(axis) == 1:
        return mesh.get_group(axis[0])
    return mesh[tuple(axis)]._flatten().get_group()


def start_local_group(device: torch.device) -> bool:
    """Select ``device`` and, when no process group is up, start a
    one-rank one (NCCL on a card, gloo on the CPU) at
    ``tcp://localhost`` on a free port.  Returns whether it started one
    (the caller destroys it)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return False
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


@contextlib.contextmanager
def local_mesh(n_shards: int, device: torch.device, axis: str = "data"):
    """A one-dim DeviceMesh ``(axis,)`` of ``n_shards`` ranks on
    ``device``'s type: over the caller's process group (of exactly
    ``n_shards`` ranks), or -- when none is up and ``n_shards`` is 1 -- over
    a one-rank group started here (NCCL on a card, gloo on the CPU, at
    ``tcp://localhost`` on a free port) and destroyed on exit.  Raises
    RuntimeError for any other count.  On exit the plans cached on the
    mesh are evicted (:func:`repro_torch.plan.evict_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized() and n_shards != 1:
        raise RuntimeError(
            f"a mesh of {n_shards} shards needs a process group of "
            f"{n_shards} ranks; a single process starts only a one-rank "
            f"group")
    started = start_local_group(device)
    mesh = None
    try:
        if dist.get_world_size() != n_shards:
            raise RuntimeError(
                f"a mesh of {n_shards} shards needs a process group of "
                f"{n_shards} ranks, found {dist.get_world_size()}")
        mesh = init_device_mesh(device.type, (n_shards,),
                                mesh_dim_names=(axis,))
        yield mesh
    finally:
        if mesh is not None:
            from repro_torch import plan    # deferred: plan imports core
            plan.evict_mesh(mesh)
        if started:
            dist.destroy_process_group()


def broadcast_object(obj, group):
    """``obj`` of the group's first rank, on every rank of ``group``."""
    if dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _refl_sign(reflected, parity):
    """(K, L, C): (-1)^l on beta-reflected member columns, 1 elsewhere."""
    return torch.where(reflected[:, None, :], parity[None, :, None],
                       torch.ones((), dtype=parity.dtype,
                                  device=parity.device))


# ---------------------------------------------------------------------------
# pluggable device-local DWT contraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalDWT:
    """Device-local DWT / iDWT contraction of the executor.

    operands: global tensors handed to ``fn`` before the rhs / lhs;
    cluster_sharded: per-operand flag (True: each rank takes its block of
    the leading cluster axis; False: replicated); fn(*local_operands, x2)
    runs on each rank's shard.  Forward contract: (Kloc, J, C2) rhs ->
    (Kloc, L, C2); inverse: (Kloc, L, C2) lhs -> (Kloc, J, C2).

    The fused variants (:func:`make_fused_local_dwt` / ``_idwt``) carry
    recurrence seeds instead of plan.d: no Wigner table shard exists."""

    operands: tuple
    cluster_sharded: tuple
    fn: object

    def local_operands(self, rank: int, n_shards: int) -> tuple:
        """Each operand as rank ``rank`` of ``n_shards`` holds it."""
        out = []
        for op, sharded in zip(self.operands, self.cluster_sharded):
            if sharded:
                kloc = op.shape[0] // n_shards
                op = op[rank * kloc:(rank + 1) * kloc]
            out.append(op)
        return tuple(out)


def _normalize_local_dwt(plan, local_dwt, einsum_spec):
    if isinstance(local_dwt, LocalDWT):
        return local_dwt
    if local_dwt is None:
        def local_dwt(d, x2):  # noqa: F811 -- plain dense contraction
            return torch.einsum(einsum_spec, d, x2)
    # legacy contract: bare fn(d_shard, x2)
    return LocalDWT((plan.require_dense("the legacy local_dwt contract"),),
                    (True,), local_dwt)


def make_bucketed_local_dwt(slices, B):
    """Local DWT with a static l-truncation per extent bucket (the paper's
    ragged tiling as plain torch).  ``slices``: [(k0, k1, l0)] local
    bucket boundaries (core.batched.bucket_boundaries_from_lstart)."""

    def fn(d, rhs2):
        outs = []
        for (k0, k1, l0) in slices:
            o = torch.einsum("klj,kjc->klc", d[k0:k1, l0:, :], rhs2[k0:k1])
            outs.append(torch.nn.functional.pad(o, (0, 0, l0, 0)))
        return torch.cat(outs, dim=0)

    return fn


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMeta:
    """Shard metadata of one (plan, n_shards) pairing, computed once and
    shared by both directions: recurrence seeds / orders in plan order
    (replacing the d-table shard) and the per-local-tile l0 schedule
    valid for every shard at once."""

    n_shards: int
    tk: int
    seeds: torch.Tensor     # (Kp, J)
    m: torch.Tensor         # (Kp,) int32
    mp: torch.Tensor        # (Kp,) int32
    cb: torch.Tensor        # (J,)   cos(beta), replicated
    l0s: np.ndarray         # (kloc // tk,) int32, replicated
    l0s_t: torch.Tensor     # the same on the plan's device


def fused_shard_meta(plan: SoftPlan, n_shards: int,
                     tk: int | None = None) -> ShardMeta:
    """Seeds / orders plus per-local-tile l0s valid for EVERY shard (the
    min over shards at each local offset).  Memoized per (plan, n_shards,
    tk), weakly: the metadata goes with its plan."""
    return _fused_shard_meta(plan, n_shards, tk)


@plan_memo
def _fused_shard_meta(plan: SoftPlan, n_shards: int, tk) -> ShardMeta:
    from repro_torch.kernels import ops as kops  # deferred: kernels import core

    kloc = plan.n_padded // n_shards
    if tk is None:  # largest cluster tile <= 8 dividing the local count
        tk = max(t for t in range(1, min(8, kloc) + 1) if kloc % t == 0)
    if kloc % tk:
        raise ValueError(f"local cluster count {kloc} not divisible by "
                         f"tk={tk}")
    seeds, m, mp, cb = kops.onthefly_inputs(plan)
    per_shard = shard_lstart(plan, n_shards)
    l0s = np.asarray(per_shard.reshape(n_shards, kloc // tk, tk)
                     .min(axis=(0, 2)), np.int32)
    return ShardMeta(n_shards=n_shards, tk=tk, seeds=seeds, m=m, mp=mp,
                     cb=cb, l0s=l0s,
                     l0s_t=torch.as_tensor(l0s, device=plan.device))


def make_fused_local_dwt(plan: SoftPlan, n_shards: int, *, tk=None,
                         meta: ShardMeta | None = None) -> LocalDWT:
    """LocalDWT running the fused ragged + on-the-fly kernel
    (:func:`repro_torch.kernels.dwt_fused.dwt_fused`: the CUDA kernel on
    CUDA tensors, its plain version on the CPU) on each rank's seed block,
    the zero triangle skipped through the replicated l0s schedule.  Build
    the plan with core.batched.shard_balanced_order so every block is
    extent-sorted.  ``meta`` accepts a precomputed
    :func:`fused_shard_meta`."""
    from repro_torch.kernels import dwt_fused as dfk

    meta = fused_shard_meta(plan, n_shards, tk) if meta is None else meta
    l0s, mtk, B = meta.l0s_t, meta.tk, plan.B

    def fn(seeds_loc, m_loc, mp_loc, cb_rep, rhs2):
        return dfk.dwt_fused(seeds_loc, m_loc, mp_loc, cb_rep, rhs2, l0s,
                             B=B, tk=mtk)

    return LocalDWT((meta.seeds, meta.m, meta.mp, meta.cb),
                    (True, True, True, False), fn)


def make_fused_local_idwt(plan: SoftPlan, n_shards: int, *, tk=None,
                          meta: ShardMeta | None = None) -> LocalDWT:
    """Inverse twin of :func:`make_fused_local_dwt` (no d-table shard)."""
    from repro_torch.kernels import dwt_fused as dfk

    meta = fused_shard_meta(plan, n_shards, tk) if meta is None else meta
    l0s, mtk, B = meta.l0s_t, meta.tk, plan.B

    def fn(seeds_loc, m_loc, mp_loc, cb_rep, lhs2):
        return dfk.idwt_fused(seeds_loc, m_loc, mp_loc, cb_rep, lhs2, l0s,
                              B=B, tk=mtk)

    return LocalDWT((meta.seeds, meta.m, meta.mp, meta.cb),
                    (True, True, True, False), fn)


# ---------------------------------------------------------------------------
# the mesh-resident executor
# ---------------------------------------------------------------------------

class DistExecutor:
    """Sharded FSOFT / iFSOFT executors of one (plan, mesh, axis) pairing.

    Construction resolves the shard group and this rank's place in it,
    validates mesh compatibility, and binds the device-local DWT / iDWT
    closures (``local_dwt`` / ``local_idwt``: None -> plain einsum over
    the rank's d-table block, a bare fn(d_shard, x2), or a
    :class:`LocalDWT` such as :func:`make_fused_local_dwt`).  The mesh's
    device type must be the plan's.

      forward(f) / inverse(packed)        single transform, global tensors
      forward_lanes / inverse_lanes       exactly-V stack of rank-local
                                          shards: ONE all-to-all and one
                                          local launch for all V
      forward_batch / inverse_batch       any count of global tensors,
                                          chunked to lane_width

    ``overlap`` sets the batch executors' default mode
    (:data:`OVERLAP_MODES`); they accept a per-call ``overlap=``.
    """

    def __init__(self, plan: SoftPlan, mesh, axis=("data", "model"), *,
                 lane_width: int = 1, local_dwt=None, local_idwt=None,
                 overlap: str = "off"):
        self.mesh = mesh
        self.axis = mesh_axes(axis)
        n_shards = mesh_shards(mesh, self.axis)
        if mesh.device_type != plan.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r} devices, "
                             f"the plan on {plan.device}")
        group = shard_group(mesh, self.axis)
        self._bind(plan, n_shards, group, dist.get_rank(group), lane_width,
                   local_dwt, local_idwt, overlap)

    def _bind(self, plan, n_shards, group, rank, lane_width, local_dwt,
              local_idwt, overlap):
        """Rank ``rank`` of ``n_shards``' tables and closures, built once
        (split from the constructor so that the dry run can trace one
        rank's program with no process group)."""
        self.plan = plan
        self.n_shards = n_shards
        check_mesh_compat(plan, n_shards)
        if lane_width < 1:
            raise ValueError(f"lane_width must be >= 1, got {lane_width}")
        self.lane_width = int(lane_width)
        self.overlap = check_overlap_mode(overlap)
        self.group = group
        self.rank = rank
        self._ld = _normalize_local_dwt(plan, local_dwt, "klj,kjc->klc")
        self._lid = _normalize_local_dwt(plan, local_idwt, "klj,klc->kjc")
        n, s = self.n_shards, self.rank
        self.kloc = plan.n_padded // n
        self.jloc = 2 * plan.B // n
        self._k = slice(s * self.kloc, (s + 1) * self.kloc)
        self._j = slice(s * self.jloc, (s + 1) * self.jloc)
        self.C = plan.gather_m.shape[1]
        # the rank's blocks of the tables, built once
        self._refl = plan.reflected[self._k]
        self._sign_loc = plan.sign[self._k]
        self._w_loc = plan.w[self._j]
        self._out_sign = _refl_sign(self._refl, plan.parity)   # (kloc, L, C)
        self._dwt_ops = self._ld.local_operands(s, n)
        self._idwt_ops = self._lid.local_operands(s, n)

    @property
    def _cdtype(self) -> torch.dtype:
        return self.plan.cdtype

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.plan.device).to(self._cdtype)

    # -- the three stages of each direction -----------------------------
    #
    #   forward:  stage 1 beta-local FFT + gather -> all-to-all -> stage 2
    #             local DWT kernel + sign / scale
    #   inverse:  stage 1 signs + local iDWT kernel + reflection flip ->
    #             all-to-all -> stage 2 bin scatter + FFT synthesis

    def _fwd_stage1(self, f_loc):
        """(V, 2B, jloc, 2B) beta shards -> send buffer (K, jloc, V*C*2)."""
        p = self.plan
        S = fft_analysis(f_loc)                       # (V, 2B, jloc, 2B)
        Sm = _at_members(p, S)                        # (V, K, C, jloc)
        del S
        r = Sm * (p.sign[..., None] * self._w_loc)
        del Sm
        rhs = torch.view_as_real(r).transpose(-3, -2)  # (V, K, jloc, C, 2)
        V, K, jloc = rhs.shape[:3]
        return rhs.movedim(0, 2).reshape(K, jloc, V * self.C * 2) \
            .contiguous()

    def _fwd_stage2(self, rhs):
        """(Kloc, J, V*C*2) -> packed (V, Kloc, L, C) complex."""
        p, C = self.plan, self.C
        Kn, J, VC2 = rhs.shape
        V = VC2 // (C * 2)
        rhs = rhs.reshape(Kn, J, V, C, 2)
        rhs = torch.where(self._refl[:, None, None, :, None], rhs.flip(1),
                          rhs)
        out = self._ld.fn(*self._dwt_ops, rhs.reshape(Kn, J, VC2))
        del rhs
        outc = _as_complex(out.reshape(Kn, p.B, V, C, 2))  # (Kloc, L, V, C)
        outc = outc * (self._out_sign[:, :, None, :]
                       * p.scale[None, :, None, None])
        return outc.movedim(2, 0)                     # (V, Kloc, L, C)

    def _inv_stage1(self, packed_loc):
        """(V, Kloc, L, C) -> send buffer (n, Kloc, jloc, V*C*2)."""
        C, n = self.C, self.n_shards
        lhs = packed_loc * (self._out_sign[None]
                            * self._sign_loc[None, :, None, :])
        lhs = torch.view_as_real(lhs)                 # (V, Kloc, L, C, 2)
        V, Kn, L = lhs.shape[:3]
        lhs = lhs.movedim(0, 2).reshape(Kn, L, V * C * 2).contiguous()
        g = self._lid.fn(*self._idwt_ops, lhs)        # (Kloc, J, V*C*2)
        del lhs
        J = g.shape[1]
        g = g.reshape(Kn, J, V, C, 2)
        g = torch.where(self._refl[:, None, None, :, None], g.flip(1), g)
        # split J into the n ranks' beta blocks, destination first
        return g.reshape(Kn, n, J // n, V * C * 2).transpose(0, 1) \
            .contiguous()

    def _inv_stage2(self, g):
        """received (n, Kloc, jloc, V*C*2) = (K, jloc, V*C*2) -> samples
        (V, 2B, jloc, 2B)."""
        C = self.C
        g = g.reshape(-1, *g.shape[2:])               # (K, jloc, V*C*2)
        K, jloc, VC2 = g.shape
        gc = _as_complex(g.reshape(K, jloc, VC2 // (C * 2), C, 2))
        return fft_synthesis(_scatter_bins_nomirror(self.plan,
                                                    gc.movedim(2, 0)))

    def _recv_fwd(self, y):
        """received (n*Kloc, jloc, V*C*2), block i from rank i's beta
        rows -> (Kloc, J, V*C*2)."""
        n = self.n_shards
        return y.reshape(n, self.kloc, self.jloc, -1).transpose(0, 1) \
            .reshape(self.kloc, n * self.jloc, -1)

    def _all_to_all(self, send, direction, out=None, async_op=False):
        """ONE all-to-all of the lane-packed chunk; returns (out, work)."""
        out = torch.empty_like(send) if out is None else out
        work = dist.all_to_all_single(out, send, group=self.group,
                                      async_op=async_op)
        ALL_TO_ALLS[direction] += 1
        return out, work

    # -- executors on rank-local shards ---------------------------------

    def forward_lanes(self, fs_loc):
        """Exactly-V stack of this rank's beta shards (V, 2B, J/n, 2B) ->
        packed (V, K/n, L, C) of its clusters: one all-to-all and one
        local DWT launch for the whole stack."""
        send = self._fwd_stage1(self._as_input(fs_loc))
        recv, _ = self._all_to_all(send, "forward")
        del send
        return self._fwd_stage2(self._recv_fwd(recv))

    def inverse_lanes(self, packed_loc):
        """Exactly-V packed stack of this rank's clusters (V, K/n, L, C) ->
        its beta shards of the samples (V, 2B, J/n, 2B)."""
        send = self._inv_stage1(self._as_input(packed_loc))
        recv, _ = self._all_to_all(send, "inverse")
        del send
        return self._inv_stage2(recv)

    # -- executors on global tensors ------------------------------------

    def _beta_shard(self, fs):
        return fs[..., self._j, :]

    def _cluster_shard(self, packed):
        return packed[:, self._k]

    def _gather(self, x, dim: int):
        """All-gather the rank shards of ``x`` along ``dim`` (rank order)."""
        if self.n_shards == 1:
            return x
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.n_shards * x.shape[0],) + x.shape[1:],
                          dtype=x.dtype, device=x.device)
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(torch.view_as_real(out), torch.view_as_real(x),
               group=self.group)
        return out.movedim(0, dim)

    def forward(self, f):
        """FSOFT: samples (2B, 2B, 2B) -> packed coefficients (K, L, C),
        on every rank."""
        f = self._as_input(f)
        return self._gather(self.forward_lanes(self._beta_shard(f[None])),
                            1)[0]

    def inverse(self, packed):
        """iFSOFT: packed coefficients (K, L, C) -> samples (2B, 2B, 2B),
        on every rank."""
        packed = self._as_input(packed)
        return self._gather(self.inverse_lanes(
            self._cluster_shard(packed[None])), 2)[0]

    def forward_batch(self, fs, *, stats=None, overlap=None):
        """(n, 2B, 2B, 2B) -> packed (n, K, L, C): any request count,
        chunked onto lane_width-wide sharded launches (the final partial
        chunk zero-padded).  ``overlap`` overrides the executor's default
        mode for this call."""
        return self._batch(fs, True, stats, overlap)

    def inverse_batch(self, packed, *, stats=None, overlap=None):
        """(n, K, L, C) -> samples (n, 2B, 2B, 2B); see
        :meth:`forward_batch`."""
        return self._batch(packed, False, stats, overlap)

    def _batch(self, xs, fwd: bool, stats, overlap=None):
        from repro_torch.kernels import ops as kops  # deferred: kernels import core
        mode = check_overlap_mode(self.overlap if overlap is None
                                  else overlap)
        xs = self._as_input(xs)
        p = self.plan
        if xs.shape[0] == 0:
            shape = ((p.n_padded, p.B, self.C) if fwd else (2 * p.B,) * 3)
            return torch.zeros((0,) + shape, dtype=self._cdtype,
                               device=p.device)
        local = self._beta_shard(xs) if fwd else self._cluster_shard(xs)
        if mode == "pipelined":
            out = self._batch_pipelined(local, fwd, stats)
        else:
            V = self.lane_width
            lanes_fn = self.forward_lanes if fwd else self.inverse_lanes
            direction = "forward" if fwd else "inverse"
            outs = []
            for n0 in range(0, local.shape[0], V):
                chunk, n = kops.pad_lanes(local[n0: n0 + V], V)
                # host-side span: it times the dispatch (launches stay
                # asynchronous), not the device; obs.device_annotation
                # puts it in a torch.profiler capture's timeline
                with obs.span("executor.chunk", mode="off",
                              direction=direction, chunk=n0 // V, lanes=n,
                              n_shards=self.n_shards), \
                        obs.device_annotation(f"executor.chunk.{direction}"):
                    o = lanes_fn(chunk)
                if stats is not None:
                    stats["launches"] += 1
                    stats["transforms"] += n
                    stats["padded_lanes"] += V - n
                outs.append(o[:n])
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return self._gather(out, 1 if fwd else 2)

    def _batch_pipelined(self, local, fwd: bool, stats):
        """The chunks through the two-slot pipeline.  Launch accounting
        equals the serial path's (one local launch and one all-to-all per
        chunk); only their schedule differs."""
        n, V = local.shape[0], self.lane_width
        n_chunks = -(-n // V)
        pad = n_chunks * V - n
        if pad:
            local = torch.cat([local, local.new_zeros((pad,)
                                                      + local.shape[1:])])
        chunks = local.reshape((n_chunks, V) + local.shape[1:])
        direction = "forward" if fwd else "inverse"
        # host-side span, as the serial path's: it times the dispatch
        with obs.span("executor.pipeline", direction=direction,
                      n_chunks=n_chunks, lanes=n, padded=pad,
                      n_shards=self.n_shards,
                      slots=[list(s) for s in pipeline_slots(n_chunks)]), \
                obs.device_annotation(f"executor.pipeline.{direction}"):
            outs = (self._forward_pipe(chunks) if fwd
                    else self._inverse_pipe(chunks))
        if stats is not None:
            stats["launches"] += n_chunks
            stats["transforms"] += n
            stats["padded_lanes"] += pad
        out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=0)
        return out[:n]

    def _forward_pipe(self, chunks):
        """Chunk i+1's stage 1 and all-to-all are issued before chunk i's
        slot is waited on and its local DWT kernel launched: the
        collective in flight writes the other slot."""
        nc = chunks.shape[0]
        send = self._fwd_stage1(chunks[0])
        slots = [torch.empty_like(send) for _ in range(min(nc, 2))]
        inflight = [self._all_to_all(send, "forward", slots[0], True)[1]]
        sends = [send]                 # alive until their collective ends
        outs = []
        for i in range(nc):
            if i + 1 < nc:
                nxt = self._fwd_stage1(chunks[i + 1])
                inflight.append(self._all_to_all(
                    nxt, "forward", slots[(i + 1) % 2], True)[1])
                sends.append(nxt)
            inflight[i].wait()
            sends[i] = None
            outs.append(self._fwd_stage2(self._recv_fwd(slots[i % 2])))
        return outs

    def _inverse_pipe(self, chunks):
        """Chunk i's all-to-all is issued before chunk i+1's local iDWT
        kernel launches, and waited on before its slot is read."""
        nc = chunks.shape[0]
        send = self._inv_stage1(chunks[0])
        slots = [torch.empty_like(send) for _ in range(min(nc, 2))]
        outs = []
        for i in range(nc):
            _, work = self._all_to_all(send, "inverse", slots[i % 2], True)
            nxt = self._inv_stage1(chunks[i + 1]) if i + 1 < nc else None
            work.wait()
            send = nxt
            outs.append(self._inv_stage2(slots[i % 2]))
        return outs


_EXECUTORS: collections.OrderedDict = collections.OrderedDict()
_EXECUTORS_MAX = 8


def dist_executor(plan: SoftPlan, mesh, axis=("data", "model")) -> DistExecutor:
    """Memoized default-contraction executor per (plan, mesh, axis)
    identity -- what :func:`distributed_forward` / :func:`distributed_inverse`
    run on (the 8 most recent pairings)."""
    axis = mesh_axes(axis)
    key = (id(plan), id(mesh), axis)
    ex = _EXECUTORS.get(key)
    if ex is None or ex.plan is not plan or ex.mesh is not mesh:
        ex = DistExecutor(plan, mesh, axis)
        _EXECUTORS[key] = ex
    _EXECUTORS.move_to_end(key)
    while len(_EXECUTORS) > _EXECUTORS_MAX:
        _EXECUTORS.popitem(last=False)
    return ex


def distributed_forward(plan: SoftPlan, f, mesh, axis=("data", "model"),
                        local_dwt=None):
    """FSOFT on a mesh: samples (2B, 2B, 2B) -> packed coefficients
    (K, B, 8), on every rank.  A shim over :class:`DistExecutor`: prefer
    ``repro_torch.plan(B, mesh=...).forward``.  ``local_dwt`` swaps the
    device-local contraction and builds an executor for this call."""
    if local_dwt is not None:
        return DistExecutor(plan, mesh, axis, local_dwt=local_dwt).forward(f)
    return dist_executor(plan, mesh, axis).forward(f)


def distributed_inverse(plan: SoftPlan, packed, mesh, axis=("data", "model"),
                        local_idwt=None):
    """iFSOFT on a mesh: packed coefficients (K, B, 8) -> samples
    (2B, 2B, 2B), on every rank; see :func:`distributed_forward`."""
    if local_idwt is not None:
        return DistExecutor(plan, mesh, axis,
                            local_idwt=local_idwt).inverse(packed)
    return dist_executor(plan, mesh, axis).inverse(packed)


# ---------------------------------------------------------------------------
# packed <-> dense coefficient layout
# ---------------------------------------------------------------------------

def packed_to_dense(plan: SoftPlan, packed):
    """packed[k, l, c] -> dense fhat[l, m + B - 1, m' + B - 1]."""
    return packed_to_dense_batch(plan, torch.as_tensor(packed)[None])[0]


def dense_to_packed(plan: SoftPlan, fhat):
    """dense fhat -> packed[k, l, c] (raw member coefficients, no signs)."""
    return dense_to_packed_batch(plan, torch.as_tensor(fhat)[None])[0]


def packed_to_dense_batch(plan: SoftPlan, packed):
    """(V, K, L, C) packed lane stack -> (V, B, 2B-1, 2B-1) dense.  Unused
    member slots land on the trash cell (2B-1, 2B-1), sliced off."""
    B = plan.B
    packed = torch.as_tensor(packed, device=plan.device)
    V = packed.shape[0]
    buf = torch.zeros((V, B, 2 * B, 2 * B), dtype=packed.dtype,
                      device=packed.device)
    buf[:, :, plan.scatter_m.reshape(-1), plan.scatter_mp.reshape(-1)] = \
        packed.transpose(1, 2).reshape(V, B, -1)
    return buf[:, :, : 2 * B - 1, : 2 * B - 1]


def dense_to_packed_batch(plan: SoftPlan, fhat):
    """(V, B, 2B-1, 2B-1) dense stack -> (V, K, L, C) packed."""
    fhat = torch.as_tensor(fhat, device=plan.device)
    fpad = torch.nn.functional.pad(fhat, (0, 1, 0, 1))
    lhs = fpad[:, :, plan.scatter_m, plan.scatter_mp]     # (V, L, K, C)
    return lhs.transpose(1, 2)                            # (V, K, L, C)
