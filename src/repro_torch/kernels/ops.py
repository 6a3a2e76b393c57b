"""Binds the DWT kernels to the clustered transforms -- the port of
``repro/kernels/ops.py``.

  * :func:`make_dwt_fn` / :func:`make_idwt_fn` -- drop-in replacements for
    core.batched.dwt_apply / idwt_apply (plug into forward_clustered /
    inverse_clustered through their dwt_fn / idwt_fn argument), with
    ``batch=V`` packing V transforms onto the kernel's lane axis so one
    launch serves the whole stack.  Schedules (``impl``):

      "fused"    the ragged on-the-fly kernels (:mod:`.dwt_fused`);
                 ``lchunk`` / ``precision="bf16"`` select their l-chunked
                 streaming twins (:mod:`.streaming`)
      "onthefly" every degree of every cluster, no skip (:mod:`.wigner_rec`)
      "dense"    the plan's resident (K, L, J) table (:mod:`.dwt`)
      "ragged"   the dense forward on the host work list of
                 (cluster-tile, l-tile) blocks; forward only
  * :func:`onthefly_inputs` / :func:`fused_metadata` /
    :func:`_ragged_metadata` -- the per-plan seed rows, the
    l-start-sorted tile schedule and the ragged work list, memoized per
    plan, weakly (:func:`repro_torch.core.batched.plan_memo`): they go
    with their plan.
  * :func:`streaming_inputs` -- the launch-order operands and the window
    stack of the streaming kernels, built once per (plan, tk, lchunk,
    precision, :func:`window_source`).

  * :func:`attention` -- the folded causal attention kernel
    (:mod:`.folded_attention`), the LM prefill's attention.

The fused and ragged kernels run in the l-start-sorted cluster order and
read and write the caller's (K, ., C2) stacks (and the ragged kernel the
table) through ``perm`` in place: no permuted copy is ever made.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quadrature, wigner
from repro_torch.core.batched import (SoftPlan, plan_lstart, plan_memo,
                                      resolve_device)

from . import autotune, dwt_fused, streaming, wigner_rec
from . import dwt as dwt_kernels
from . import folded_attention as fa

__all__ = ["attention", "make_dwt_fn", "make_idwt_fn", "onthefly_inputs",
           "onthefly_inputs_from_arrays", "fused_metadata", "check_impl",
           "KERNEL_IMPLS", "RaggedMeta",
           "launch_inputs", "streaming_inputs", "window_source",
           "host_window_stack",
           "pack_lanes", "unpack_lanes", "pad_lanes"]

# The schedules make_dwt_fn runs; the plan's "reference" is the einsum.
KERNEL_IMPLS = ("dense", "ragged", "onthefly", "fused")


def pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """(V, K, A, C, 2) -> (K, A, V*C*2): V batched transforms side by side
    on the contraction lane axis, one kernel launch for the whole batch."""
    V, K, A, C, _ = x.shape
    return x.movedim(0, 2).reshape(K, A, V * C * 2)


def unpack_lanes(x: torch.Tensor, V: int, C: int) -> torch.Tensor:
    """(K, A, V*C*2) -> (V, K, A, C, 2), inverse of pack_lanes."""
    K, A, _ = x.shape
    return x.reshape(K, A, V, C, 2).movedim(2, 0)


def pad_lanes(x: torch.Tensor, V: int):
    """Zero-pad a partial transform stack (n, ...) with n <= V up to the
    lane width V.  Returns (padded, n); the padded lanes produce zero
    outputs the caller slices off."""
    n = x.shape[0]
    if n > V:
        raise ValueError(f"stack of {n} transforms exceeds lane width {V}")
    if n < V:
        x = torch.cat([x, x.new_zeros((V - n,) + tuple(x.shape[1:]))])
    return x, n


class RaggedMeta(NamedTuple):
    """The ragged schedule of one (plan, tk, tl): host arrays as the
    reference builds them (perm, l_start, kk, ll: numpy; n_dense: the
    dense grid's block count) and their device tensors (perm_t, kk_t,
    ll_t int32; mask: (K, L) bool, l >= l_start, in the plan's order)."""
    perm: np.ndarray
    l_start: np.ndarray
    kk: np.ndarray
    ll: np.ndarray
    n_dense: int
    perm_t: torch.Tensor
    kk_t: torch.Tensor
    ll_t: torch.Tensor
    mask: torch.Tensor


@plan_memo
def _ragged_metadata(plan: SoftPlan, tk: int, tl: int) -> RaggedMeta:
    """Host-side: sort clusters by l-start so tiles bucket uniform work,
    then enumerate the work list's blocks (the reference's sort: padded
    clusters get l_start 0 and sort to the front -- their table rows are
    zero, and the mask covers them).  Memoized by (plan, tk, tl)
    identity, device tensors and mask included."""
    l_start = np.zeros(plan.n_padded, np.int32)
    l_start[: plan.n_clusters] = plan.table.rep[:, 0]
    perm = np.argsort(l_start, kind="stable").astype(np.int32)
    kk, ll, n_dense = dwt_kernels.build_work_list(l_start[perm], tk, tl,
                                                  plan.B)
    dev = plan.device
    mask = np.arange(plan.B)[None, :] >= l_start[:, None]
    return RaggedMeta(perm, l_start, kk, ll, n_dense,
                      torch.as_tensor(perm, device=dev),
                      torch.as_tensor(kk, device=dev),
                      torch.as_tensor(ll, device=dev),
                      torch.as_tensor(mask, device=dev))


@plan_memo
def fused_metadata(plan: SoftPlan, tk: int):
    """Host-side ragged metadata for the fused kernels: sort clusters by
    ascending l-start (padded rows last, at B-1 -- their Wigner rows are
    identically zero) and reduce each TK-tile to its first degree l0.
    Returns numpy (perm, l_start, l0s).  Memoized by (plan, tk) identity.

    On the card the sort also orders the blocks longest-first."""
    l_start = plan_lstart(plan)
    perm = np.argsort(l_start, kind="stable").astype(np.int32)
    l0s = dwt_fused.build_tile_lstarts(l_start[perm], tk)
    return perm, l_start, l0s


def onthefly_inputs_from_arrays(seeds, m, mp, cos_beta, *, device=None,
                                dtype=None):
    """Kernel inputs (seeds, m, mp, cos_beta) as tensors on ``device``
    (default: the card) from numpy arrays -- e.g. those of
    ``repro.kernels.ops.onthefly_inputs`` -- so that both packages can
    run on identical inputs.  ``dtype`` defaults to the seeds' dtype."""
    device = resolve_device(device)
    seeds = torch.tensor(np.asarray(seeds), device=device, dtype=dtype)
    dt = seeds.dtype
    return (seeds,
            torch.tensor(np.asarray(m, np.int32), device=device),
            torch.tensor(np.asarray(mp, np.int32), device=device),
            torch.tensor(np.asarray(cos_beta), device=device, dtype=dt))


@plan_memo
def onthefly_inputs(plan: SoftPlan):
    """Seeds/orders/cos(beta) for the fused kernels, on the plan's device.

    Padded clusters get zero seeds -> identically zero Wigner rows.
    Memoized by plan identity: the seed-table build (one wigner_seed per
    cluster) runs once per plan."""
    B = plan.B
    beta = quadrature.betas(B)
    K = plan.n_padded
    seeds = np.zeros((K, 2 * B))
    m = np.zeros(K, np.int32)
    mp = np.zeros(K, np.int32)
    for kidx in range(plan.n_clusters):
        mm, mmp = plan.table.rep[kidx]
        seeds[kidx] = wigner.wigner_seed(int(mm), int(mmp), beta)
        m[kidx], mp[kidx] = mm, mmp
    return onthefly_inputs_from_arrays(seeds, m, mp, np.cos(beta),
                                       device=plan.device, dtype=plan.dtype)


def _split_ri(x):
    """(K, A, C, 2) -> (K, A, C*2) merging the real/imag axis into lanes."""
    return x.reshape(*x.shape[:2], -1)


def _unsplit_ri(x, c):
    return x.reshape(*x.shape[:2], c, 2)


def _wrap_batch(raw, batch):
    """Lift raw(p, x2: (K, A, C2)) to the (plan, x) dwt_fn contract.

    batch=None: x (K, A, C, 2) (the single-transform contract).
    batch=V (any int >= 1): x (V, K, A, C, 2); the V transforms are
    packed onto the lane axis so the kernel launches once.
    """
    if batch is None:
        def fn(p: SoftPlan, x):
            if x.ndim != 4:
                raise ValueError(f"dwt_fn built without batch expects "
                                 f"(K, A, C, 2), got {tuple(x.shape)}; pass "
                                 f"batch=V to make_dwt_fn for a V-stack")
            return _unsplit_ri(raw(p, _split_ri(x)), x.shape[2])
        return fn

    def fn(p: SoftPlan, x):
        if x.ndim != 5 or x.shape[0] != batch:
            raise ValueError(f"dwt_fn built with batch={batch}, expected "
                             f"(V, K, A, C, 2), got {tuple(x.shape)}")
        return unpack_lanes(raw(p, pack_lanes(x)), batch, x.shape[3])
    return fn


def check_impl(impl, lchunk, precision) -> None:
    """Raise ValueError on a schedule this port does not know, or on
    streaming options (lchunk, precision="bf16") for a schedule that has
    no streaming twin (all but "fused")."""
    if precision not in (None, *autotune.PRECISIONS):
        raise ValueError(f"precision must be 'fp32' or 'bf16', "
                         f"got {precision!r}")
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"impl must be one of {KERNEL_IMPLS}, got {impl!r}")
    if (lchunk is not None or precision == "bf16") and impl != "fused":
        raise ValueError(
            f"lchunk/precision='bf16' need the streaming kernels, which "
            f"exist only for impl='fused' (got impl={impl!r})")


def window_source() -> str:
    """Where :func:`streaming_inputs` takes its window stack from:
    "device" (default; :func:`repro_torch.kernels.streaming.build_windows`,
    the march the kernels themselves run, so chunked equals monolithic bit
    for bit) or "host" ($REPRO_WINDOW_SOURCE=host; :func:`host_window_stack`,
    staged chunk by chunk from the float64 host generator)."""
    src = os.environ.get("REPRO_WINDOW_SOURCE", "device")
    if src not in ("device", "host"):
        raise ValueError(f"$REPRO_WINDOW_SOURCE must be 'device' or "
                         f"'host', got {src!r}")
    return src


def host_window_stack(plan: SoftPlan, tk: int, lchunk: int,
                      precision: str = "fp32") -> torch.Tensor:
    """Window stack (nL, 2, K, J) on the plan's device, staged chunk by
    chunk from the host recurrence generator
    (:func:`repro_torch.core.wigner.wigner_window_iter`).

    The host holds the generator's O(P*J) panels plus one (2, K, J)
    staging buffer: each chunk's window is mapped from fundamental-pair
    rows to the l-start-sorted padded cluster order (padded rows zero)
    and copied to the device before the next chunk is marched.  Equal to
    the device builder within float64 rounding, not bit for bit."""
    perm, _, _ = fused_metadata(plan, min(tk, plan.n_padded))
    rows = np.full(plan.n_padded, -1, np.int64)
    rows[: plan.n_clusters] = plan.table.fund_row
    rows = rows[perm]
    valid = rows >= 0
    sdt = streaming.storage_dtype(plan.dtype, precision)
    out = torch.empty((plan.B // lchunk, 2, plan.n_padded, 2 * plan.B),
                      dtype=sdt, device=plan.device)
    stage = np.zeros((2, plan.n_padded, 2 * plan.B))
    for c, win in enumerate(wigner.wigner_window_iter(plan.B, lchunk)):
        stage[:] = 0.0
        stage[:, valid, :] = win[:, rows[valid], :]
        # torch.tensor copies: torch.from_numpy would alias `stage`, which
        # the next chunk rewrites
        out[c] = torch.tensor(stage, dtype=plan.dtype).to(sdt)
    return out


def streaming_inputs(plan: SoftPlan, tk: int, lchunk: int, precision: str):
    """Launch-order operands and window stack of the streaming kernels:
    (seeds, m, mp, cos_beta, l0s, perm, windows), all on the plan's
    device.  Memoized by (plan, tk, lchunk, precision,
    :func:`window_source`): the windows are built once per configuration,
    on the l-start-sorted cluster order the fused family launches in."""
    return _streaming_inputs(plan, tk, lchunk, precision, window_source())


@plan_memo
def _streaming_inputs(plan: SoftPlan, tk: int, lchunk: int, precision: str,
                      source: str):
    from repro_torch import obs

    seeds, m, mp, cb, l0s, perm = launch_inputs(plan, tk)
    with obs.span("plan.build.window", B=plan.B, lchunk=lchunk,
                  precision=precision, source=source):
        if source == "host":
            windows = host_window_stack(plan, tk, lchunk, precision)
        else:
            windows = streaming.build_windows(seeds, m, mp, cb, L=plan.B,
                                              lchunk=lchunk,
                                              precision=precision)
    return seeds, m, mp, cb, l0s, perm, windows


@plan_memo
def launch_inputs(plan: SoftPlan, tk: int):
    """(seeds, m, mp, cos_beta, l0s, perm) in the kernels' launch order,
    on the plan's device; perm is int32 (K,)."""
    seeds, m, mp, cb = onthefly_inputs(plan)
    perm_np, _, l0s_np = fused_metadata(plan, tk)
    perm = torch.as_tensor(perm_np, device=plan.device)
    l0s = torch.as_tensor(l0s_np, device=plan.device)
    order = perm.to(torch.int64)
    return (seeds[order], m[order], mp[order], cb, l0s, perm)


def _table_fn(plan: SoftPlan, direction: str, impl: str, tk: int, tl: int,
              batch):
    """The dense / ragged schedules, on the plan's resident table (the
    kernels have no beta tile: tj is the whole J)."""
    d = plan.require_dense(f"make_{direction}_fn(impl={impl!r})")
    tj = d.shape[2]
    tk, tl, _ = dwt_kernels.check_tiles(*d.shape, tk, tl, tj)
    if impl == "dense":
        kernel = dwt_kernels.dwt_dense if direction == "dwt" \
            else dwt_kernels.idwt_dense

        def raw(p: SoftPlan, x2):
            return kernel(d, x2, tk=tk, tl=tl, tj=tj)
        return _wrap_batch(raw, batch)

    if direction == "idwt":
        raise ValueError("impl='ragged' has no inverse kernel; its plans run "
                         "the inverse on impl='dense' (Schedule.inverse_impl)")
    meta = _ragged_metadata(plan, tk, tl)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    def raw(p: SoftPlan, x2):
        out = dwt_kernels.dwt_ragged(d, x2, meta.kk_t, meta.ll_t, tk=tk,
                                     tl=tl, tj=tj, perm=meta.perm_t)
        return torch.where(meta.mask[:, :, None], out, zero)
    return _wrap_batch(raw, batch)


def _onthefly_fn(plan: SoftPlan, direction: str, tk: int, batch):
    seeds, m, mp, cb = onthefly_inputs(plan)
    kernel = wigner_rec.dwt_onthefly if direction == "dwt" \
        else wigner_rec.idwt_onthefly

    def raw(p: SoftPlan, x2):
        return kernel(seeds, m, mp, cb, x2, B=p.B, tk=tk)
    return _wrap_batch(raw, batch)


def _kernel_fn(plan: SoftPlan, direction: str, impl: str, tk: int, tl: int,
               lchunk, precision, batch):
    check_impl(impl, lchunk, precision)
    if impl in ("dense", "ragged"):
        return _table_fn(plan, direction, impl, tk, tl, batch)
    if impl == "onthefly":
        return _onthefly_fn(plan, direction, tk, batch)
    tk = min(tk, plan.n_padded)
    if lchunk is None and precision != "bf16":
        seeds, m, mp, cb, l0s, perm = launch_inputs(plan, tk)
        kernel = dwt_fused.dwt_fused if direction == "dwt" \
            else dwt_fused.idwt_fused

        def raw(p: SoftPlan, x2):
            return kernel(seeds, m, mp, cb, x2, l0s, B=p.B,
                          tk=tk, perm=perm)
        return _wrap_batch(raw, batch)

    precision = precision or "fp32"
    lchunk = streaming.check_lchunk(plan.B, plan.B if lchunk is None
                                    else lchunk)
    seeds, m, mp, cb, l0s, perm, windows = streaming_inputs(
        plan, tk, lchunk, precision)
    kernel = streaming.dwt_streaming if direction == "dwt" \
        else streaming.idwt_streaming

    def raw(p: SoftPlan, x2):
        return kernel(seeds, m, mp, cb, x2, l0s, windows,
                      B=p.B, tk=tk, lchunk=lchunk, precision=precision,
                      perm=perm)
    return _wrap_batch(raw, batch)


def make_dwt_fn(plan: SoftPlan, impl: str = "fused", *, tk: int = 8,
                tl: int = 128, lchunk=None, precision=None, batch=None):
    """Build a dwt_fn(plan, rhs) for core.batched.forward_clustered.

    impl: "fused" | "onthefly" | "dense" | "ragged" (the module
    docstring); "dense" and "ragged" need the plan's table (a plan built
    streaming raises ValueError).  tk / tl: the reference's cluster and
    degree tiles (they shape the ragged work list; each must divide its
    axis).  batch=V makes the fn accept a (V, K, J, C, 2)
    stack contracted in ONE kernel launch with V*C*2 lanes.  lchunk
    selects the l-chunked streaming kernel (chunks of lchunk degrees,
    each resumed from a two-row recurrence window); precision: None /
    "fp32" (the plan dtype) or "bf16" (bf16 windows and Wigner rows,
    plan-dtype state and sums; always the streaming kernel, at lchunk=B
    unless given).  Both exist only for impl="fused".
    """
    return _kernel_fn(plan, "dwt", impl, tk, tl, lchunk, precision, batch)


def make_idwt_fn(plan: SoftPlan, impl: str = "fused", *, tk: int = 8,
                 tl: int = 128, lchunk=None, precision=None, batch=None):
    """Build an idwt_fn(plan, lhs) for core.batched.inverse_clustered;
    see :func:`make_dwt_fn`.  impl="ragged" raises ValueError, as in the
    reference: the ragged grid has no inverse kernel."""
    return _kernel_fn(plan, "idwt", impl, tk, tl, lchunk, precision, batch)


# Folded causal flash attention (kernels/folded_attention.py): the CUDA
# kernel for CUDA tensors, its plain version for CPU ones.  The same
# function under the reference's name, repro.kernels.ops.attention, so that
# the LM stack and the tests of both packages call one name.
attention = fa.folded_causal_attention
