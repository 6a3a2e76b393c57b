"""Causal flash attention with the paper's triangle fold: the CUDA kernel's
wrapper, its launch count and its plain torch version.

Port of ``repro/kernels/folded_attention.py`` (the Pallas TPU kernel
``folded_causal_attention``).  The kernel is ``csrc/folded_attention.cu``
(see its header for the design and what bounds it).  On the TPU the fold
shrinks a sequential grid from Qb^2 to (Qb/2)(Qb+1) slots; on the card it
is a work distribution: block t of a (batch, head) runs q-blocks t and
Qb-1-t, Qb+1 kv steps in every block.  :func:`grid_slots` keeps the
reference's slot count, the schedule-balance metric.

The wrapper takes the plain version (:func:`folded_causal_attention_plain`)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  :data:`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import runtime
from .runtime import route

__all__ = ["folded_causal_attention", "folded_causal_attention_plain",
           "grid_slots", "schedule_order", "check_kernel_operands",
           "KERNEL_BQ", "KERNEL_D", "max_bq", "LAUNCHES",
           "reset_launches"]

# kernel launches per wrapper; only the CUDA branch adds to it
LAUNCHES = {"folded_causal_attention": 0}

# the block sizes and head widths the kernel is instantiated for; a head
# width takes the block sizes up to max_bq(D)
KERNEL_BQ = (16, 32, 64, 128)
KERNEL_D = (32, 36, 64, 128, 192, 256)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def max_bq(D: int) -> int:
    """The largest q-block the kernel takes at head width D, in either
    dtype: 128, or 64 at D > 128, where the tiles of bq 128 (five bf16
    tiles of the tensor-core kernel, three f32 tiles of the scalar one;
    csrc/folded_attention.cu ``max_bq``) exceed the 227 KB of shared
    memory of a block."""
    return 64 if D > 128 else 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def grid_slots(seq: int, bq: int, schedule: str) -> int:
    """Grid slots executed per (batch, head) -- the schedule-balance metric."""
    qb = seq // bq
    return qb * qb if schedule == "naive" else (qb // 2) * (qb + 1)


def schedule_order(qb_count: int, schedule: str) -> list[list[int]]:
    """The q-blocks each launch block runs, in order: [t, Qb-1-t] for
    t < Qb/2 (folded) or [qb] (naive)."""
    if schedule == "folded":
        return [[t, qb_count - 1 - t] for t in range(qb_count // 2)]
    return [[qb] for qb in range(qb_count)]


# ---------------------------------------------------------------------------
# plain version: the kernel's schedule and block step in torch
# ---------------------------------------------------------------------------

def _attend_qblock(q, k, v, qb: int, bq: int, scale: float):
    """One q-block of every (batch, head): online softmax over kv blocks
    0..qb in ascending order, f32 state, -inf mask on the diagonal block
    only, p rounded to v's dtype before P V.  q: (B, Hkv, g, S, D);
    k, v: (B, Hkv, S, D).  Returns (B, Hkv, g, bq, D) in q's dtype."""
    rows = slice(qb * bq, (qb + 1) * bq)
    qs = q[:, :, :, rows].float()
    shape = qs.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(qs.shape, dtype=torch.float32, device=q.device)
    upper = torch.ones((bq, bq), dtype=torch.bool, device=q.device).triu(1)
    for kv in range(qb + 1):
        cols = slice(kv * bq, (kv + 1) * bq)
        kt = k[:, :, None, cols].float()
        vt = v[:, :, None, cols]
        s = torch.matmul(qs, kt.transpose(-1, -2)) * scale
        if kv == qb:
            s = s.masked_fill(upper, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / l).to(q.dtype)


def folded_causal_attention_plain(q, k, v, *, bq: int, scale: float,
                                  schedule: str = "folded"):
    """The kernel's function in torch, q-block by q-block in the order of
    ``schedule``; both schedules give the same bits.  Shapes as in
    :func:`folded_causal_attention`; bq already resolved (divides S)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.unflatten(1, (Hkv, Hq // Hkv))
    out = torch.empty_like(q)
    og = out.unflatten(1, (Hkv, Hq // Hkv))
    for blocks in schedule_order(S // bq, schedule):
        for qb in blocks:
            og[:, :, :, qb * bq:(qb + 1) * bq] = _attend_qblock(
                qg, k, v, qb, bq, scale)
    return out


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def check_kernel_operands(q, k, v, bq: int) -> None:
    """What the CUDA kernel takes: q (B, Hq, S, D) and k, v (B, Hkv, S, D)
    of one dtype (float32 or bfloat16) on one device, bq in KERNEL_BQ
    up to :func:`max_bq`, D in KERNEL_D, strides that fit 32 bits.  Raise
    on anything else."""
    name = "folded_causal_attention"
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16 q, "
                         f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    B, Hq, S, D = q.shape
    if k.ndim != 4 or tuple(v.shape) != tuple(k.shape) \
            or (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"{name}: k, v must be (B={B}, Hkv, S={S}, D={D}),"
                         f" got {tuple(k.shape)}, {tuple(v.shape)}")
    if bq not in KERNEL_BQ:
        raise ValueError(f"{name}: the kernel takes bq in {KERNEL_BQ}, got "
                         f"{bq}")
    if D not in KERNEL_D:
        raise ValueError(f"{name}: the kernel takes head width D in "
                         f"{KERNEL_D}, got {D}")
    if bq > max_bq(D):
        raise ValueError(f"{name}: the kernel takes bq up to "
                         f"{max_bq(D)} at D={D}, got {bq}")
    for t in (q, k, v):
        if t.numel() >= 2**31 or any(st < 0 or st >= 2**31
                                     for st in t.stride()):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, strides "
                             f"{t.stride()} do not fit the kernel's 32-bit "
                             f"strides")


def folded_causal_attention(q, k, v, *, bq=128, bk=128, scale=None,
                            schedule="folded"):
    """Causal flash attention.  q: (B, Hq, S, D); k, v: (B, Hkv, S, D).

    schedule: "folded" (paper-P3 work distribution) or "naive".  Both
    produce identical values.  The output has q's shape, dtype and
    strides (a transposed view of (B, S, H, D) projections gives an
    output whose transpose is contiguous).
    """
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} % Hkv={Hkv}")
    bq = min(bq, S)
    bk = min(bk, S)
    if bq != bk:
        raise ValueError("fold requires bq == bk")
    if S % bq:
        raise ValueError(f"S={S} % bq={bq}")
    qb_count = S // bq
    if scale is None:
        scale = float(1.0 / D**0.5)
    if schedule == "folded":
        if qb_count % 2:
            raise ValueError(f"folded schedule needs an even number of "
                             f"q-blocks, got {qb_count} (use naive or pad)")
    elif schedule != "naive":
        raise ValueError(schedule)
    if route("folded_causal_attention", q) == "plain":
        return folded_causal_attention_plain(q, k, v, bq=bq, scale=scale,
                                             schedule=schedule)
    check_kernel_operands(q, k, v, bq)
    out = torch.empty_like(q)
    runtime.launch(
        "folded_attention", "folded_attention_launch",
        "folded_causal_attention", q.device, [q, k, v, out],
        [int(q.dtype == torch.bfloat16), B, Hq, Hkv, S, D, bq,
         int(schedule == "folded"), *q.stride(), *k.stride(), *v.stride(),
         *out.stride()], floats=[scale])
    LAUNCHES["folded_causal_attention"] += 1
    return out
