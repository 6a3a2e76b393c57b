"""Gradient compression with error feedback (1-bit-Adam / EF-SGD family) --
the port of ``repro/train/compress.py``.

  * :func:`ef_quantize` / :func:`ef_dequantize` -- blockwise symmetric int8
    quantization with an error-feedback residual: the quantization error of
    step t is added back to the gradient of step t+1, so the compression
    bias vanishes over time (Karimireddy et al. 2019).
  * :func:`compressed_allreduce` -- the collective on ``torch.distributed``:
    reduce-scatter in float32 (the summation must happen at full
    precision), then all-gather the int8-quantized shard sums and
    per-shard scales.  Wire bytes: (1/n + (n-1)/(4n)) * size*4 vs 2*size*4
    for ring all-reduce.
  * :func:`ef_roundtrip` / :func:`compress_grads` -- the single-device
    wire-format simulation behind the trainer's ``grad_compression="int8"``:
    every gradient leaf goes through quantize -> dequantize with error
    feedback.  A leaf is the reference's, so a pattern slot's G layers are
    one stacked leaf whose 2048-element blocks run across layer
    boundaries, as in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["BLOCK", "ef_quantize", "ef_dequantize", "ef_roundtrip",
           "init_error_state", "compress_grads", "compressed_allreduce"]

BLOCK = 2048


def _blockify(x):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK), pad


def ef_quantize(g, err):
    """g: float array; err: same-shape error-feedback residual.
    Returns (q int8 blocks (nb, BLOCK), scales float32 (nb,), new_err)."""
    g32 = g.to(torch.float32) + err
    blocks, _ = _blockify(g32)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).reshape(-1)[:g.numel()]
    return q, scale[:, 0], g32 - deq.reshape(g.shape)


def ef_dequantize(q, scale, shape):
    n = 1
    for s in shape:
        n *= s
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n] \
        .reshape(shape)


def ef_roundtrip(g, err):
    """Quantize + dequantize with error feedback (wire-format simulation)."""
    q, scale, new_err = ef_quantize(g, err)
    return ef_dequantize(q, scale, g.shape), new_err


def init_error_state(tree: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in tree.items()}


def compress_grads(grads: dict, err_state: dict):
    """Trainer hook: EF-int8 roundtrip on every gradient leaf."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        new_g[k], new_e[k] = ef_roundtrip(g, err_state[k])
    return new_g, new_e


def compressed_allreduce(x, err, group=None):
    """All-reduce over ``group``: float32 reduce-scatter + int8 all-gather.

    x: identically-shaped float32 tensor on every rank (leading dim
    divisible by the group size n); err: this rank's error-feedback
    residual for its OWN scatter shard (x.shape with leading dim / n).
    Returns (the compressed sum on every rank, new_err)."""
    n = dist.get_world_size(group)
    shard = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                        dtype=torch.float32, device=x.device)
    dist.reduce_scatter_tensor(shard, x.to(torch.float32).contiguous(),
                               group=group)
    q, scale, new_err = ef_quantize(shard, err)
    nb = q.shape[0]                                     # blocks a shard
    qg = torch.empty((n * nb, BLOCK), dtype=torch.int8, device=x.device)
    sg = torch.empty((n * nb,), dtype=torch.float32, device=x.device)
    dist.all_gather_into_tensor(qg, q.contiguous(), group=group)
    dist.all_gather_into_tensor(sg, scale.contiguous(), group=group)
    deq = qg.to(torch.float32) * sg[:, None]            # per-shard blocks
    deq = deq.reshape(n, -1)[:, :shard.numel()]         # strip shard pads
    return deq.reshape(x.shape), new_err
