"""GPipe-style pipeline parallelism over the ranks of a process group --
the port of ``repro/train/pipeline.py``.

The layer stack is split into S contiguous segments, one per rank.
Microbatches stream through the stages in the classic GPipe schedule: at
tick t, stage s processes microbatch t - s; activations move stage ->
stage with one send / receive pair per tick (the reference's one
``ppermute`` a tick, here ``torch.distributed`` point-to-point on a ring:
rank s sends to s + 1 mod S, receives from s - 1 mod S, and stage 0
ignores what it receives).  Bubble fraction = (S-1)/(T+S-1) for S stages
and T microbatches -- pick T >= 4*S in practice.

Every rank runs the same loop, as the reference's SPMD body: a rank
applies ITS stage's parameters to its current slot every tick (an idle
rank computes on zeros or stale data and the result is discarded); the
last stage collects the finished microbatches, and one broadcast from
it hands every rank the (T, mb, ...) result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["pipeline_apply", "bubble_fraction", "split_stages"]


def _index(tree, i):
    """Leaf [i] of every tensor of a tensor / dict / list tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def pipeline_apply(stage_fn, params_stacked, x_mb, group=None):
    """Run a GPipe pipeline over the ranks of ``group``.

    stage_fn(stage_params, x) -> x : one stage's computation (the layers
        of one segment), applied by every rank to its own stage params.
    params_stacked: tensor tree with leading axis n_stage (segment-major,
        :func:`split_stages`); rank s applies entry s.
    x_mb: (T, mb, ...) microbatched inputs, the same on every rank.
    Returns (T, mb, ...) outputs on every rank, equal to applying all
    stages in order."""
    S = dist.get_world_size(group)
    rank = dist.get_rank(group)
    T = x_mb.shape[0]
    sp = _index(params_stacked, rank)
    nxt, prv = _global(group, (rank + 1) % S), _global(group, (rank - 1) % S)
    buf = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(T + S - 1):
        if rank == 0:
            cur = x_mb[t] if t < T else torch.zeros_like(buf)
        else:
            cur = buf
        y = stage_fn(sp, cur)
        if rank == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y
        if S > 1:
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            buf = recv
        else:
            buf = y
    dist.broadcast(outs, src=_global(group, S - 1), group=group)
    return outs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1) / (T+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def split_stages(params_stacked, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) segment-major, over a
    tensor or a dict / list tree of tensors."""
    if isinstance(params_stacked, dict):
        return {k: split_stages(v, n_stages)
                for k, v in params_stacked.items()}
    if isinstance(params_stacked, (list, tuple)):
        return type(params_stacked)(split_stages(v, n_stages)
                                    for v in params_stacked)
    L = params_stacked.shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    return params_stacked.reshape(n_stages, L // n_stages,
                                  *params_stacked.shape[1:])
