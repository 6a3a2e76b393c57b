"""Mixture-of-Experts FFN (GShard/Switch-style top-k routing with capacity)
-- the single-device path of ``repro/models/moe.py`` (``_route``,
``_dispatch_indices``, ``_dispatch_combine``, ``_moe_local``).

Capacity C = max(ceil(T * top_k / E * capacity_factor), 1), computed in
Python floats as the reference does; an entry's position in its expert is
the exclusive cumsum over the flattened (token, slot) order, and entries
at positions >= C are dropped (masked: torch has no scatter that drops
out-of-range indices).  Router math is float32; the Switch load-balance
aux loss is returned alongside.

Not ported (ROADMAP.md queue 1 item 11c): the sharded expert-parallel /
sequence-parallel path (the reference's ``_moe_sharded`` under
``shard_map``); :meth:`MoE.forward` with ``ctx`` raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers

__all__ = ["MoE", "moe_apply", "route", "dispatch_indices",
           "dispatch_combine", "capacity", "expert_ffn"]


def capacity(T: int, m) -> int:
    """Slots per expert for T tokens, the reference's expression."""
    return max(int(np.ceil(T * m.top_k / m.num_experts * m.capacity_factor)),
               1)


def route(router, xt, m):
    """xt: (T, d) -> (gate_vals (T, k), expert_ids (T, k), probs (T, E)).
    The top k by a stable descending sort: of equal probabilities the
    lower expert id comes first, as ``jax.lax.top_k`` orders them."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[:, :m.top_k]
    expert_ids = expert_ids[:, :m.top_k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return gate_vals, expert_ids, probs


def dispatch_indices(expert_ids, E: int, C: int):
    """Position in its expert of every (token, slot) entry: the exclusive
    cumsum of the one-hot ids over the flattened (token, slot) order.
    Returns (eid, cid, keep), each (T k,)."""
    flat = expert_ids.reshape(-1)
    onehot = F.one_hot(flat, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    return flat, pos, pos < C


def expert_ffn(wi, wo, xe, kind):
    """Batched expert MLP.  xe: (E, C, d); wi (E, d, f or 2 f); wo (E, f,
    d)."""
    h = torch.bmm(xe, wi)
    if kind in layers.GATED:
        g, u = torch.chunk(h, 2, dim=-1)
        h = layers.GATED[kind](g.float()).to(xe.dtype) * u
    else:
        h = layers.PLAIN[kind](h.float()).to(xe.dtype)
    return torch.bmm(h, wo)


def dispatch_combine(router, wi, wo, xt, m, kind):
    """Dispatch -> expert FFN -> combine on tokens xt (T, d).  Returns
    (out (T, d), aux loss)."""
    T, d = xt.shape
    E, k = m.num_experts, m.top_k
    C = capacity(T, m)
    gate_vals, expert_ids, probs = route(router, xt, m)
    eid, cid, keep = dispatch_indices(expert_ids, E, C)

    src = xt.repeat_interleave(k, dim=0)
    buf = torch.zeros((E, C, d), dtype=xt.dtype, device=xt.device)
    buf[eid[keep], cid[keep]] = src[keep]
    out_e = expert_ffn(wi, wo, buf, kind)

    tok_out = out_e[eid, torch.clamp(cid, max=C - 1)]
    tok_out = torch.where(keep[:, None], tok_out, 0.0)
    w = (gate_vals.reshape(T * k) * keep).float()
    out = torch.sum((tok_out.float() * w[:, None]).reshape(T, k, d),
                    dim=1).to(xt.dtype)

    # Switch aux loss terms (summed, normalized by the caller)
    f_e = torch.mean(F.one_hot(expert_ids[:, 0], E).float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = E * torch.sum(f_e * p_e) * m.router_aux_weight
    return out, aux


class MoE(nn.Module):
    """router (d, E) float32; wi (E, d, 2 ff for a gated MLP, else ff) and
    wo (E, ff, d) in the model's dtype; ``shared``, an MLP of
    ff * num_shared_experts, when the config has shared experts."""

    def __init__(self, cfg, dtype, generator=None, device=None):
        super().__init__()
        m = cfg.moe
        self.cfg = cfg
        d, ff, E = cfg.d_model, cfg.d_ff, m.num_experts
        wi_out = 2 * ff if cfg.mlp_type in layers.GATED else ff
        self.router = layers.weight(generator, d, E, torch.float32, device)
        self.wi = layers.param(self._experts(generator, (E, d, wi_out),
                                             1 / math.sqrt(d), dtype,
                                             device))
        self.wo = layers.param(self._experts(generator, (E, ff, d),
                                             1 / math.sqrt(ff), dtype,
                                             device))
        if m.num_shared_experts:
            self.shared = layers.MLP(d, ff * m.num_shared_experts,
                                     cfg.mlp_type, dtype, generator, device)

    @staticmethod
    def _experts(generator, shape, scale, dtype, device):
        if generator is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return layers.normal(generator, shape, scale, dtype, device)

    def forward(self, x, ctx=None):
        """x (B, S, d) -> (out (B, S, d), aux loss)."""
        if ctx is not None:
            raise NotImplementedError(
                "the sharded MoE path (expert and sequence parallel, the "
                "reference's _moe_sharded) is not ported yet (ROADMAP.md "
                "queue 1 item 11c)")
        cfg = self.cfg
        B, S, d = x.shape
        out, aux = dispatch_combine(self.router, self.wi, self.wo,
                                    x.reshape(B * S, d), cfg.moe,
                                    cfg.mlp_type)
        out = out.reshape(B, S, d)
        if cfg.moe.num_shared_experts:
            out = out + self.shared(x)
        return out, aux


def moe_apply(module: MoE, x, ctx=None):
    """x: (B, S, d) -> (out, aux loss): the reference's entry point.  The
    sharded path (``ctx`` given) raises (ROADMAP.md queue 1 item 11c)."""
    return module(x, ctx)
