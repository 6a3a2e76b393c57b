"""Mixture-of-Experts FFN (GShard/Switch-style top-k routing with capacity)
-- the port of ``repro/models/moe.py``: the single-device path
(``_route``, ``_dispatch_indices``, ``_dispatch_combine``,
``_moe_local``) and the expert- and sequence-parallel path
(``_moe_sharded``).

Capacity C = max(ceil(T * top_k / E * capacity_factor), 1), computed in
Python floats as the reference does; an entry's position in its expert is
the exclusive cumsum over the flattened (token, slot) order, and entries
at positions >= C are dropped (written to a spare row past the (E, C)
buffer: torch has no scatter that drops out-of-range indices, and a
boolean mask has no meta-tensor shape).  Router math is float32; the
Switch load-balance aux loss is returned alongside.

The sharded path (``ctx`` given; the model rank holds E / n_model
experts, placed by :func:`repro_torch.models.sharding.place_`) runs per rank what the reference's
``shard_map`` body runs:

  1. sequence parallelism when S % n_model == 0 and S >= n_model > 1: the
     model rank takes its S / n_model slice of the (data-sharded) tokens;
  2. local routing and dispatch into (E, C_loc, d), C_loc the capacity of
     the rank's own tokens;
  3. an all-to-all over the model group: the (E, C, d) buffer's dim 0 is
     already chunked by destination rank, and the received (n, E/n, C, d)
     is permuted to (E/n, n C, d), source-rank order on the capacity
     axis -- the reference's tiled ``all_to_all(split_axis=0,
     concat_axis=1)``;
  4. the FFN of the rank's E / n experts;
  5. the reverse permutation and all-to-all, the local combine, the shared
     experts on the slice;
  6. the slices all-gathered over the model group;
  7. aux averaged over every rank (the reference's ``pmean`` over the data
     and model axes).

Gradients: the input enters through :func:`sharding.enter_model` (its
cotangent is summed over the model group); without sequence parallelism
every model rank routes every token, so the output's cotangent is
divided by n_model (:func:`sharding.scale_grad`), as the reference's
``shard_map`` transpose divides the cotangent of an output replicated
over an axis.  The router's and the shared experts' gradients are then
partial sums over the model ranks, which the trainer adds up
(:func:`repro_torch.train.trainer.reduce_grads`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers, sharding

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


def dispatch_combine(router, wi, wo, xt, m, kind, cross_expert_fn=None):
    """Dispatch -> expert FFN -> combine on tokens xt (T, d).  Returns
    (out (T, d), aux loss).  ``cross_expert_fn`` replaces the FFN on the
    (E, C, d) buffer (the sharded path's all-to-all sandwich)."""
    T, d = xt.shape
    E, k = m.num_experts, m.top_k
    C = capacity(T, m)
    gate_vals, expert_ids, probs = route(router, xt, m)
    eid, cid, keep = dispatch_indices(expert_ids, E, C)

    # a dropped entry lands on the spare row E C, past the buffer
    src = xt.repeat_interleave(k, dim=0)
    rows = torch.where(keep, eid * C + cid, E * C)
    flat = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    flat = flat.index_put((rows,), src)
    buf = flat[:E * C].view(E, C, d)
    if cross_expert_fn is None:
        out_e = expert_ffn(wi, wo, buf, kind)
    else:
        out_e = cross_expert_fn(buf)

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

    def forward(self, x, ctx=None, w=None):
        """x (B, S, d) -> (out (B, S, d), aux loss).  With ``ctx`` the
        sharded path: x is this rank's rows, the output too.  ``w``: the
        weights whole over the data axes (default the parameters)."""
        w = dict(self.named_parameters()) if w is None else w
        if ctx is not None:
            return self._sharded(x, ctx, w)
        cfg = self.cfg
        B, S, d = x.shape
        out, aux = dispatch_combine(w["router"], w["wi"], w["wo"],
                                    x.reshape(B * S, d), cfg.moe,
                                    cfg.mlp_type)
        out = out.reshape(B, S, d)
        if cfg.moe.num_shared_experts:
            out = out + self.shared(x, None, sharding.sub_weights(w, "shared"))
        return out, aux

    def _sharded(self, x, ctx, w):
        cfg, m = self.cfg, self.cfg.moe
        nm = ctx.n_model
        if m.num_experts % nm:
            raise ValueError(f"experts {m.num_experts} % model axis {nm}")
        el = m.num_experts // nm
        if w["wi"].shape[0] != el:
            raise ValueError(
                f"a model rank of {nm} holds {el} experts, this module "
                f"{self.wi.shape[0]}: place the model first "
                f"(sharding.place_)")
        B, S, d = x.shape
        use_sp = S % nm == 0 and S >= nm and nm > 1
        x = sharding.enter_model(x, ctx)
        if use_sp:
            sl = S // nm
            xs = x[:, ctx.model_rank * sl:(ctx.model_rank + 1) * sl]
        else:
            xs = x
        bl, sl, _ = xs.shape
        wi, wo = w["wi"], w["wo"]

        def cross_expert(buf):
            # (E, C, d) -> the rank's experts with every rank's tokens
            _, C, _ = buf.shape
            recv = sharding.all_to_all(buf, ctx)
            xe = recv.view(nm, el, C, d).transpose(0, 1) \
                .reshape(el, nm * C, d)
            out_e = expert_ffn(wi, wo, xe, cfg.mlp_type)
            send = out_e.view(el, nm, C, d).transpose(0, 1) \
                .reshape(nm * el, C, d)
            return sharding.all_to_all(send, ctx)

        out, aux = dispatch_combine(w["router"], wi, wo,
                                    xs.reshape(bl * sl, d), m, cfg.mlp_type,
                                    cross_expert_fn=cross_expert)
        out = out.reshape(bl, sl, d)
        if m.num_shared_experts:
            out = out + self.shared(xs, ctx, sharding.sub_weights(w, "shared"))
        if use_sp:
            out = sharding.all_gather(out, ctx, dim=1)
        elif nm > 1:
            out = sharding.scale_grad(out, 1.0 / nm)
        aux = sharding.all_reduce(aux, ctx, "world") / ctx.size
        return out, aux


def moe_apply(module: MoE, x, ctx=None):
    """x: (B, S, d) -> (out, aux loss): the reference's entry point;
    the sharded path when ``ctx`` is given."""
    return module(x, ctx)
