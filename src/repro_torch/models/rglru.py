"""Griffin / RecurrentGemma recurrent block (RG-LRU + temporal conv) -- the
port of ``repro/models/rglru.py`` and of the prefill in
``repro/models/lm.py`` (``_rglru_prefill``).

Block (De et al., arXiv:2402.19427):
    x -> [gelu(W_gate x)] * RGLRU(conv1d_4(W_branch x)) -> W_out

RG-LRU (diagonal gated linear recurrence):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

All recurrence math in float32.  The reference's prefill runs
``jax.lax.associative_scan``; torch has none, so :func:`linear_scan` is a
log-depth doubling scan over the (a, b) pairs in torch ops (its sums are
grouped otherwise than XLA's, equal within rounding).  Training
(:meth:`RGLRU.forward`) runs the prefill's math without its state;
decode carries (h, conv tail) state.

Placed (:func:`repro_torch.models.sharding.place_`, with ``ctx``),
w_gate / w_branch are split by columns and w_out by rows over the model
group, so a rank computes the recurrence of its d / n channels and its
state holds them (``launch/specs.py`` ``state_shardings``).  The gates
read every channel of the branch: its blocks are all-gathered over the
model group, and each rank multiplies them by its columns of w_a / w_x
(the replicated conv, biases and Lambda likewise taken at its channels,
their gradients summed over the model group).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers, sharding

__all__ = ["C_GATE", "CONV_W", "RGLRU", "linear_scan", "state_init"]

C_GATE = 8.0
CONV_W = 4


def _lam(d):
    """Lambda so that a = sigmoid(Lambda)^c lies in ~[0.9, 0.999]: the
    reference's numpy expression (its own seeded generator), so both
    packages hold the same bits."""
    u = np.random.default_rng(0).uniform(0.9, 0.999, d)
    return np.log(np.expm1(-np.log(u ** (1 / C_GATE)))).astype(np.float32)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, in
    ceil(log2 S) doubling steps: after the step of offset o, (a_t, b_t)
    holds the composition of the pairs t-2o+1..t, combined as the
    reference's ``combine`` does ((a1, b1), (a2, b2)) -> (a1 a2,
    a2 b1 + b2).  Returns h (the b of every position)."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


class RGLRU(nn.Module):
    """The recurrent mixer: w_gate, w_branch, w_a, w_x, w_out (d, d) in
    the model's dtype; conv (CONV_W, d) in the model's dtype; b_a, b_x,
    lam (d,) float32 -- the reference's leaves and names."""

    def __init__(self, cfg, dtype, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        for name in ("w_gate", "w_branch"):
            setattr(self, name, layers.weight(generator, d, d, dtype,
                                              device))
        if generator is None:
            conv = torch.empty((CONV_W, d), dtype=dtype, device=device)
        else:
            conv = layers.normal(generator, (CONV_W, d), 0.1, dtype, device)
        self.conv = layers.param(conv)
        self.w_a = layers.weight(generator, d, d, dtype, device)
        self.b_a = layers.param(torch.zeros(d, device=device))
        self.w_x = layers.weight(generator, d, d, dtype, device)
        self.b_x = layers.param(torch.zeros(d, device=device))
        lam = torch.empty(d, device=device)
        if not lam.is_meta:
            lam.copy_(torch.from_numpy(_lam(d)))
        self.lam = layers.param(lam)
        self.w_out = layers.weight(generator, d, d, dtype, device)

    _NAMES = ("w_gate", "w_branch", "conv", "w_a", "b_a", "w_x", "b_x",
              "lam", "w_out")

    def _tp(self, ctx):
        """(ctx, the rank's channels) when placed and split, else None."""
        if ctx is None or not sharding.split_on(self, "w_gate", -1):
            return None
        dl = self.w_gate.shape[-1]
        return ctx, slice(ctx.model_rank * dl, (ctx.model_rank + 1) * dl)

    def _weights(self, w, tp):
        w = dict(w) if w is not None else {n: getattr(self, n)
                                           for n in self._NAMES}
        if tp is not None:   # replicated, taken at the rank's channels
            ctx, sl = tp
            for n in ("conv", "w_a", "w_x"):
                w[n] = sharding.enter_model(w[n], ctx)[:, sl]
            for n in ("b_a", "b_x", "lam"):
                w[n] = sharding.enter_model(w[n], ctx)[sl]
        return w

    def _gates(self, u, w=None, tp=None):
        """Per-step gates (float32) of the (rank's) channels.  u: (..., d
        or d / n) branch activations."""
        w = self._weights(w, None) if w is None else w
        ui = u.float() if tp is None else \
            sharding.all_gather(u, tp[0], -1, partial=True).float()
        with sharding.split_work(tp is not None):
            r = torch.sigmoid(ui @ w["w_a"].float() + w["b_a"])
            i = torch.sigmoid(ui @ w["w_x"].float() + w["b_x"])
        a = torch.exp(-C_GATE * F.softplus(w["lam"]) * r)
        # the rank's channels of the gathered branch, taken here so that
        # the backward adds the three cotangents of ui in the unsplit order
        uf = ui if tp is None else ui[..., tp[1]]
        gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
        return a, gated_in

    def _causal_conv(self, u, conv=None):
        """Width-4 causal depthwise temporal conv.  u: (B, S, d)."""
        w = (self.conv if conv is None else conv).float()
        pad = F.pad(u.float(), (0, 0, CONV_W - 1, 0))
        S = u.shape[1]
        out = sum(pad[:, i:i + S] * w[i] for i in range(CONV_W))
        return out.to(u.dtype)

    def _in(self, x, w, tp):
        """(gate, branch inputs) of the (rank's) channels."""
        xs = x if tp is None else sharding.enter_model(x, tp[0])
        with sharding.split_work(tp is not None):
            gate = F.gelu(xs.float() @ w["w_gate"].float(),
                          approximate="tanh")
            ub = xs @ w["w_branch"]
        return gate, ub

    def _out(self, y, w, tp):
        with sharding.split_work(tp is not None):
            out = y @ w["w_out"]
        return out if tp is None else sharding.all_reduce(out, tp[0],
                                                          "model")

    def _full_sequence(self, x, ctx=None, w=None):
        """The full-sequence block (the reference's ``rglru_apply``):
        (out (B, S, d), h (B, S, d or d / n) float32, branch inputs ub)."""
        tp = self._tp(ctx)
        w = self._weights(w, tp)
        gate, ub = self._in(x, w, tp)
        a, gin = self._gates(self._causal_conv(ub, w["conv"]), w, tp)
        h = linear_scan(a, gin)
        return self._out((gate * h).to(x.dtype), w, tp), h, ub

    def forward(self, x, ctx=None, w=None):
        """Training: full sequence x (B, S, d) -> out (B, S, d).  ``w``:
        the weights whole over the data axes (default the parameters)."""
        return self._full_sequence(x, ctx, w)[0]

    def prefill(self, x, ctx=None, w=None):
        """Full sequence x (B, S, d) -> (out (B, S, d), decode state
        {"h": (B, d) float32, "conv": the last CONV_W - 1 branch inputs},
        placed: of the rank's channels)."""
        out, h, ub = self._full_sequence(x, ctx, w)
        return out, {"h": h[:, -1], "conv": ub[:, -(CONV_W - 1):]}

    def decode_step(self, x1, state, ctx=None, w=None):
        """One token x1 (B, 1, d) -> (out (B, 1, d), new state)."""
        tp = self._tp(ctx)
        w = self._weights(w, tp)
        gate, ub = self._in(x1, w, tp)                          # (B, 1, d)
        hist = torch.cat([state["conv"], ub], dim=1)            # (B, 4, d)
        with sharding.split_work(tp is not None):
            u = torch.einsum("bwd,wd->bd", hist.float(), w["conv"].float())
        a, gin = self._gates(u[:, None, :].to(x1.dtype), w, tp)  # (B, 1, d)
        h = a[:, 0] * state["h"] + gin[:, 0]
        y = (gate[:, 0] * h).to(x1.dtype)[:, None, :]
        return self._out(y, w, tp), {"h": h, "conv": hist[:, 1:]}


def state_init(cfg, batch, dtype, device=None, n_model=1):
    """Zero decode state; a model rank's d / n_model channels when
    n_model divides d (the placed layout)."""
    d = cfg.d_model
    if d % n_model == 0:
        d //= n_model
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, d), dtype=dtype,
                                device=device)}
