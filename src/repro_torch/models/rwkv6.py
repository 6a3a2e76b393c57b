"""RWKV-6 "Finch" time-mix layer (Peng et al., arXiv:2404.05892) -- the port
of ``repro/models/rwkv6.py`` and of the prefill in ``repro/models/lm.py``
(``_rwkv6_prefill``).

The data-dependent per-channel decay w_t = exp(-exp(w0 + tanh(x_w A_w)
B_w)) drives a matrix-valued recurrence per head (head dim D, state S in
R^{D x D}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Token shift is RWKV's ddlerp; per-head GroupNorm and silu(g) gating close
the block.  The prefill is a sequential scan over time on float32
(B, H, D, D) state, as in the reference (a chunked formulation is not in
the reference): :func:`scan` issues one launch a step and forms the
readouts of SCAN_BLOCK steps at once.  Training
(:meth:`RWKV6.forward`) runs the same scan without emitting the state;
decode runs the same step (:func:`mix_step`).  All state math float32.

Placed (:func:`repro_torch.models.sharding.place_`, with ``ctx``), w_r /
w_k / w_v / w_g are split by columns and w_o by rows over the model
group; the token shift and its LoRAs run on every rank.  When the model
axis divides the heads, a rank runs the recurrence of its H / n heads
and its state holds them; otherwise the column blocks cut through heads,
the four projections are all-gathered over the model group and every
rank runs every head.  The decode state's x_prev holds the rank's d / n
channels (``launch/specs.py`` ``state_shardings``), all-gathered at the
next step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers, sharding

__all__ = ["LORA_RKVG", "LORA_W", "STREAMS", "SCAN_BLOCK", "RWKV6",
           "mix_step", "scan", "state_init"]

LORA_RKVG = 32
LORA_W = 64
STREAMS = ("w", "k", "v", "r", "g")


SCAN_BLOCK = 64    # time steps whose states the prefill keeps at once


def _readout(r, S, kv, u):
    """y = r^T (S + diag(u) kv) over any leading axes; r: (..., H, D),
    S and kv: (..., H, D, D)."""
    return torch.einsum("...hk,...hkv->...hv", r, S + u[:, :, None] * kv)


def mix_step(S, r, k, v, w, u):
    """One recurrence step.  S: (B, H, Dk, Dv); r, k, v, w: (B, H, D);
    u: (H, D).  Returns (S_new, y (B, H, D))."""
    kv = k[..., :, None] * v[..., None, :]                  # (B, H, Dk, Dv)
    y = _readout(r, S, kv, u)
    return torch.addcmul(kv, w[..., :, None], S), y


def scan(r, k, v, w, u):
    """The prefill's recurrence over T steps from S = 0.  r, k, v, w:
    (B, T, H, D) float32.  Returns (y (B, T, H, D), the last state).

    Sequential in time, as the reference's ``lax.scan`` (the step is
    :func:`mix_step`'s arithmetic).  The time axis is walked in blocks of
    SCAN_BLOCK steps: a block's k v^T products are formed at once, each
    step is one launch, and the block's readouts are one batched einsum
    over its stacked states, so the host makes one launch a step
    instead of seven.  Every op is differentiable (training runs the
    same scan)."""
    B, T, H, D = r.shape
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    ys = []
    for t0 in range(0, T, SCAN_BLOCK):
        n = min(SCAN_BLOCK, T - t0)
        blk = slice(t0, t0 + n)
        kv = (k[:, blk, :, :, None] * v[:, blk, :, None, :]).transpose(0, 1)
        wb = w[:, blk, :, :, None].transpose(0, 1)
        states = [S]
        for i in range(n):
            states.append(torch.addcmul(kv[i], wb[i], states[i]))
        ys.append(_readout(r[:, blk].transpose(0, 1),
                           torch.stack(states[:n]), kv, u).transpose(0, 1))
        S = states[n]
    return torch.cat(ys, dim=1), S


class RWKV6(nn.Module):
    """The time-mix mixer with the reference's leaves and names: mu_x,
    w0 (d,), u, ln_scale (H, D), mu_<s>, A_<s> (d, r), B_<s> (r, d) in
    float32; w_r, w_k, w_v, w_g, w_o (d, d) in the model's dtype."""

    def __init__(self, cfg, dtype, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        D = cfg.rwkv_head_dim
        H = d // D
        self.H, self.D = H, D
        f32 = torch.float32
        self.mu_x = layers.param(torch.zeros(d, device=device))
        # mild initial decay, the reference's constant
        self.w0 = layers.param(torch.full((d,), -0.5, device=device))
        u = torch.empty((H, D), device=device) if generator is None else \
            layers.normal(generator, (H, D), 0.1, f32, device)
        self.u = layers.param(u)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, layers.weight(generator, d, d, dtype,
                                              device))
        self.ln_scale = layers.param(torch.zeros((H, D), device=device))
        for s in STREAMS:
            r = LORA_W if s == "w" else LORA_RKVG
            setattr(self, f"mu_{s}", layers.param(torch.zeros(
                d, device=device)))
            setattr(self, f"A_{s}", layers.weight(generator, d, r, f32,
                                                  device, 0.01))
            setattr(self, f"B_{s}", layers.weight(generator, r, d, f32,
                                                  device, 0.01))

    def _tp(self, ctx):
        """(ctx, n, r, heads local) when placed and split, else None."""
        if ctx is None or not sharding.split_on(self, "w_r", -1):
            return None
        n = ctx.n_model
        return ctx, n, ctx.model_rank, self.H % n == 0

    def _weights(self, w):
        if w is not None:
            return w
        return {n: p for n, p in self.named_parameters()}

    def _ddlerp(self, x, x_prev, w=None):
        """Data-dependent token shift.  x, x_prev: (..., d) -> the five
        streams' mixed inputs (float32)."""
        w = self._weights(w)
        xf = x.float()
        dx = x_prev.float() - xf
        xxx = xf + w["mu_x"] * dx
        out = {}
        for s in STREAMS:
            lora = torch.tanh(xxx @ w[f"A_{s}"]) @ w[f"B_{s}"]
            out[s] = xf + dx * (w[f"mu_{s}"] + lora)
        return out

    def _streams(self, mixed, dtype, w=None, tp=None):
        """r, k, v (float32), g (float32), w in (0, 1), each (..., H, D),
        and u, ln_scale: of the rank's heads when they are local."""
        w = self._weights(w)
        u, ln = w["u"], w["ln_scale"]
        ms = mixed
        if tp is not None:
            ms = {s: sharding.enter_model(mixed[s], tp[0])
                  for s in ("r", "k", "v", "g")}
        with sharding.split_work(tp is not None):
            r = ms["r"].to(dtype) @ w["w_r"]
            k = ms["k"].to(dtype) @ w["w_k"]
            v = ms["v"].to(dtype) @ w["w_v"]
            g = F.silu(ms["g"] @ w["w_g"].float())
        logw = -torch.exp(w["w0"] + torch.tanh(mixed["w"] @ w["A_w"])
                          @ w["B_w"])
        wd = torch.exp(logw)
        H = self.H
        if tp is not None:
            ctx, n, rank, local = tp
            if local:
                H //= n
                dl = H * self.D
                wd = sharding.enter_model(wd, ctx)[..., rank * dl:
                                                   (rank + 1) * dl]
                u, ln = (sharding.enter_model(t, ctx)[rank * H:
                                                      (rank + 1) * H]
                         for t in (u, ln))
            else:       # column blocks that cut through heads
                r, k, v, g = (sharding.all_gather(t, ctx, -1)
                              for t in (r, k, v, g))
        shp = r.shape[:-1] + (H, self.D)
        return (r.reshape(shp).float(), k.reshape(shp).float(),
                v.reshape(shp).float(), g.reshape(shp),
                wd.reshape(shp), u, ln)

    def _head_norm(self, y, ln_scale=None):
        """Per-head GroupNorm (float32).  y: (..., H, D)."""
        ln_scale = self.ln_scale if ln_scale is None else ln_scale
        mu = torch.mean(y, dim=-1, keepdim=True)
        var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
        return (y - mu) * torch.rsqrt(var + 1e-5) * (1.0 + ln_scale)

    def _out(self, y, w, tp):
        """y (..., heads D) @ w_o: the rank's rows and the partial sums
        all-reduced over the model group when w_o is split."""
        if tp is None:
            return y @ w["w_o"]
        if not tp[3]:
            y = sharding.model_slice(y, tp[0], -1)
        with sharding.split_work():
            out = y @ w["w_o"]
        return sharding.all_reduce(out, tp[0], "model")

    def _full_sequence(self, x, ctx=None, w=None):
        """The full-sequence time mix (the reference's ``rwkv6_apply``):
        (out (B, T, d), the last state (B, H, D, D) float32, of the rank's
        heads when they are local)."""
        B, T, d = x.shape
        w, tp = self._weights(w), self._tp(ctx)
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
        r, k, v, g, wd, u, ln = self._streams(self._ddlerp(x, x_prev, w),
                                              x.dtype, w, tp)
        with sharding.split_work(tp is not None and tp[3]):
            y, S = scan(r, k, v, wd, u)
        y = self._head_norm(y, ln) * g
        return self._out(y.reshape(B, T, -1).to(x.dtype), w, tp), S

    def forward(self, x, ctx=None, w=None):
        """Training: full sequence x (B, T, d) -> out (B, T, d).  ``w``:
        the weights whole over the data axes (default the parameters)."""
        return self._full_sequence(x, ctx, w)[0]

    def _x_prev_out(self, x, tp):
        """The state's x_prev: the rank's d / n channels when placed."""
        if tp is None:
            return x
        dl = x.shape[-1] // tp[1]
        return x[..., tp[2] * dl:(tp[2] + 1) * dl]

    def prefill(self, x, ctx=None, w=None):
        """Full sequence x (B, T, d) -> (out (B, T, d), decode state
        {"S": the last step's (B, H, D, D) float32, "x_prev": x[:, -1]})."""
        out, S = self._full_sequence(x, ctx, w)
        return out, {"S": S,
                     "x_prev": self._x_prev_out(x[:, -1], self._tp(ctx))}

    def decode_step(self, x1, state, ctx=None, w=None):
        """One token x1 (B, 1, d) -> (out (B, 1, d), new state)."""
        B, _, d = x1.shape
        w, tp = self._weights(w), self._tp(ctx)
        x_prev = state["x_prev"] if tp is None else \
            sharding.all_gather(state["x_prev"], tp[0], -1)
        r, k, v, g, wd, u, ln = self._streams(
            self._ddlerp(x1[:, 0], x_prev, w), x1.dtype, w, tp)
        S, y = mix_step(state["S"], r, k, v, wd, u)
        y = self._head_norm(y, ln) * g
        y = self._out(y.reshape(B, 1, -1).to(x1.dtype), w, tp)
        return y, {"S": S, "x_prev": self._x_prev_out(x1[:, 0], tp)}


def state_init(cfg, batch, dtype, device=None, n_model=1):
    """Zero decode state; placed over ``n_model`` model ranks, the rank's
    heads of S when n_model divides them and its channels of x_prev when
    n_model divides d."""
    d = cfg.d_model
    D = cfg.rwkv_head_dim
    H = d // D
    if H % n_model == 0:
        H //= n_model
    if d % n_model == 0:
        d //= n_model
    return {"S": torch.zeros((batch, H, D, D), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, d), dtype=dtype, device=device)}
