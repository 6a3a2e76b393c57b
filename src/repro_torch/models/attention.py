"""Attention mixers: GQA/MQA/MHA with RoPE or M-RoPE, the sliding-window
variant and logit soft-capping, prefill over the whole prompt and
single-token KV-cache decode -- the port of ``repro/models/attention.py``.

Which prefill runs.  The Pallas kernel ``folded_causal_attention``
computes plain causal attention: no window, no soft cap.  A layer whose
function is that (an ``attn`` layer of a config with ``logit_softcap ==
0``) calls :func:`repro_torch.kernels.ops.attention` -- the CUDA kernel
on the card, its plain version on the CPU -- on transposed views of the
(B, S, H, D) projections, with S padded at the tail to a multiple of
2 bq; the padding is exact under the causal mask.  A ``local_attn``
layer, or any layer with a soft cap, runs :func:`chunked_causal`, the
port of the reference's q-chunked ``_chunked_causal``: no Pallas kernel
computes that function.  The choice follows the layer's kind and config.

Training (:meth:`Attention.forward`, the reference's ``attn_apply``)
runs :func:`chunked_causal` for every layer, as the reference trains
through its jnp ``_chunked_causal``: the Pallas kernel has no gradient,
and neither has the CUDA one.

Decode is a single-token einsum, outside any kernel, as in the
reference.  A ``local_attn`` layer keeps a ring buffer of
L = min(window, max_len) slots (position p at slot p % L); decode writes
its slot in place.

Placed (:func:`repro_torch.models.sharding.place_`, with ``ctx``), wq /
wk / wv are split by columns and wo by rows over the model group
(Megatron).  When the model axis divides the KV heads, each rank
computes its H / n query and Hkv / n KV heads -- the kernel runs on them
-- and its cache holds them.  Otherwise the rules' column blocks cut
through heads: the projections are all-gathered over the model group,
every rank computes every head, takes its rows of wo, and its cache
holds its L / n slots (``launch/specs.py`` ``state_shardings``); decode
then combines the slots' softmax terms over the model group.  Either
way wo's partial sums are all-reduced over the model group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import folded_attention, ops

from . import layers, sharding

__all__ = ["NEG_INF", "ATTN_BQ", "Attention", "attention_block",
           "prefill_attention", "chunked_causal", "cache_init",
           "cache_split"]

NEG_INF = -1e30   # finite mask value, as in the reference
ATTN_BQ = 128     # the kernel's q-block at long prompts


def attention_block(S: int, cap: int = ATTN_BQ) -> int:
    """The kernel's q-block for a prompt of S tokens: the smallest power
    of two from 16 to ``cap`` (the kernel's largest at the head width,
    :func:`repro_torch.kernels.folded_attention.max_bq`) that covers half
    of S, so the padding to 2 bq stays under one block."""
    bq = 16
    while bq < cap and 2 * bq < S:
        bq *= 2
    return bq


def prefill_attention(q, k, v, attn_fn=None):
    """Causal attention over a whole prompt.  q: (B, S, H, D); k, v:
    (B, S, Hkv, D).  Returns (B, S, H, D) in q's dtype.

    S is padded at the tail to a multiple of 2 bq (an even number of
    q-blocks, as the folded schedule needs); the padded rows are sliced
    off.  ``attn_fn`` defaults to :func:`repro_torch.kernels.ops.attention`
    (chip_smoke.py passes the plain version to compare)."""
    attn_fn = ops.attention if attn_fn is None else attn_fn
    S = q.shape[1]
    bq = attention_block(S, folded_attention.max_bq(q.shape[-1]))
    Sp = -(-S // (2 * bq)) * (2 * bq)
    if Sp != S:
        pad = (0, 0, 0, 0, 0, Sp - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    out = attn_fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  bq=bq, bk=bq)
    return out.transpose(1, 2)[:, :S]


def chunked_causal(q, k, v, *, chunk, window, softcap_val, scale):
    """The reference's q-chunked masked attention, for the layers no
    kernel computes (a sliding window, a soft cap).  q: (B, S, H, D);
    k, v: (B, S, Hkv, D).  Scores per chunk (B, Hkv, g, chunk, S) in
    float32, soft-capped, masked with NEG_INF (causal, and within
    ``window`` keys when it is > 0), softmax, P V in float32, cast to q's
    dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    Sp = nc * chunk
    if Sp != S:
        q = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    qg = q.reshape(B, nc, chunk, Hkv, g, D)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(S, device=q.device)
    out = torch.empty((B, Sp, H, D), dtype=q.dtype, device=q.device)
    for ci in range(nc):
        q_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, ci].float(), kf) * scale
        s = layers.softcap(s, softcap_val)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).to(q.dtype)
        out[:, ci * chunk:(ci + 1) * chunk] = o.reshape(B, chunk, H, D)
    return out[:, :S]


def cache_split(cfg, n_model: int) -> str | None:
    """How a placed layer's KV cache splits over ``n_model`` model ranks
    (the reference's ``state_shardings``): "heads" when n_model divides
    the KV heads, else "slots"; None at one rank."""
    if n_model == 1:
        return None
    return "heads" if cfg.num_kv_heads % n_model == 0 else "slots"


def cache_init(cfg, batch, max_len, dtype, device=None, window=0,
               n_model=1, split=None):
    """KV cache of one attention layer: k, v (batch, L, Hkv, D) with
    L = max_len, or the ring of L = min(window, max_len) slots of a
    ``local_attn`` layer; a model rank's Hkv / n_model heads or L /
    n_model slots of it with ``split`` (:func:`cache_split`)."""
    L = min(window, max_len) if window else max_len
    Hkv = cfg.num_kv_heads
    if split == "heads":
        Hkv //= n_model
    elif split == "slots":
        if L % n_model:
            raise ValueError(f"a cache of {L} slots does not split over "
                             f"{n_model} model ranks: choose max_len (or "
                             f"the window) a multiple of {n_model}")
        L //= n_model
    shape = (batch, L, Hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class _TP:
    """A placed layer's model split: ``local`` when each rank computes
    its own heads; ``q`` / ``kv`` when wq / wk, wv are split by columns;
    ``row`` when wo is split by rows."""

    def __init__(self, module, ctx):
        self.ctx, self.n, self.r = ctx, ctx.n_model, ctx.model_rank
        self.q = sharding.split_on(module, "wq", -1)
        self.kv = sharding.split_on(module, "wk", -1)
        self.row = sharding.split_on(module, "wo", 0)
        self.local = self.q and self.kv and \
            module.cfg.num_kv_heads % self.n == 0
        if self.local and not self.row:
            raise ValueError("wq split into whole heads but wo not by rows")
        self.split = cache_split(module.cfg, self.n)


class Attention(nn.Module):
    """wq (d, q_dim), wk / wv (d, kv_dim), wo (q_dim, d): x @ w, the
    reference's orientation.  ``window`` > 0 makes a ``local_attn``
    layer.  Every method takes ``ctx`` and ``w`` (the layer's weights
    whole over the data axes, :func:`repro_torch.models.sharding
    .gather_params`; default its own parameters)."""

    def __init__(self, cfg, dtype, generator=None, device=None, *,
                 window=0):
        super().__init__()
        if cfg.pos_type not in ("rope", "mrope", "none"):
            raise ValueError(cfg.pos_type)
        self.cfg = cfg
        self.window = window
        # plain causal attention: what the folded attention kernel computes
        self.uses_kernel = not window and not cfg.logit_softcap
        d = cfg.d_model
        for name, shape in (("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
                            ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d))):
            setattr(self, name, layers.weight(generator, *shape, dtype,
                                              device))

    def _tp(self, ctx):
        """None unless the layer runs with ``ctx`` and a weight of it is
        split over the model group."""
        if ctx is None or not hasattr(self, "_placement"):
            return None
        tp = _TP(self, ctx)
        return tp if tp.q or tp.kv or tp.row else None

    def _weights(self, w):
        return w if w is not None else {n: getattr(self, n) for n in
                                        ("wq", "wk", "wv", "wo")}

    def _project(self, x, positions, w, tp):
        """q (B, S, H, D), k and v (B, S, Hkv, D) -- the rank's heads when
        ``tp.local`` -- RoPE (positions (B, S), or the first stream of
        (3, B, S)) or M-RoPE (positions (3, B, S)) on q and k."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if tp is None:
            q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
        else:
            ctx = tp.ctx
            xs = sharding.enter_model(x, ctx) if tp.q or tp.kv else x
            with sharding.split_work(tp.q):
                q = (xs if tp.q else x) @ w["wq"]
            with sharding.split_work(tp.kv):
                k = (xs if tp.kv else x) @ w["wk"]
                v = (xs if tp.kv else x) @ w["wv"]
            if tp.local:
                H, Hkv = H // tp.n, Hkv // tp.n
            else:
                # columns that cut through heads: every rank takes all
                if tp.q:
                    q = sharding.all_gather(q, ctx, -1)
                if tp.kv:
                    k = sharding.all_gather(k, ctx, -1)
                    v = sharding.all_gather(v, ctx, -1)
        q = q.view(B, S, H, D)
        k = k.view(B, S, Hkv, D)
        v = v.view(B, S, Hkv, D)
        if cfg.pos_type == "rope":
            pos = positions if positions.ndim == 2 else positions[0]
            q = layers.rope(q, pos, cfg.rope_theta)
            k = layers.rope(k, pos, cfg.rope_theta)
        elif cfg.pos_type == "mrope":
            q = layers.mrope(q, positions, cfg.mrope_sections,
                             cfg.rope_theta)
            k = layers.mrope(k, positions, cfg.mrope_sections,
                             cfg.rope_theta)
        return q, k, v

    def _out(self, out, w, tp):
        """(B, S, heads D) @ wo: the rank's rows and the partial sums
        all-reduced over the model group when wo is split."""
        if tp is None or not tp.row:
            return out @ w["wo"]
        if not tp.local:
            out = sharding.model_slice(out, tp.ctx, -1)
        with sharding.split_work():
            y = out @ w["wo"]
        return sharding.all_reduce(y, tp.ctx, "model")

    def _chunked(self, q, k, v):
        cfg = self.cfg
        return chunked_causal(q, k, v, chunk=cfg.attn_chunk,
                              window=self.window,
                              softcap_val=cfg.logit_softcap,
                              scale=1.0 / math.sqrt(cfg.head_dim))

    def forward(self, x, positions, ctx=None, w=None):
        """Training attention over a whole sequence (the reference's
        ``attn_apply``): projections, :func:`chunked_causal` for every
        layer, ``wo``.  x: (B, S, d) -> (B, S, d)."""
        w, tp = self._weights(w), self._tp(ctx)
        B, S, _ = x.shape
        q, k, v = self._project(x, positions, w, tp)
        with sharding.split_work(tp is not None and tp.local):
            out = self._chunked(q, k, v)
        return self._out(out.reshape(B, S, -1), w, tp)

    def prefill(self, x, positions, max_len, cache_dtype, attn_fn=None,
                ctx=None, w=None):
        """The whole prompt: (out (B, S, d), its KV cache).  The cache
        holds the prompt's k, v at slots 0..S-1, or its last L of them
        when S >= L, in ring order (position p at slot p % L) for a
        ``local_attn`` layer; placed, the rank's heads or slots of it.
        ``attn_fn`` replaces the kernel call of a plain causal layer
        (:func:`prefill_attention`); the other layers run
        :func:`chunked_causal`."""
        w, tp = self._weights(w), self._tp(ctx)
        B, S, _ = x.shape
        q, k, v = self._project(x, positions, w, tp)
        split = None if tp is None else tp.split
        n = 1 if split is None else tp.n
        if split == "slots":     # fails early when n does not divide L
            cache_init(self.cfg, B, max_len, cache_dtype, "meta",
                       self.window, n, split)
        cache = cache_init(self.cfg, B, max_len, cache_dtype, x.device,
                           self.window, n, "heads" if split == "heads"
                           else None)
        L = cache["k"].shape[1]
        if S >= L:
            ck, cv = k[:, S - L:], v[:, S - L:]
            if self.window:
                ck = torch.roll(ck, S % L, dims=1)
                cv = torch.roll(cv, S % L, dims=1)
            cache["k"].copy_(ck)
            cache["v"].copy_(cv)
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        if split == "slots":     # the rank's L / n slots of the whole
            lc = L // n
            cache = {key: c[:, tp.r * lc:(tp.r + 1) * lc].clone()
                     for key, c in cache.items()}
        with sharding.split_work(tp is not None and tp.local):
            if self.uses_kernel:
                out = prefill_attention(q, k, v, attn_fn)
            else:
                out = self._chunked(q, k, v)
        return self._out(out.reshape(B, S, -1), w, tp), cache

    def _attend(self, q, cache, valid, slots_tp):
        """One query position against the cache's valid slots, float32:
        (B, 1, H, g, D).  With ``slots_tp`` the cache holds this rank's
        slots of every head; the softmax's max and sums are combined over
        the model group."""
        cfg = self.cfg
        B, _, _, D = q.shape
        Hkv = cache["k"].shape[2]
        qh = q.view(B, 1, Hkv, q.shape[2] // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                         cache["k"].float()) / math.sqrt(D)
        s = layers.softcap(s, cfg.logit_softcap)
        s = torch.where(valid, s, NEG_INF)
        if slots_tp is None:
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bhgqk,bkhd->bqhgd", p, cache["v"].float())
        ctx = slots_tp.ctx
        m = sharding.all_reduce(torch.amax(s, -1, keepdim=True), ctx,
                                "model", "max")
        p = torch.exp(s - m)
        den = sharding.all_reduce(torch.sum(p, -1, keepdim=True), ctx,
                                  "model")
        out = sharding.all_reduce(torch.einsum(
            "bhgqk,bkhd->bqhgd", p, cache["v"].float()), ctx, "model")
        return out / den.permute(0, 3, 1, 2, 4)

    def decode_step(self, x1, cache, pos: int, ctx=None, w=None):
        """One token at position ``pos``.  x1: (B, 1, d).  Writes its k, v
        into ``cache`` in place, at slot pos % L of a ``local_attn``
        layer's ring (the reference returns a new cache; the port saves
        the copy of every layer's cache per token), and returns
        (out (B, 1, d), cache).  A slot-split cache is written by the
        rank that holds the slot, and the softmax over the ranks' slots
        is combined over the model group (max, sums)."""
        cfg = self.cfg
        w, tp = self._weights(w), self._tp(ctx)
        B = x1.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x1.device)
        if cfg.pos_type == "mrope":
            positions = positions[None].expand(3, B, 1)
        q, k1, v1 = self._project(x1, positions, w, tp)
        slots = tp is not None and tp.split == "slots"
        lc = cache["k"].shape[1]
        lo, L = (tp.r * lc, lc * tp.n) if slots else (0, lc)
        slot = pos % L if self.window else min(pos, L - 1)
        if lo <= slot < lo + lc:
            cache["k"][:, slot - lo] = k1[:, 0]
            cache["v"][:, slot - lo] = v1[:, 0]
        idx = lo + torch.arange(lc, device=x1.device)
        if self.window:
            # slot i holds position pos - ((slot - i) mod L): valid iff
            # that is >= 0 (the ring's warmup and its wrap alike)
            valid = torch.remainder(slot - idx, L) <= pos
        else:
            valid = idx <= pos
        # the rank's heads, or its slots of every head: split work
        with sharding.split_work(tp is not None and (tp.local or slots)):
            out = self._attend(q, cache, valid, tp if slots else None)
        out = out.to(x1.dtype).reshape(B, 1, -1)
        return self._out(out, w, tp), cache
