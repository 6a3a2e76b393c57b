"""Attention mixer: GQA/MQA/MHA with RoPE, prefill through the
folded causal attention kernel, and single-token KV-cache decode -- the
port of ``repro/models/attention.py``.

The reference's prefill runs a q-chunked jnp loop (``_chunked_causal``);
the Pallas kernel ``folded_causal_attention`` computes the same function
(its oracle equals that module's output).  Here the prefill calls
:func:`repro_torch.kernels.ops.attention` -- the CUDA kernel on the card,
its plain version on the CPU -- on transposed views of the (B, S, H, D)
projections, with S padded at the tail to a multiple of 2 bq.  The
padding is exact under the causal mask: no real row sees a padded key.
Decode is a single-token einsum, outside any kernel, as in the
reference.

Not ported (ROADMAP.md queue 1 item 11): sliding-window (``local_attn``)
layers, logit soft-capping inside attention and M-RoPE positions; a layer
with any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from . import layers

__all__ = ["NEG_INF", "ATTN_BQ", "Attention", "attention_block",
           "prefill_attention", "cache_init"]

NEG_INF = -1e30   # decode's finite mask value, as in the reference
ATTN_BQ = 128     # the kernel's q-block at long prompts


def attention_block(S: int) -> int:
    """The kernel's q-block for a prompt of S tokens: the smallest power
    of two from 16 to ATTN_BQ that covers half of S, so the padding to
    2 bq stays under one block."""
    bq = 16
    while bq < ATTN_BQ and 2 * bq < S:
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
    bq = attention_block(S)
    Sp = -(-S // (2 * bq)) * (2 * bq)
    if Sp != S:
        pad = (0, 0, 0, 0, 0, Sp - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    out = attn_fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  bq=bq, bk=bq)
    return out.transpose(1, 2)[:, :S]


def cache_init(cfg, batch, max_len, dtype, device=None):
    """KV cache of one attention layer: k, v (batch, max_len, Hkv, D)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Attention(nn.Module):
    """wq (d, q_dim), wk / wv (d, kv_dim), wo (q_dim, d): x @ w, the
    reference's orientation."""

    def __init__(self, cfg, dtype, generator=None, device=None, *,
                 window=0):
        super().__init__()
        if window:
            raise NotImplementedError(
                "sliding-window attention (local_attn) is not ported yet "
                "(ROADMAP.md queue 1 item 11)")
        if cfg.logit_softcap:
            raise NotImplementedError(
                "attention with logit_softcap != 0 is not ported yet "
                "(ROADMAP.md queue 1 item 11)")
        if cfg.pos_type == "mrope":
            raise NotImplementedError(
                "attention with M-RoPE positions is not ported yet "
                "(ROADMAP.md queue 1 item 11)")
        if cfg.pos_type not in ("rope", "none"):
            raise ValueError(cfg.pos_type)
        self.cfg = cfg
        d = cfg.d_model
        for name, shape in (("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
                            ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d))):
            setattr(self, name, layers.weight(generator, *shape, dtype,
                                              device))

    def _project(self, x, positions):
        """q (B, S, H, D), k and v (B, S, Hkv, D), RoPE on q and k."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = (x @ self.wq).view(B, S, H, D)
        k = (x @ self.wk).view(B, S, Hkv, D)
        v = (x @ self.wv).view(B, S, Hkv, D)
        if cfg.pos_type == "rope":
            q = layers.rope(q, positions, cfg.rope_theta)
            k = layers.rope(k, positions, cfg.rope_theta)
        return q, k, v

    def prefill(self, x, positions, max_len, cache_dtype, attn_fn=None):
        """The whole prompt: (out (B, S, d), its KV cache of max_len).
        The cache holds the prompt's k, v at slots 0..S-1 (the last
        max_len of them when S >= max_len)."""
        B, S, _ = x.shape
        q, k, v = self._project(x, positions)
        if S >= max_len:
            cache = {"k": k[:, S - max_len:].to(cache_dtype).clone(),
                     "v": v[:, S - max_len:].to(cache_dtype).clone()}
        else:
            cache = cache_init(self.cfg, B, max_len, cache_dtype, x.device)
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        out = prefill_attention(q, k, v, attn_fn)
        return out.reshape(B, S, self.cfg.q_dim) @ self.wo, cache

    def decode_step(self, x1, cache, pos: int):
        """One token at position ``pos``.  x1: (B, 1, d).  Writes its k, v
        into ``cache`` in place (the reference returns a new cache; the
        port saves the copy of every layer's cache per token) and
        returns (out (B, 1, d), cache)."""
        cfg = self.cfg
        B = x1.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x1.device)
        q, k1, v1 = self._project(x1, positions)
        L = cache["k"].shape[1]
        slot = min(pos, L - 1)
        cache["k"][:, slot] = k1[:, 0]
        cache["v"][:, slot] = v1[:, 0]
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        g = cfg.num_heads // Hkv
        qh = q.view(B, 1, Hkv, g, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                         cache["k"].float()) / math.sqrt(D)
        valid = torch.arange(L, device=x1.device) <= pos
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, cache["v"].float())
        out = out.to(x1.dtype).reshape(B, 1, cfg.q_dim)
        return out @ self.wo, cache
