"""Language model, serving half: embeddings -> blocks -> final norm ->
tied head; prefill of a prompt batch and one-token decode -- the port of
``repro/models/lm.py`` (``init``, ``count_params``, ``state_init``,
``prefill`` with ``_block_prefill`` and its KV-cache write,
``decode_step``, ``logits_fn``, ``_embed_in``).

The reference stacks layers of one pattern slot for ``jax.lax.scan``; here
the blocks are an ``nn.ModuleList`` in layer order (PyTorch runs eagerly;
:func:`repro_torch.models.convert.params_from_numpy` unstacks the
reference's groups).  Decode states are a list of per-layer KV caches.

Not ported (ROADMAP.md queue 1 item 11): the rglru / rwkv6 mixers, MoE
blocks, frontend-embedding inputs, ``forward`` and ``loss_fn``; each
raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.batched import resolve_device

from . import attention, layers

__all__ = ["MIXERS", "Block", "LM", "init", "count_params", "state_init",
           "forward", "loss_fn"]

MIXERS = ("attn", "local_attn", "rglru", "rwkv6")
_NOT_PORTED = "not ported yet (ROADMAP.md queue 1 item 11)"


class Block(nn.Module):
    """norm1 -> attention mixer -> residual; norm2 -> MLP -> residual."""

    def __init__(self, kind, cfg, dtype, generator=None, device=None, *,
                 use_moe=False):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(kind)
        if kind in ("rglru", "rwkv6"):
            raise NotImplementedError(f"the {kind} mixer is {_NOT_PORTED}")
        if use_moe:
            raise NotImplementedError(f"MoE blocks are {_NOT_PORTED}")
        d = cfg.d_model
        self.norm1 = layers.make_norm(cfg.norm_type, d, device)
        self.mixer = attention.Attention(
            cfg, dtype, generator, device,
            window=cfg.window if kind == "local_attn" else 0)
        self.norm2 = layers.make_norm(cfg.norm_type, d, device)
        self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_type, dtype, generator,
                              device)

    def prefill(self, x, positions, max_len, cache_dtype, attn_fn=None):
        """One block over the full sequence, also emitting its KV cache."""
        mix, cache = self.mixer.prefill(self.norm1(x), positions, max_len,
                                        cache_dtype, attn_fn)
        x = x + mix
        return x + self.mlp(self.norm2(x)), cache

    def decode_step(self, x, cache, pos: int):
        """One block over a single token, advancing its cache in place."""
        mix, cache = self.mixer.decode_step(self.norm1(x), cache, pos)
        x = x + mix
        return x + self.mlp(self.norm2(x)), cache


class LM(nn.Module):
    """embed (vocab, d), blocks, final_norm; the head is the embedding
    (tie_embeddings) or its own (vocab, d) weight."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        if cfg.embed_inputs:
            raise NotImplementedError(
                f"frontend-embedding inputs ({cfg.name}) are {_NOT_PORTED}")
        self.cfg = cfg
        dtype = layers.dtype_of(cfg.param_dtype)
        self.dtype = layers.dtype_of(cfg.compute_dtype)
        self.embed = _embedding(generator, cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.head = _embedding(generator, cfg, dtype, device)
        self.final_norm = layers.make_norm(cfg.norm_type, cfg.d_model,
                                           device)
        pat = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(kind, cfg, dtype, generator, device,
                  use_moe=cfg.slot_uses_moe(i % len(pat)))
            for i, kind in enumerate(cfg.layer_kinds()))

    def head_weight(self):
        return self.head if hasattr(self, "head") else self.embed

    def _embed_in(self, tokens):
        x = self.embed[tokens].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=self.dtype, device=x.device)
        return x

    def logits_fn(self, x):
        """Hidden (B, S, d) -> logits (B, S, vocab), float32."""
        out = torch.einsum("bsd,vd->bsv", x, self.head_weight()).float()
        return layers.softcap(out, self.cfg.logit_softcap)

    @torch.no_grad()
    def prefill(self, tokens, max_len, *, attn_fn=None):
        """Full-prompt prefill.  tokens: (B, S) integer.  Returns
        (last-position logits (B, vocab) float32, per-layer KV caches of
        max_len).  ``attn_fn`` replaces the attention call of every layer
        (default: :func:`repro_torch.kernels.ops.attention`)."""
        x = self._embed_in(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        states = []
        for block in self.blocks:
            x, st = block.prefill(x, positions, max_len, self.dtype, attn_fn)
            states.append(st)
        x = self.final_norm(x[:, -1:])
        return self.logits_fn(x)[:, -1], states

    @torch.no_grad()
    def decode_step(self, tokens, states, pos: int):
        """One-token decode.  tokens: (B, 1); states: from
        :meth:`prefill` or :func:`state_init`, advanced in place; pos: the
        token's position.  Returns (logits (B, vocab) float32, states)."""
        x = self._embed_in(tokens)
        for i, block in enumerate(self.blocks):
            x, states[i] = block.decode_step(x, states[i], pos)
        x = self.final_norm(x)
        return self.logits_fn(x)[:, -1], states


def _embedding(generator, cfg, dtype, device):
    if generator is None:
        w = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device)
    else:
        w = layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device)
    return nn.Parameter(w, requires_grad=False)


def init(cfg, generator, device=None) -> LM:
    """The model with random weights drawn from ``generator``, which must
    live on ``device`` (None: the card; a CPU run passes "cpu")."""
    return LM(cfg, generator, resolve_device(device)).eval()


def count_params(cfg) -> int:
    """Parameter count, built on the meta device (nothing allocated)."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())


def state_init(cfg, batch, max_len, dtype=None, device=None):
    """Empty decode states: one KV cache per layer."""
    dtype = dtype or layers.dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    for kind in cfg.layer_kinds():
        if kind != "attn":
            raise NotImplementedError(f"{kind} decode state is "
                                      f"{_NOT_PORTED}")
    return [attention.cache_init(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.num_layers)]


def forward(*args, **kwargs):
    raise NotImplementedError(f"lm.forward (training) is {_NOT_PORTED}")


def loss_fn(*args, **kwargs):
    raise NotImplementedError(f"lm.loss_fn (training) is {_NOT_PORTED}")
