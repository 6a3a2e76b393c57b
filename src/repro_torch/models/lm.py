"""Language model: embeddings (or frontend embeddings) -> pattern-cycled
blocks -> final norm -> head -- the port of ``repro/models/lm.py``:
serving (``init``, ``count_params``, ``count_active_params``,
``state_init``, ``prefill`` with ``_block_prefill``, ``decode_step`` with
``_block_decode``, ``logits_fn``, ``_embed_in``) and training
(``forward``, ``loss_fn`` with its chunked cross-entropy).

The reference stacks layers of one pattern slot for ``jax.lax.scan``; here
the blocks are an ``nn.ModuleList`` in layer order (PyTorch runs eagerly;
:func:`repro_torch.models.convert.params_from_numpy` unstacks the
reference's groups, and :func:`~repro_torch.models.convert.leaf_groups`
names the layers of each stacked leaf for the optimizer).  A block's
mixer is attention (``attn``, ``local_attn``),
:class:`~repro_torch.models.rglru.RGLRU` or
:class:`~repro_torch.models.rwkv6.RWKV6`; its FFN is the MLP or, on the
config's MoE slots, :class:`~repro_torch.models.moe.MoE`.  Decode states
are a list of per-layer dicts: a KV cache ({"k", "v"}), an RG-LRU state
({"h", "conv"}) or an RWKV-6 state ({"S", "x_prev"}).

Training runs the plain attention (``chunked_causal``) in every layer,
as the reference does; ``cfg.remat`` "block" recomputes each pattern
group in the backward (``torch.utils.checkpoint``), "nested" each
segment of about sqrt(G) groups.  Parameters are created without a
gradient; :meth:`LM.trainable` switches them on.

The sharded path (``ctx``, a :class:`~repro_torch.models.sharding.ShardCtx`)
runs each rank's share of the reference's SPMD program: the batch enters
data-sharded (the rank's B / n_data rows, or every row when the data axes
do not divide B, as the reference's ``specs._dp_or_none`` decides), every
MoE layer runs its expert- and sequence-parallel path over the model
group on the rank's E / n_model experts (:meth:`LM.shard_experts`), and
:func:`loss_fn` returns the global loss.  The non-expert parameters stay
replicated (the reference's FSDP / TP placements are not applied at run
time, ROADMAP.md queue 1 item 11e).  Serving with ``ctx`` runs the
attention kernel exactly as without.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.batched import resolve_device

from . import attention, layers, moe, rglru, rwkv6, sharding

__all__ = ["MIXERS", "Block", "LM", "init", "count_params",
           "count_active_params", "state_init", "forward", "loss_fn"]

MIXERS = ("attn", "local_attn", "rglru", "rwkv6")


class Block(nn.Module):
    """norm1 -> mixer -> residual; norm2 -> MLP or MoE -> residual."""

    def __init__(self, kind, cfg, dtype, generator=None, device=None, *,
                 use_moe=False):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(kind)
        self.kind = kind
        d = cfg.d_model
        self.norm1 = layers.make_norm(cfg.norm_type, d, device)
        if kind in ("attn", "local_attn"):
            self.mixer = attention.Attention(
                cfg, dtype, generator, device,
                window=cfg.window if kind == "local_attn" else 0)
        elif kind == "rglru":
            self.mixer = rglru.RGLRU(cfg, dtype, generator, device)
        else:
            self.mixer = rwkv6.RWKV6(cfg, dtype, generator, device)
        self.norm2 = layers.make_norm(cfg.norm_type, d, device)
        if use_moe:
            self.moe = moe.MoE(cfg, dtype, generator, device)
        else:
            self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_type, dtype,
                                  generator, device)

    def _ffn(self, x, ctx=None):
        h = self.norm2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, ctx)[0]
        return x + self.mlp(h)

    def forward(self, x, positions, ctx=None):
        """Training: one block over the full sequence.  Returns (x, aux),
        aux the MoE's load-balance loss (0.0 without MoE)."""
        h = self.norm1(x)
        if isinstance(self.mixer, attention.Attention):
            x = x + self.mixer(h, positions)
        else:
            x = x + self.mixer(h)
        h = self.norm2(x)
        if hasattr(self, "moe"):
            f, aux = self.moe(h, ctx)
        else:
            f, aux = self.mlp(h), 0.0
        return x + f, aux

    def prefill(self, x, positions, max_len, cache_dtype, attn_fn=None,
                ctx=None):
        """One block over the full sequence, also emitting its decode
        state.  ``attn_fn`` reaches a plain causal attention layer's kernel
        call only."""
        h = self.norm1(x)
        if isinstance(self.mixer, attention.Attention):
            mix, st = self.mixer.prefill(h, positions, max_len, cache_dtype,
                                         attn_fn)
        else:
            mix, st = self.mixer.prefill(h)
        return self._ffn(x + mix, ctx), st

    def decode_step(self, x, state, pos: int, ctx=None):
        """One block over a single token, advancing its state (a KV cache
        in place)."""
        h = self.norm1(x)
        if isinstance(self.mixer, attention.Attention):
            mix, st = self.mixer.decode_step(h, state, pos)
        else:
            mix, st = self.mixer.decode_step(h, state)
        return self._ffn(x + mix, ctx), st


class LM(nn.Module):
    """embed (vocab, d), blocks, final_norm; the head is the embedding
    (tie_embeddings) or its own (vocab, d) weight.  A config with
    ``embed_inputs`` (audio, vision-language) takes frontend embeddings
    (B, S, d) instead of tokens; its embedding table still feeds the
    generated tokens back in decode."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
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

    def shard_experts(self, ctx) -> "LM":
        """Keep only the model rank's E / n_model experts in every MoE
        layer (:meth:`~repro_torch.models.moe.MoE.shard_`); returns the
        model.  A no-op at n_model = 1."""
        if ctx is not None and ctx.n_model > 1:
            for block in self.blocks:
                if hasattr(block, "moe"):
                    block.moe.shard_(ctx)
        return self

    def trainable(self, flag: bool = True) -> "LM":
        """Set ``requires_grad`` on every parameter (created without a
        gradient for serving); returns the model."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def _embed_in(self, tokens, embeds):
        cfg = self.cfg
        if cfg.embed_inputs:
            if embeds is None:
                raise ValueError(f"{cfg.name} takes frontend embeddings "
                                 f"(embeds=), not tokens")
            x = embeds.to(self.dtype)
        else:
            if tokens is None:
                raise ValueError(f"{cfg.name} takes tokens")
            x = self.embed[tokens].to(self.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=self.dtype,
                                 device=x.device)
        return x

    def logits_fn(self, x, ctx=None):
        """Hidden (B, S, d) -> logits (B, S, vocab), float32.  ``ctx``:
        the reference's vocab-over-model layout hint, the identity here
        (:func:`~repro_torch.models.sharding.constrain`)."""
        out = torch.einsum("bsd,vd->bsv", x, self.head_weight()).float()
        out = layers.softcap(out, self.cfg.logit_softcap)
        return sharding.constrain(out, ctx)

    @torch.no_grad()
    def prefill(self, tokens, max_len, *, embeds=None, positions=None,
                attn_fn=None, ctx=None):
        """Full-prompt prefill.  tokens: (B, S) integer, or None with
        ``embeds`` (B, S, d) for an ``embed_inputs`` config; positions:
        (B, S), or (3, B, S) for M-RoPE (default arange(S) per row).
        Returns (last-position logits (B, vocab) float32, per-layer decode
        states of max_len).  ``attn_fn`` replaces the attention kernel
        call of every plain causal layer (default:
        :func:`repro_torch.kernels.ops.attention`).  With ``ctx`` the
        rows are this rank's and the MoE layers run sharded."""
        x = self._embed_in(tokens, embeds)
        B, S = x.shape[:2]
        positions = _positions(self.cfg, positions, B, S, x.device)
        states = []
        for block in self.blocks:
            x, st = block.prefill(x, positions, max_len, self.dtype, attn_fn,
                                  ctx)
            states.append(st)
        x = self.final_norm(x[:, -1:])
        return self.logits_fn(x, ctx)[:, -1], states

    @torch.no_grad()
    def decode_step(self, tokens, states, pos: int, *, embeds=None,
                    ctx=None):
        """One-token decode.  tokens: (B, 1), or None with ``embeds``
        (B, 1, d); states: from :meth:`prefill` or :func:`state_init`,
        advanced (KV caches in place); pos: the token's position.  Returns
        (logits (B, vocab) float32, states).  ``ctx`` as in
        :meth:`prefill`."""
        x = self._embed_in(tokens, embeds)
        for i, block in enumerate(self.blocks):
            x, states[i] = block.decode_step(x, states[i], pos, ctx)
        x = self.final_norm(x)
        return self.logits_fn(x, ctx)[:, -1], states


def _embedding(generator, cfg, dtype, device):
    if generator is None:
        w = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device)
    else:
        w = layers.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device)
    return layers.param(w)


def init(cfg, generator, device=None, ctx=None) -> LM:
    """The model with random weights drawn from ``generator``, which must
    live on ``device`` (None: the card; a CPU run passes "cpu").  With
    ``ctx`` it keeps only the model rank's experts (the same draws as the
    whole model's)."""
    return LM(cfg, generator, resolve_device(device)).shard_experts(
        ctx).eval()


def count_params(cfg) -> int:
    """Parameter count, built on the meta device (nothing allocated)."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())


def count_active_params(cfg) -> int:
    """Active parameters per token: every wi / wo under a block's MoE
    counts top_k / num_experts of its size, the router whole.  As in the
    reference's count, that takes the shared experts' wi / wo at the
    routed share too."""
    model = LM(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    if cfg.moe is None:
        return total
    expert = sum(p.numel() for name, p in model.named_parameters()
                 if ".moe." in name and name.rsplit(".", 1)[1] in ("wi",
                                                                   "wo"))
    m = cfg.moe
    return total - expert + int(expert * m.top_k / m.num_experts)


def _layer_state(cfg, kind, batch, max_len, dtype, device):
    if kind in ("attn", "local_attn"):
        return attention.cache_init(
            cfg, batch, max_len, dtype, device,
            window=cfg.window if kind == "local_attn" else 0)
    if kind == "rglru":
        return rglru.state_init(cfg, batch, dtype, device)
    if kind == "rwkv6":
        return rwkv6.state_init(cfg, batch, dtype, device)
    raise ValueError(kind)


def state_init(cfg, batch, max_len, dtype=None, device=None):
    """Empty decode states, one per layer: KV caches (a ring of
    min(window, max_len) for ``local_attn``), RG-LRU and RWKV-6 states."""
    dtype = dtype or layers.dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    return [_layer_state(cfg, kind, batch, max_len, dtype, device)
            for kind in cfg.layer_kinds()]


def _positions(cfg, positions, B, S, device):
    if positions is not None:
        return positions
    if cfg.pos_type == "mrope":
        raise ValueError(f"{cfg.name}: M-RoPE needs positions (3, B, S)")
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(model: LM, batch, ctx=None):
    """Training forward: batch {"tokens": (B, S)} or {"embeds": (B, S, d)},
    optional "positions" ((B, S), or (3, B, S) for M-RoPE) -> (final
    hidden states (B, S, d) after the final norm, aux loss (float32)).

    Layers run in groups of one pattern cycle, as the reference's scan
    body; ``cfg.remat`` "block" checkpoints each group, "nested" (with
    ``scan_layers``) each segment of gi groups, gi = ``remat_inner`` or
    sqrt(G) lowered to a divisor of G.  The tail layers past the last
    whole group run without remat, as in the reference.  With ``ctx`` the
    batch is this rank's rows, the MoE layers run sharded and aux is the
    global one."""
    cfg = model.cfg
    x = model._embed_in(batch.get("tokens"), batch.get("embeds"))
    B, S = x.shape[:2]
    positions = _positions(cfg, batch.get("positions"), B, S, x.device)
    P = len(cfg.block_pattern)
    G = cfg.num_layers // P
    blocks = model.blocks

    def run(x, first, last):
        """Blocks [first, last) -> (x, their aux summed)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in blocks[first:last]:
            x, a = block(x, positions, ctx)
            aux = aux + a
        return x, aux

    if cfg.remat == "nested" and cfg.scan_layers and G:
        gi = cfg.remat_inner or max(int(math.sqrt(G)), 1)
        while G % gi:
            gi -= 1
        span, remat = gi * P, True
    else:
        span, remat = P, cfg.remat == "block"
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for first in range(0, G * P, span):
        if remat:
            x, a = checkpoint(run, x, first, first + span,
                              use_reentrant=False)
        else:
            x, a = run(x, first, first + span)
        aux_total = aux_total + a
    x, a = run(x, G * P, len(blocks))
    return model.final_norm(x), aux_total + a


def loss_fn(model: LM, batch, ctx=None):
    """Mean next-token cross-entropy plus the aux loss, the reference's
    chunked form: per ``ce_chunk`` positions, logits in the compute dtype
    cast to float32, soft-capped, logsumexp minus the label's logit,
    summed; nll / (B S) + aux.  batch adds "labels" (B, S).

    With ``ctx`` the batch is this rank's B / n_data rows: the nll sum is
    all-reduced over the data group and divided by the global B S, so
    every rank returns the global loss; each rank's gradient is its rows'
    share, summed by the trainer (:func:`repro_torch.train.trainer
    .reduce_grads`)."""
    cfg = model.cfg
    x, aux = forward(model, batch, ctx)
    labels = batch["labels"]
    B, S = labels.shape
    c = min(cfg.ce_chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is no multiple of ce_chunk {c}")
    w = model.head_weight()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, c):
        logits = torch.einsum("bsd,vd->bsv", x[:, c0:c0 + c], w).float()
        logits = layers.softcap(logits, cfg.logit_softcap)
        picked = torch.gather(logits, -1,
                              labels[:, c0:c0 + c, None].long())[..., 0]
        nll = nll + torch.sum(torch.logsumexp(logits, dim=-1) - picked)
    if ctx is not None:
        nll = sharding.all_reduce(nll, ctx, "data")
        B = B * ctx.n_data
    return nll / (B * S) + aux
