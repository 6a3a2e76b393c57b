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
group on the rank's E / n_model experts, and :func:`loss_fn` returns the
global loss.  A placed model (:func:`~repro_torch.models.sharding.place_`;
:func:`init` and :func:`~repro_torch.models.convert.params_from_numpy`
with ``ctx``) holds each parameter's block under the reference's rules:
each block gathers its data-sharded weights once per call, the mixers
and MLPs run their model-split columns and rows (the attention kernel on
the rank's heads), the embedding looks up the rank's vocab rows and the
head computes the rank's vocab columns (:func:`loss_fn`'s cross-entropy
combines max and sum-exp over the model group; the serving logits are
all-gathered).
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

    def _weights(self, ctx):
        """The block's weights whole over the data axes with ``ctx`` (one
        gather per dtype), None without."""
        return None if ctx is None else sharding.gather_params(self, ctx)

    def _ffn(self, x, ctx=None, w=None):
        """norm2 -> MLP or MoE: (out, aux)."""
        h = self.norm2(x)
        if hasattr(self, "moe"):
            return self.moe(h, ctx, sharding.sub_weights(w, "moe"))
        return self.mlp(h, ctx, sharding.sub_weights(w, "mlp")), 0.0

    def forward(self, x, positions, ctx=None):
        """Training: one block over the full sequence.  Returns (x, aux),
        aux the MoE's load-balance loss (0.0 without MoE)."""
        w = self._weights(ctx)
        h = self.norm1(x)
        mw = sharding.sub_weights(w, "mixer")
        if isinstance(self.mixer, attention.Attention):
            x = x + self.mixer(h, positions, ctx, mw)
        else:
            x = x + self.mixer(h, ctx, mw)
        f, aux = self._ffn(x, ctx, w)
        return x + f, aux

    def prefill(self, x, positions, max_len, cache_dtype, attn_fn=None,
                ctx=None):
        """One block over the full sequence, also emitting its decode
        state.  ``attn_fn`` reaches a plain causal attention layer's kernel
        call only."""
        w = self._weights(ctx)
        h = self.norm1(x)
        mw = sharding.sub_weights(w, "mixer")
        if isinstance(self.mixer, attention.Attention):
            mix, st = self.mixer.prefill(h, positions, max_len, cache_dtype,
                                         attn_fn, ctx, mw)
        else:
            mix, st = self.mixer.prefill(h, ctx, mw)
        x = x + mix
        return x + self._ffn(x, ctx, w)[0], st

    def decode_step(self, x, state, pos: int, ctx=None):
        """One block over a single token, advancing its state (a KV cache
        in place)."""
        w = self._weights(ctx)
        h = self.norm1(x)
        mw = sharding.sub_weights(w, "mixer")
        if isinstance(self.mixer, attention.Attention):
            mix, st = self.mixer.decode_step(h, state, pos, ctx, mw)
        else:
            mix, st = self.mixer.decode_step(h, state, ctx, mw)
        x = x + mix
        return x + self._ffn(x, ctx, w)[0], st


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

    def trainable(self, flag: bool = True) -> "LM":
        """Set ``requires_grad`` on every parameter (created without a
        gradient for serving); returns the model."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    @property
    def _head_name(self):
        return "head" if hasattr(self, "head") else "embed"

    def _top(self, ctx):
        """{"embed", "head"}: the embedding and the head weight, whole over
        the data axes with ``ctx`` (one gather)."""
        if ctx is None:
            return {"embed": self.embed, "head": self.head_weight()}
        w = sharding.gather_params(self, ctx, ("embed", "head"))
        w.setdefault("head", w["embed"])
        return w

    def _embed_in(self, tokens, embeds, ctx=None, top=None):
        cfg = self.cfg
        if cfg.embed_inputs:
            if embeds is None:
                raise ValueError(f"{cfg.name} takes frontend embeddings "
                                 f"(embeds=), not tokens")
            x = embeds.to(self.dtype)
        else:
            if tokens is None:
                raise ValueError(f"{cfg.name} takes tokens")
            top = self._top(ctx) if top is None else top
            x = self._lookup(tokens, top["embed"], ctx).to(self.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=self.dtype,
                                 device=x.device)
        return x

    def _lookup(self, tokens, emb, ctx):
        """Embedding rows of ``tokens``; with a vocab-split table the
        rank's rows, zero elsewhere, summed over the model group."""
        if ctx is None or not sharding.split_on(self, "embed", 0):
            return emb[tokens]
        vl = emb.shape[0]
        idx = tokens.long() - ctx.model_rank * vl
        ok = (idx >= 0) & (idx < vl)
        rows = torch.where(ok[..., None], emb[idx.clamp(0, vl - 1)], 0.0)
        return sharding.all_reduce(rows, ctx, "model")

    def _logits(self, x, head, ctx):
        """(float32 soft-capped logits of the rank's vocab columns, whether
        the head splits the vocab over the model group)."""
        split = ctx is not None and sharding.split_on(self, self._head_name,
                                                      0)
        xs = sharding.enter_model(x, ctx) if split else x
        with sharding.split_work(split):
            out = torch.einsum("bsd,vd->bsv", xs, head).float()
        return layers.softcap(out, self.cfg.logit_softcap), split

    def logits_fn(self, x, ctx=None, head=None):
        """Hidden (B, S, d) -> logits (B, S, vocab), float32; a
        vocab-split head's columns all-gathered over the model group.
        ``head``: the head weight whole over the data axes (default: the
        parameter, gathered with ``ctx``)."""
        if head is None:
            head = self._top(ctx)["head"]
        out, split = self._logits(x, head, ctx)
        if split:
            out = sharding.all_gather(out, ctx, -1)
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
        top = self._top(ctx)
        x = self._embed_in(tokens, embeds, ctx, top)
        B, S = x.shape[:2]
        positions = _positions(self.cfg, positions, B, S, x.device)
        states = []
        for block in self.blocks:
            x, st = block.prefill(x, positions, max_len, self.dtype, attn_fn,
                                  ctx)
            states.append(st)
        x = self.final_norm(x[:, -1:])
        return self.logits_fn(x, ctx, top["head"])[:, -1], states

    @torch.no_grad()
    def decode_step(self, tokens, states, pos: int, *, embeds=None,
                    ctx=None):
        """One-token decode.  tokens: (B, 1), or None with ``embeds``
        (B, 1, d); states: from :meth:`prefill` or :func:`state_init`,
        advanced (KV caches in place); pos: the token's position.  Returns
        (logits (B, vocab) float32, states).  ``ctx`` as in
        :meth:`prefill`."""
        top = self._top(ctx)
        x = self._embed_in(tokens, embeds, ctx, top)
        for i, block in enumerate(self.blocks):
            x, states[i] = block.decode_step(x, states[i], pos, ctx)
        x = self.final_norm(x)
        return self.logits_fn(x, ctx, top["head"])[:, -1], states


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
    ``ctx`` it is placed (:func:`~repro_torch.models.sharding.place_`: the
    rank's block of the same draws as the whole model's)."""
    model = LM(cfg, generator, resolve_device(device))
    if ctx is not None:
        sharding.place_(model, ctx)
    return model.eval()


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


def _layer_state(cfg, kind, batch, max_len, dtype, device, n):
    if kind in ("attn", "local_attn"):
        split = attention.cache_split(cfg, n) if cfg.q_dim % n == 0 \
            else None
        return attention.cache_init(
            cfg, batch, max_len, dtype, device,
            window=cfg.window if kind == "local_attn" else 0, n_model=n,
            split=split)
    if kind == "rglru":
        return rglru.state_init(cfg, batch, dtype, device, n)
    if kind == "rwkv6":
        return rwkv6.state_init(cfg, batch, dtype, device, n)
    raise ValueError(kind)


def state_init(cfg, batch, max_len, dtype=None, device=None, ctx=None):
    """Empty decode states, one per layer: KV caches (a ring of
    min(window, max_len) for ``local_attn``), RG-LRU and RWKV-6 states;
    with ``ctx`` a placed model's rank's part of them (``batch`` is the
    rank's rows)."""
    dtype = dtype or layers.dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    n = 1 if ctx is None else ctx.n_model
    return [_layer_state(cfg, kind, batch, max_len, dtype, device, n)
            for kind in cfg.layer_kinds()]


def _positions(cfg, positions, B, S, device):
    if positions is not None:
        return positions
    if cfg.pos_type == "mrope":
        raise ValueError(f"{cfg.name}: M-RoPE needs positions (3, B, S)")
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(model: LM, batch, ctx=None, top=None):
    """Training forward: batch {"tokens": (B, S)} or {"embeds": (B, S, d)},
    optional "positions" ((B, S), or (3, B, S) for M-RoPE) -> (final
    hidden states (B, S, d) after the final norm, aux loss (float32)).

    Layers run in groups of one pattern cycle, as the reference's scan
    body; ``cfg.remat`` "block" checkpoints each group, "nested" (with
    ``scan_layers``) each segment of gi groups, gi = ``remat_inner`` or
    sqrt(G) lowered to a divisor of G.  The tail layers past the last
    whole group run without remat, as in the reference.  With ``ctx`` the
    batch is this rank's rows, the MoE layers run sharded and aux is the
    global one; ``top``: the embedding whole over the data axes
    (:func:`loss_fn` gathers it once for the lookup and a tied head)."""
    cfg = model.cfg
    x = model._embed_in(batch.get("tokens"), batch.get("embeds"), ctx, top)
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


def _nll_sum(logits, labels, ctx=None):
    """Sum over positions of logsumexp(logits) - logits[label], float32:
    max and sum-exp, then the label's logit.  With ``ctx`` the logits are
    the rank's vocab columns: the max, the sum-exp and the label's logit
    (zero on the ranks that do not hold it) are combined over the model
    group, so the (B, S, vocab) logits are never gathered."""
    m = torch.amax(logits.detach(), -1, keepdim=True)
    if ctx is not None:
        m = sharding.all_reduce(m, ctx, "model", "max")
    s = torch.sum(torch.exp(logits - m), -1)
    if ctx is not None:
        s = sharding.all_reduce(s, ctx, "model")
    lse = torch.log(s) + m[..., 0]
    if ctx is None:
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        vl = logits.shape[-1]
        idx = labels.long() - ctx.model_rank * vl
        ok = (idx >= 0) & (idx < vl)
        picked = torch.gather(logits, -1,
                              idx.clamp(0, vl - 1)[..., None])[..., 0]
        picked = sharding.all_reduce(torch.where(ok, picked, 0.0), ctx,
                                     "model")
    return torch.sum(lse - picked)


def loss_fn(model: LM, batch, ctx=None):
    """Mean next-token cross-entropy plus the aux loss, the reference's
    chunked form: per ``ce_chunk`` positions, logits in the compute dtype
    cast to float32, soft-capped, logsumexp minus the label's logit
    (:func:`_nll_sum`), summed; nll / (B S) + aux.  batch adds "labels"
    (B, S).

    With ``ctx`` the batch is this rank's B / n_data rows: the nll sum is
    all-reduced over the data group and divided by the global B S, so
    every rank returns the global loss; each rank's gradient is its rows'
    share, summed by the trainer (:func:`repro_torch.train.trainer
    .reduce_grads`) or, for a data-sharded weight, by the reduce-scatter
    of its gather.  A vocab-split head computes the rank's logits
    columns only."""
    cfg = model.cfg
    top = model._top(ctx)
    x, aux = forward(model, batch, ctx, top)
    labels = batch["labels"]
    B, S = labels.shape
    c = min(cfg.ce_chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is no multiple of ce_chunk {c}")
    split = ctx is not None and sharding.split_on(model, model._head_name,
                                                  0)
    xs = sharding.enter_model(x, ctx) if split else x
    w = top["head"]
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, c):
        with sharding.split_work(split):
            logits = torch.einsum("bsd,vd->bsv", xs[:, c0:c0 + c], w)
        logits = layers.softcap(logits.float(), cfg.logit_softcap)
        nll = nll + _nll_sum(logits, labels[:, c0:c0 + c],
                             ctx if split else None)
    if ctx is not None:
        nll = sharding.all_reduce(nll, ctx, "data")
        B = B * ctx.n_data
    return nll / (B * S) + aux
