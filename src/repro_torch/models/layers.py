"""Common LM layers: norms, embeddings, rotary variants, MLPs -- the port of
``repro/models/layers.py``.

Plain functions on tensors, and the ``nn.Module``s that hold their
weights.  Norms, rotary embeddings and activations compute in float32
and cast back to the input's dtype where the reference does, so a bf16
model rounds at the same places.  Weights keep the reference's
orientation: a dense layer is ``x @ w`` with ``w`` of shape (d_in, d_out).
Every parameter is created without a gradient (serving needs none);
:meth:`repro_torch.models.lm.LM.trainable` switches gradients on for
training.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import sharding

__all__ = ["DTYPES", "dtype_of", "rmsnorm", "layernorm", "RMSNorm",
           "LayerNorm", "make_norm", "dense_init", "embed_init", "rope",
           "mrope", "GATED", "PLAIN", "mlp_apply", "MLP", "weight",
           "param", "normal", "softcap"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# norms (the scale parameter is float32 whatever the model's dtype, and
# enters as (1 + scale))
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale) + bias
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.scale = param(torch.zeros(d, dtype=torch.float32,
                                       device=device))

    def forward(self, x):
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = param(torch.zeros(d, **kw))
        self.bias = param(torch.zeros(d, **kw))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)


def make_norm(kind, d, device=None) -> nn.Module:
    if kind == "rmsnorm":
        return RMSNorm(d, device)
    if kind == "layernorm":
        return LayerNorm(d, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# initializers (a torch.Generator gives other numbers than jax.random from
# the same seed: tests hand both packages the same weights instead)
# ---------------------------------------------------------------------------

_NORMAL_CHUNK = 1 << 28    # float32 elements drawn at once


def normal(generator, shape, scale, dtype, device=None):
    """scale * N(0, 1) drawn in float32 and cast to ``dtype``.  A tensor
    of more than 2**28 elements is drawn in slabs along its first axis,
    so a large bf16 weight (an embedding of 4.7e9 values, a layer of 128
    experts) never has a float32 copy of its whole."""
    shape = tuple(shape)
    if math.prod(shape) <= _NORMAL_CHUNK:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(_NORMAL_CHUNK // math.prod(shape[1:]), 1)
    for r0 in range(0, shape[0], rows):
        n = min(rows, shape[0] - r0)
        w = torch.randn((n,) + shape[1:], generator=generator,
                        dtype=torch.float32, device=device)
        out[r0:r0 + n] = (w * scale).to(dtype)
    return out


def dense_init(generator, d_in, d_out, dtype, scale=None, device=None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return normal(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator, vocab, d, dtype, device=None):
    # std 0.02 (GPT/llama convention); keeps tied-head logits ~O(1) at init
    return normal(generator, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim, theta):
    """The reference's numpy float32 expression, so the frequencies are
    the same bits."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=16)
def _device_freqs(head_dim, theta, device):
    """_rope_freqs on ``device``, copied there once: a host-to-device copy
    per call would stall the host every layer of every decode step."""
    return torch.from_numpy(_rope_freqs(head_dim, theta)).to(device)


def _rotate(x, ang):
    """x (B, S, H, D) rotated by angles ang (B, S, D/2), in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """Rotary embedding.  x: (B, S, H, D); positions: (B, S) int."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs          # (B, S, D/2)
    return _rotate(x, ang)


def mrope(x, positions, sections, theta=10000.0):
    """Multimodal RoPE (Qwen2-VL): positions (3, B, S) = (t, h, w) indices;
    `sections` splits the D/2 frequency channels between t/h/w."""
    D = x.shape[-1]
    freqs = _device_freqs(D, theta, x.device)
    sec = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    if len(sec) != D // 2:
        raise ValueError(f"mrope sections {sections} do not split D/2 = "
                         f"{D // 2}")
    sec = torch.from_numpy(sec).to(x.device)
    pos = positions.float()                              # (3, B, S)
    ang = pos[sec].permute(1, 2, 0) * freqs              # (B, S, D/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

GATED = {"swiglu": F.silu,
         "geglu": lambda x: F.gelu(x, approximate="tanh")}
PLAIN = {"gelu": lambda x: F.gelu(x, approximate="tanh"),
         "sqrelu": lambda x: torch.square(F.relu(x))}


def mlp_apply(x, wi, wo, kind):
    """Gated: silu (or gelu) of the gate in float32, cast to x's dtype,
    times the up projection; plain: the activation in float32."""
    h = x @ wi
    if kind in GATED:
        g, u = torch.chunk(h, 2, dim=-1)
        h = GATED[kind](g.float()).to(x.dtype) * u
    else:
        h = PLAIN[kind](h.float()).to(x.dtype)
    return h @ wo


class MLP(nn.Module):
    """wi (d, ff, or 2 ff gated: [gate | up]), wo (ff, d).  Placed
    (:func:`repro_torch.models.sharding.place_`, with ``ctx``), wi is
    split by columns and wo by rows over the model group: the rank's
    block of the ff units, one all-reduce of wo's partial sums.  A gated
    wi's column blocks do not pair gate and up units (rank r of n holds
    columns [2 r ff / n, 2 (r + 1) ff / n)), so its block of h is
    all-gathered over the model group and the rank takes the gate and up
    units of its wo rows; the gather's backward reduce-scatters."""

    def __init__(self, d, ff, kind, dtype, generator=None, device=None):
        super().__init__()
        self.kind = kind
        wi_out = 2 * ff if kind in GATED else ff
        self.wi = weight(generator, d, wi_out, dtype, device)
        self.wo = weight(generator, ff, d, dtype, device)

    def forward(self, x, ctx=None, w=None):
        """x (..., d) -> (..., d); ``w``: the weights whole over the data
        axes (default the parameters)."""
        w = w if w is not None else {"wi": self.wi, "wo": self.wo}
        if ctx is None or not sharding.split_on(self, "wi", -1):
            return mlp_apply(x, w["wi"], w["wo"], self.kind)
        n, r = ctx.n_model, ctx.model_rank
        row = sharding.split_on(self, "wo", 0)
        with sharding.split_work():
            h = sharding.enter_model(x, ctx) @ w["wi"]
        if not row:          # wo whole: every rank takes every unit
            h = sharding.all_gather(h, ctx, -1)
        if self.kind in GATED:
            if row and n > 1:
                h = sharding.all_gather(h, ctx, -1, partial=True)
                ff = h.shape[-1] // 2
                q = ff // n
                g, u = h[..., r * q:(r + 1) * q], \
                    h[..., ff + r * q:ff + (r + 1) * q]
            else:
                g, u = torch.chunk(h, 2, dim=-1)
            h = GATED[self.kind](g.float()).to(x.dtype) * u
        else:
            h = PLAIN[self.kind](h.float()).to(x.dtype)
        if not row:
            return h @ w["wo"]
        with sharding.split_work():
            y = h @ w["wo"]
        return sharding.all_reduce(y, ctx, "model")


def weight(generator, d_in, d_out, dtype, device=None, scale=None):
    """A (d_in, d_out) weight, created without a gradient (see
    :func:`param`): from dense_init when a generator is given, else left
    unset (meta device, or filled by a converter)."""
    if generator is None:
        w = torch.empty((d_in, d_out), dtype=dtype, device=device)
    else:
        w = dense_init(generator, d_in, d_out, dtype, scale, device)
    return param(w)


def param(w) -> nn.Parameter:
    """A parameter holding tensor ``w``, created without a gradient:
    serving runs under ``torch.no_grad``, and
    :meth:`repro_torch.models.lm.LM.trainable` sets ``requires_grad`` on
    every parameter of a model that trains."""
    return nn.Parameter(w, requires_grad=False)


def softcap(logits, cap):
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)
