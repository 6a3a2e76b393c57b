"""RWKV-6 "Finch" 3B [ssm] (arXiv:2404.05892; hf tier).

32L d_model=2560 attention-free (40 wkv heads of dim 64) d_ff=8960
vocab=65536 -- data-dependent per-channel decay (the Finch hallmark).
Channel-mix uses squared-ReLU (RWKV's k = relu(xW)^2), LayerNorm, no
positional encoding (recurrence carries order).  The paper's technique
(triangle-fold scheduling) is INAPPLICABLE here -- attention-free, uniform
per-token work; documented in DESIGN.md Sec. 7.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    mlp_type="sqrelu",
    norm_type="layernorm",
    pos_type="none",
    tie_embeddings=False,
    rwkv_head_dim=64,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, d_ff=256, vocab_size=512,
        rwkv_head_dim=32,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
