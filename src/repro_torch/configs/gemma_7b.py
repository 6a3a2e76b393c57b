"""Gemma-7B [dense] (arXiv:2403.08295; hf tier).

28L d_model=3072 16H (kv=16; the 2B variant is MQA, 7B is MHA) d_ff=24576
vocab=256000 -- GeGLU, head_dim=256 (explicit: > d_model/num_heads),
RMSNorm, RoPE, sqrt(d)-scaled tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    block_pattern=("attn",),
    mlp_type="geglu",
    norm_type="rmsnorm",
    pos_type="rope",
    embed_scale=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=48, d_ff=512, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
