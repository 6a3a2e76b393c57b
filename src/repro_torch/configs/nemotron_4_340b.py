"""Nemotron-4-340B [dense] (arXiv:2402.16819 / 2406.11704; unverified tier).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 -- squared-ReLU
MLP (no gating), LayerNorm, RoPE, untied head.  The memory-limit case of
the configurations: fitting optimizer state forces ZeRO-3 over the full 512-chip
multi-pod mesh (EXPERIMENTS.md Sec. Dry-run discusses the arithmetic).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    block_pattern=("attn",),
    mlp_type="sqrelu",
    norm_type="layernorm",
    pos_type="rope",
    tie_embeddings=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=192, num_heads=6, num_kv_heads=2,
        head_dim=32, d_ff=768, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
