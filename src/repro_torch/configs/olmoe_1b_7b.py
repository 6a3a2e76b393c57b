"""OLMoE-1B-7B [moe] (arXiv:2409.02060; hf tier).

16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304, 64 experts top-8 --
fine-grained MoE (small d_ff per expert), SwiGLU experts, RMSNorm, RoPE.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=8, capacity_factor=1.25),
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.5),
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
