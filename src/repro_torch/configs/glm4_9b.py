"""GLM4-9B [dense] (hf:THUDM/glm-4-9b; hf tier).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 -- RoPE + GQA,
SwiGLU, RMSNorm, untied output head.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    tie_embeddings=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
