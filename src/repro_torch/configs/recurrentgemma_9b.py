"""RecurrentGemma-9B [hybrid] (Griffin; arXiv:2402.19427; unverified tier).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 1:2 pattern (2 recurrent blocks per local-attn block),
window 2048, GeGLU, head_dim 256, gemma-style embed scaling + logit softcap.
38 = 12 * (rglru, rglru, local_attn) + 2 trailing recurrent blocks.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    mlp_type="geglu",
    norm_type="rmsnorm",
    pos_type="rope",
    window=2048,
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512, window=32,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
