"""Llama-4-Maverick 400B-A17B [moe]
(hf:meta-llama/Llama-4-Scout-17B-16E family; unverified tier).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 experts top-1
plus one shared expert (early-fusion multimodal in the original; the text
backbone is what is assigned).  SwiGLU experts, RMSNorm, RoPE.  Maverick
INTERLEAVES dense and MoE layers (every other layer routed) -- that is
what lands the total at ~400B with 17B active.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "attn"),
    moe_pattern=(False, True),       # dense / MoE interleave
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25,
                  num_shared_experts=1),
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=1, capacity_factor=1.5,
                      num_shared_experts=1),
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
