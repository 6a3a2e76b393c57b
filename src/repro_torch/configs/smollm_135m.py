"""SmolLM-135M [dense] (hf:HuggingFaceTB/SmolLM-135M; hf tier).

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 -- llama-architecture
small model (SwiGLU, RMSNorm, RoPE, tied embeddings).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=144, num_heads=4, num_kv_heads=2,
        head_dim=36, d_ff=384, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
