"""Qwen2-VL-7B [vlm] (arXiv:2409.12191; hf tier).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 -- M-RoPE
(temporal/height/width split 16/24/24 of the 64 rotary channel pairs),
dynamic-resolution ViT frontend STUBBED: input_specs()
provides precomputed patch embeddings plus the (3, B, S) M-RoPE position
streams; the LM backbone is modeled exactly.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="mrope",
    mrope_sections=(16, 24, 24),
    tie_embeddings=False,
    embed_inputs=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, mrope_sections=(4, 6, 6),
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
