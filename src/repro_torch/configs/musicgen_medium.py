"""MusicGen-medium [audio] (arXiv:2306.05284; hf tier).

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 -- decoder-only
transformer over EnCodec tokens.  The EnCodec frontend (4 codebooks,
delay-pattern interleaving) is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d); the backbone plus the
token head over the 2048-entry codebook vocabulary is what we model.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layernorm",
    pos_type="rope",   # stand-in for MusicGen's sinusoidal embeddings
    tie_embeddings=False,
    embed_inputs=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        ce_chunk=64, attn_chunk=32)
