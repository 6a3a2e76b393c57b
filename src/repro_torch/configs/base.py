"""Architecture configuration schema -- the port's copy of
``repro/configs/base.py``.

One :class:`ArchConfig` per architecture lives in
``repro_torch/configs/<id>.py`` with the exact published dimensions; each
also provides a ``reduced()`` variant of the same family for CPU tests.
``repro_torch.configs.get(name)`` resolves the ported ones.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MoEConfig", "ArchConfig", "ShapeConfig", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "LM_SHAPES",
           "sub_quadratic", "shapes_for"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01  # load-balance loss (Switch/GShard)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # block pattern, cycled over layers: entries in
    #   {"attn", "local_attn", "rglru", "rwkv6"}; mixer is followed by
    #   "moe" or the dense MLP depending on `moe`.
    block_pattern: tuple = ("attn",)
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu | sqrelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    pos_type: str = "rope"           # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of head_dim pairs
    window: int = 0                  # sliding-window size for local_attn
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scale
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    embed_inputs: bool = False       # audio/vlm: inputs are frame/patch
    #                                  embeddings from a stubbed frontend
    moe: MoEConfig | None = None
    moe_pattern: tuple = ()          # per-pattern-slot MoE flag; () = all
    #                                  slots MoE when `moe` is set
    # rwkv6
    rwkv_head_dim: int = 64
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training memory policy
    remat: str = "block"             # none | block | nested (sqrt-remat)
    remat_inner: int = 0             # nested: inner segment len (0 = sqrt)
    ce_chunk: int = 1024             # chunked cross-entropy seq block
    attn_chunk: int = 512            # q-chunk of the reference's jnp attention
    scan_layers: bool = True

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---------------- derived sizes ----------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> list:
        """Mixer kind per layer (pattern cycled, truncated to num_layers)."""
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def slot_uses_moe(self, slot: int) -> bool:
        if self.moe is None:
            return False
        if not self.moe_pattern:
            return True
        return bool(self.moe_pattern[slot % len(self.moe_pattern)])


# ---------------------------------------------------------------------------
# input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def sub_quadratic(cfg: ArchConfig) -> bool:
    """long_500k eligibility: every layer must be local-attn or recurrent."""
    return all(k != "attn" for k in cfg.layer_kinds())


def shapes_for(cfg: ArchConfig):
    """The runnable shape cells for an arch (long_500k only for
    sub-quadratic archs)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not sub_quadratic(cfg):
            continue
        out.append(s)
    return out
