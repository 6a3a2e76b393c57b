"""The port's LM stack (``repro/models``):

  layers.py     norms, rotary embeddings, MLPs, soft-capping
  attention.py  GQA attention: prefill through the folded attention
                kernel (plain causal layers) or the chunked port
                (windowed / soft-capped layers), KV-cache and ring decode;
                training through the chunked port in every layer
  rglru.py      the RG-LRU recurrent mixer (RecurrentGemma)
  rwkv6.py      the RWKV-6 time-mix mixer
  moe.py        the MoE FFN: the single-device path and the expert- and
                sequence-parallel path (ctx)
  sharding.py   ShardCtx, the reference's placement rules
                (param_placements), the counted collectives of the
                sharded path
  lm.py         the LM module: prefill, decode_step, logits; forward and
                loss_fn for training; ctx threads the mesh through all
  convert.py    weights from the reference's numpy parameter pytree; the
                reference's stacked leaves over the port's layers
                (leaf_groups) for the optimizer and checkpoints
"""
from . import (attention, convert, layers, lm, moe, rglru,  # noqa: F401
               rwkv6, sharding)
