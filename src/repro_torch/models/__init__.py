"""The port's LM stack, serving half (``repro/models``):

  layers.py     norms, rotary embeddings, MLPs, soft-capping
  attention.py  GQA attention: prefill through the folded attention
                kernel, KV-cache decode
  lm.py         the LM module: prefill, decode_step, logits
  convert.py    weights from the reference's numpy parameter pytree
"""
from . import attention, convert, layers, lm  # noqa: F401
