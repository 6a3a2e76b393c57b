"""Hand-written CUDA kernels of the port and their torch bindings.

  csrc/recurrence.cuh  the Wigner-d recurrence step every kernel shares
  csrc/dwt_block.cuh   the block body of the recurrence DWT / iDWT kernels
                       and their one launcher
  csrc/dwt_fused.cu    fused ragged + on-the-fly DWT / iDWT (sm_90a), and
                       the on-the-fly pair over every degree, no skip
  csrc/streaming.cu    their l-chunked streaming twins + window builder
  csrc/dwt_dense.cu    dense / ragged DWT / iDWT against a resident table
  csrc/folded_attention.cu  causal flash attention, folded schedule
  dwt_fused.py         wrappers, launch counts and plain versions of ...
  streaming.py           ... the streaming kernels
  wigner_rec.py          ... the on-the-fly kernels, and recurrence_step,
                         the step's torch twin
  dwt.py                 ... the dense and ragged kernels
  folded_attention.py    ... the attention kernel
  ops.py               dwt_fn / idwt_fn closures for core.batched, and
                       attention for the LM
  autotune.py          static schedule rules (shared memory, V="auto")
  runtime.py           nvcc build at first use + ctypes loading and launch
  ref.py               plain torch oracles
"""
from . import (autotune, dwt, dwt_fused, folded_attention,  # noqa: F401
               ops, ref, runtime, streaming, wigner_rec)
