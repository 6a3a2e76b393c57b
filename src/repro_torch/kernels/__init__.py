"""Hand-written CUDA kernels of the port and their torch bindings.

  csrc/recurrence.cuh  the Wigner-d recurrence step every kernel shares
  csrc/dwt_fused.cu    fused ragged + on-the-fly DWT / iDWT (sm_90a)
  dwt_fused.py         their wrappers, launch counts and plain versions
  wigner_rec.py        recurrence_step, the step's torch twin
  ops.py               dwt_fn / idwt_fn closures for core.batched
  autotune.py          static schedule rules (shared memory, V="auto")
  runtime.py           nvcc build at first use + ctypes loading
  ref.py               plain torch oracles
"""
from . import autotune, dwt_fused, ops, ref, runtime, wigner_rec  # noqa: F401
