"""Device ms a transform in the program's so3.forward.fft stages (the grid
FFTs of core/batched.py (cuFFT) and their per-lane stacks), timed by CUDA
events in the program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "forward", "fft")
