"""Device ms a transform in the program's so3.inverse.fft stages (the grid
FFTs of core/batched.py (cuFFT) and their writes into the output grid),
timed by CUDA events in the program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "inverse", "fft")
