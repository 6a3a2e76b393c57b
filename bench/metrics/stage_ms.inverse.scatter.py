"""Device ms a transform in the program's so3.inverse.scatter stages (the
iDWT result scattered into FFT bins, beta mirror included), timed by CUDA
events in the program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "inverse", "scatter")
