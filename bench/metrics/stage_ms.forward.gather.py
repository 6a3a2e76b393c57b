"""Device ms a transform in the program's so3.forward.gather stages (the
member gather: FFT bins at every cluster member, the beta mirror, the
weighted write into the DWT's operand), timed by CUDA events in the
program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "forward", "gather")
