"""Device ms a transform in the program's so3.inverse.gather stages (the
coefficient gather into the iDWT's operand), timed by CUDA events in the
program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "inverse", "gather")
