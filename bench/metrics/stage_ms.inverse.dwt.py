"""Device ms a transform in the program's so3.inverse.dwt stages (the iDWT
call (the fused kernel and its lane packing)), timed by CUDA events in the
program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "inverse", "dwt")
