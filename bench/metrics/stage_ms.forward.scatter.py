"""Device ms a transform in the program's so3.forward.scatter stages (the DWT
result scattered into the dense coefficient layout), timed by CUDA events
in the program (bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "forward", "scatter")
