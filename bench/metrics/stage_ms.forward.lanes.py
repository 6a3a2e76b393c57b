"""Device ms a transform in the program's so3.forward.lanes stages (the
V-lane chunking of Transform._batch: zero padding of a partial chunk, the
torch.cat of the chunks), timed by CUDA events in the program
(bench/stage_spans.py)."""
from bench import stage_spans


def read(view):
    return stage_spans.stage_ms(view, "forward", "lanes")
