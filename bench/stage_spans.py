"""The program's own stage spans (``repro_torch.obs.stage``): device time
a transform in each stage of the SO(3) transform, read from the program's
recorder.

The program records a stage only while tracing is on, which a ``--trace 1``
run's profiler turns on for the window alone; each span is timed between
two CUDA events on the stream.  A program without such spans (or one that
dropped a pending pair for lack of room) gives None."""
from __future__ import annotations

# repro_torch.obs.STAGE_DROPPED, by value: an older program without it must
# still be read
DROPPED = "obs.stage.dropped"


def stage_ms(view, direction: str, stage: str):
    """Total ms of the ``so3.<direction>.<stage>`` spans over the
    transforms of the ``direction`` calls."""
    rec = view.program_recorder
    n = view.transforms(direction)
    if rec is None or not n or rec.counter(DROPPED):
        return None
    q = rec.quantiles(f"so3.{direction}.{stage}")
    return None if q is None else q["total"] * 1e3 / n
