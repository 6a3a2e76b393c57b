"""repro_torch.obs -- spans, counters, bounded histograms and device-timed
stages for the port.  See :mod:`repro_torch.obs.trace`."""
from .trace import (STAGE_DROPPED, Recorder, add_span, check_chrome_trace,
                    counter, device_annotation, device_tracing, get_recorder,
                    inc, observe, set_recorder, span, stage, time_fn,
                    tracing)

__all__ = ["Recorder", "span", "add_span", "inc", "observe", "counter",
           "time_fn", "check_chrome_trace", "get_recorder", "set_recorder",
           "device_annotation", "device_tracing", "tracing", "stage",
           "STAGE_DROPPED"]
