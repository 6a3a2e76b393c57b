"""repro_torch.obs -- spans, counters and bounded histograms for the
port.  See :mod:`repro_torch.obs.trace`."""
from .trace import (TRACE_ENV, Recorder, add_span, check_chrome_trace,
                    counter, device_annotation, get_recorder, inc, observe,
                    set_recorder, span, time_fn)

__all__ = ["Recorder", "span", "add_span", "inc", "observe", "counter",
           "time_fn", "check_chrome_trace", "get_recorder", "set_recorder",
           "device_annotation", "TRACE_ENV"]
