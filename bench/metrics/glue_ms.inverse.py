"""Device ms a transform of every operation outside the DWT family inside
the inverse calls (the grid stages of core/batched.py: cuFFT, gather /
scatter, elementwise, copies)."""
from bench import devtrace


def read(view):
    return devtrace.glue_ms(view, "inverse")
