"""Share (%) of its bound (bench/counts.py) that the DWT family reaches in
the forward calls: the bound over the family's device time."""
from bench import devtrace


def read(view):
    return devtrace.dwt_roofline(view, "forward")
