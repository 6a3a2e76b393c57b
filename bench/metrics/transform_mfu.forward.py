"""Share (%) of the card's peak flop rate of the whole forward transform (DWT
plus 2-D FFTs, bench/counts.py) over the host time of its calls."""
from bench import devtrace


def read(view):
    return devtrace.transform_mfu(view, "forward")
