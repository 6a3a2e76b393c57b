"""Share (%) of the inverse calls' host time in which no device operation
ran."""
from bench import devtrace


def read(view):
    return devtrace.idle(view, "inverse")
