"""mfu.explore: the least time of the merges the window's answers
required, at one H100's peaks, over the window's wall time, in %."""
from bench.devtrace.readers import mfu


def read(t):
    return mfu(t, ("merge",))
