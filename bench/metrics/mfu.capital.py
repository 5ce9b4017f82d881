"""mfu.capital: the least time of the E-step calls the window's fits
required, at one H100's peaks, over the window's wall time, in %."""
from bench.devtrace.readers import mfu


def read(t):
    return mfu(t, ("vb_estep",))
