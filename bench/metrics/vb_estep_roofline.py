"""vb_estep_roofline: the E-step kernels' share of their roofline, each
call counted at its window's nonzeros, in %."""
from bench.devtrace.readers import roofline


def read(t):
    return roofline(t, "vb_estep")
