"""merge_roofline: the merge kernels' share of their roofline, in %."""
from bench.devtrace.readers import roofline


def read(t):
    return roofline(t, "merge")
