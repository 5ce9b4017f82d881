"""gibbs_roofline: the blocked Gibbs sweep's share of its roofline, with
its work counted from the gaps' real tokens, in %."""
from bench.devtrace.readers import roofline


def read(t):
    return roofline(t, "gibbs")
