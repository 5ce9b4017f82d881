"""merge_roofline.explore: the merge kernels' share of their roofline
(the device time of ``merge_parts``, the segmented launch included),
with each answer's merge counted by ``bench/costs/kernels.py::merge``,
in %."""
from bench.devtrace.readers import roofline


def read(t):
    return roofline(t, "merge")
