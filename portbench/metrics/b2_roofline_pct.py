"""B2's share of its roofline: the least time of a launch (its operations
at the FP32 peak or its bytes at the HBM rate, whichever is longer) over
its device time a launch in the traced slice."""

from portbench.metrics_common import b2_roofline_pct


def read(rec):
    return b2_roofline_pct(rec)
