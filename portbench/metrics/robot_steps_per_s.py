"""Robot-steps of the fleet completed in the window over the window's whole
length (host clock): B robots times the steps run, finished robots
included, since the solver runs on the whole batch."""

from portbench.metrics_common import rate


def read(rec):
    return rate(rec)
