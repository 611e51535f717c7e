"""The device's idle share in the traced slice: 100 x (1 - the
union of device activity intervals / the slice)."""

from portbench.metrics_common import idle_pct


def read(rec):
    return idle_pct(rec)
