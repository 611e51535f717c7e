"""The 95th percentile of the control steps' latencies over every step of
the window, each timed from when it was due to when its control was on the
host (host clock)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=float), 95))
