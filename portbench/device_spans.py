"""The device's time under the port's spans in a traced slice, for the
metric readers: ``utils.profiling.device_ms`` (a pair of CUDA events a
span opened with ``device=True``) read from the port once, after a traced
slice, into ``rec["device_spans"]`` as ``(name, ms)`` pairs.  A checkout
whose port times no span on the device, a run without a traced slice, or
one on the CPU (no events) gives None."""

from __future__ import annotations

import statistics


def _read_port():
    """``[(span name, device ms), ...]`` in the order the spans started, or
    None where the port times no span on the device."""
    try:
        from safe_control_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "device_ms", None)
    if read is None:
        return None
    spans = profiling.spans()
    return [(spans[i].name, ms) for i, ms in sorted(read().items())]


def device_spans(rec):
    """``rec["device_spans"]``, read from the port at the first call after
    a traced slice; None without a slice."""
    if rec.get("trace") is None:
        return None
    if "device_spans" not in rec:
        rec["device_spans"] = _read_port()
    return rec["device_spans"]


def span_device_ms(rec, name):
    """The median over the slice's spans named ``name`` of the device ms
    between their two events: a step's device work under the span.  The
    median leaves out the slice's first steps, which follow a sync and so
    hold the host's gaps."""
    got = device_spans(rec)
    if not got:
        return None
    d = [ms for n, ms in got if n == name]
    return statistics.median(d) if d else None
