"""What the port records about itself in a traced slice, for the metric
readers: its spans (``utils.profiling.spans``, stamped with
``time.time_ns()``) and B3's phase clock (``solvers.mpc_fused.trace_totals``:
cycles by phase, summed over the slice's blocks).

``program(rec)`` reads both from the port once, after a traced slice, into
``rec["program"]``; the readers compute from that record alone.  A checkout
whose port keeps no spans or no phase clock, a run without a traced slice,
or one whose B3 ran as its plain version (on the CPU) gives None for what
it lacks."""

from __future__ import annotations

from portbench.metrics_common import B3_KERNEL
from portbench.trace import kernel_time

# B3's phases that each ``b3_<group>_ms`` metric sums.
B3_GROUPS = {
    "factor": ("cholesky", "substitutions"),
    "jacobian": ("jacobian",),
    "linesearch": ("linesearch",),
    "hessian": ("rows", "hessian", "damping"),
}


def _read_port():
    """(spans as (name, start_ns, end_ns, parent) tuples, B3's totals),
    each None where the port has none."""
    spans = totals = None
    try:
        from safe_control_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    read = getattr(profiling, "spans", None)
    if read is not None:
        spans = [tuple(s) for s in read()]
    try:
        from safe_control_tpu_torch.solvers import mpc_fused
    except ImportError:
        mpc_fused = None
    read = getattr(mpc_fused, "trace_totals", None)
    if read is not None:
        totals = read()
    return spans, totals


def program(rec):
    """``rec["program"]``: ``{"spans": ..., "b3": ...}`` read from the port
    at the first call after a traced slice; None without a slice."""
    if rec.get("trace") is None:
        return None
    if "program" not in rec:
        spans, b3 = _read_port()
        rec["program"] = {"spans": spans, "b3": b3}
    return rec["program"]


def _durations_ms(spans, name):
    return [(e - s) * 1e-6 for n, s, e, _ in spans if n == name and e > 0]


def span_ms(rec, name):
    """Mean duration (ms) of the spans named ``name`` in the slice."""
    prog = program(rec)
    spans = prog and prog["spans"]
    if not spans:
        return None
    d = _durations_ms(spans, name)
    return sum(d) / len(d) if d else None


def first_span_ms(rec, name):
    """Duration (ms) of the first span named ``name`` in the slice."""
    prog = program(rec)
    spans = prog and prog["spans"]
    if not spans:
        return None
    d = _durations_ms(spans, name)
    return d[0] if d else None


def self_ms(rec, name, child):
    """Mean over the spans named ``name`` of their duration less that of
    their direct children named ``child`` (ms)."""
    prog = program(rec)
    spans = prog and prog["spans"]
    if not spans:
        return None
    own = {i: (e - s) * 1e-6 for i, (n, s, e, _) in enumerate(spans) if n == name and e > 0}
    if not own:
        return None
    for n, s, e, parent in spans:
        if n == child and parent in own and e > 0:
            own[parent] -= (e - s) * 1e-6
    return sum(own.values()) / len(own)


def b3_totals(rec):
    """B3's phase clock over the slice, if it counted any cycles."""
    prog = program(rec)
    totals = prog and prog["b3"]
    return totals if totals and totals["total"] > 0 else None


def b3_phase_ms(rec, group):
    """B3's device ms a launch in the slice times the share of its blocks'
    cycles spent in the phases of ``group`` (``B3_GROUPS``)."""
    totals = b3_totals(rec)
    if totals is None:
        return None
    seconds, launches = kernel_time(rec["trace"], B3_KERNEL)
    if not launches or seconds <= 0:
        return None
    share = sum(totals["cycles"][p] for p in B3_GROUPS[group]) / totals["total"]
    return 1e3 * seconds / launches * share


def b3_active_rows(rec):
    """Active constraint rows a Newton step a problem, as B3 counted them."""
    totals = b3_totals(rec)
    if totals is None or totals["newton_steps"] <= 0:
        return None
    return totals["active_rows"] / totals["newton_steps"]
