"""Reduction of a ``torch.profiler`` trace of a traced slice: device
activity as a union of intervals, device time by kernel name, and the idle
gaps with the host operation in flight."""

from __future__ import annotations

SLICE = "portbench.slice"


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_events(events, top=10):
    """``events``: ``(name, on_device, start_us, end_us)`` tuples of one
    profile, the traced slice marked by a host event named ``SLICE``.
    Returns the slice's length, the union of device activity inside it, the
    device time and launches by name, and the ``top`` longest idle gaps
    with the innermost host event at each gap's middle."""
    slices = [(s, e) for name, dev, s, e in events if not dev and name == SLICE]
    if not slices:
        raise RuntimeError(f"the trace holds no {SLICE!r} span")
    lo, hi = slices[0]
    # The slice's own annotation shows on the device's timeline too: it is
    # no device activity.
    dev = [(name, s, e) for name, d, s, e in events
           if d and name != SLICE and e > lo and s < hi]
    intervals = clip([(s, e) for _, s, e in dev], lo, hi)
    busy, merged = union_us(intervals)
    by_name, counts = {}, {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo))
        counts[name] = counts.get(name, 0) + 1
    gaps, prev = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [(name, s, e) for name, d, s, e in events if not d and name != SLICE]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [(e - s, name) for name, s, e in host if s <= mid <= e]
        named.append((min(inner)[1] if inner else "host idle", (b - a) * 1e-6))
    return dict(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
                by_name={k: v * 1e-6 for k, v in by_name.items()}, counts=counts,
                gaps=named)


def events_of(prof):
    """The profile's events as ``(name, on_device, start_us, end_us)``."""
    import torch

    out = []
    for e in prof.events():
        on_dev = e.device_type != torch.autograd.DeviceType.CPU
        out.append((e.name, on_dev, float(e.time_range.start), float(e.time_range.end)))
    return out


def breakdown(red, top=10):
    """The ``breakdown`` of a result line: the device operations that took
    most time and the longest idle gaps, ``[name, seconds]`` each."""
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in red["gaps"][:top]]}


def kernel_time(red, pattern: str):
    """(device seconds, launches) of the kernels whose name holds ``pattern``."""
    names = [k for k in red["by_name"] if pattern in k]
    return sum(red["by_name"][k] for k in names), sum(red["counts"][k] for k in names)
