"""Profiling and tracing hooks.

Port of ``safe_control_tpu/utils/profiling.py``: ``jax.profiler`` becomes
``torch.profiler`` and device synchronization.

    with trace_to("build/trace") as prof:
        run_sweep(...)
    prof.key_averages()            # time by kernel

    t = KernelTimer()
    with t.time("solve") as h:
        h["out"] = solve(...)      # the device of out is synchronized
    print(t.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with CPU activity, and CUDA activity where a card
    is present; yields the ``torch.profiler.profile`` and writes its Chrome
    trace to ``logdir/trace.json`` (viewable in Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


def _synchronize(out) -> None:
    for leaf in torch.utils._pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class KernelTimer:
    """Wall-clock timing of regions; the device of a region's output is
    synchronized before the clock is read."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            _synchronize(holder.get("out", sync_value))
            self.samples[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, xs in sorted(self.samples.items()):
            mean = sum(xs) / len(xs)
            lines.append(f"{name:30s} n={len(xs):5d} mean={mean * 1e3:9.3f} ms "
                         f"min={min(xs) * 1e3:9.3f} ms max={max(xs) * 1e3:9.3f} ms")
        return "\n".join(lines)

    def mean(self, name: str) -> float:
        xs = self.samples[name]
        return sum(xs) / len(xs)
