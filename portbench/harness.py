"""One run of one cell: the cell, its configuration, traffic, limits and
metric readers found by the names in ``BENCHMARK.json``; set-up, the
measured window, the traced slice, the check against the reference and the
result line.

A cell's files: ``configs/<config>.json`` (its ``file`` in
``BENCHMARK.json``), ``traffic/<traffic>.json`` (whose ``driver`` names a
module of ``drivers/``), ``limits/<cell>.json`` (the limit of each number
compared) and one reader a metric, ``metrics/<metric>.py`` (or that of
the quantity before the first dot of its name), whose ``read(rec)``
returns the metric's value or None when it has nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

from portbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "safe_control_tpu")


def load_benchmark(held_back: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held_back``, also the entries of the cells
    that it leaves out (``held_back.json``), for the tests."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if held_back:
        more = json.loads((HERE / "held_back.json").read_text())
        for key in ("workloads", "configs", "end_to_end", "per_layer"):
            bench[key] = bench[key] + more[key]
    return bench


def resolve(bench: dict, cell: str) -> dict:
    """The cell's workload entry, configuration, traffic, limits and the
    metrics it reports, each loaded from its file."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    wl = by_name[cell]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())

    def applies(metric):
        return "workloads" not in metric or cell in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in moved]
    return dict(workload=wl, config=config, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def reader(name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, else the
    reader of the quantity it splits, ``metrics/<name up to its first
    dot>.py`` (``device_idle_pct.batch`` and ``device_idle_pct.sweep`` read
    alike and move different end-to-end metrics)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_class(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def check_limits(numbers: dict, limits: dict) -> tuple:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit}
    return ok, checks


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
             overrides=None, log=print, bench=None) -> dict:
    """Run one cell once; returns the result line's object.  ``overrides``
    (a dict of ``config``/``traffic`` keys) shrinks a cell for a test;
    ``bench``: the benchmark's entries (``BENCHMARK.json``'s by default)."""
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    c = resolve(bench, cell)
    for part, extra in (overrides or {}).items():
        c[part] = {**c[part], **extra}
    drv = driver_class(c["traffic"])(c["config"], c["traffic"], seed, device)
    drv.warmup()
    log(f"set-up: {time.perf_counter() - t_start:.3f} s")
    rec = dict(cell=cell, config=c["config"], traffic=c["traffic"],
               setup_s=time.perf_counter() - t_start)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec.update(drv.window(seconds))
    log(f"window: {rec['steps']} steps in {rec['window_s']:.4f} s, {rec['launches']} "
        f"{rec['launch_name']} launches, {rec['failed']} of {rec['attempted']} failed")
    log(spread_line(rec))
    log(f"outcomes: {rec['outcomes']}")
    if trace:
        t_trace = time.perf_counter()
        rec.update(traced(drv, device))
        log(f"traced slice: {rec['trace_steps']} steps, {rec['trace']['window_s']:.4f} s, "
            f"reduced with the rest in {time.perf_counter() - t_trace:.2f} s")
    dev_info = device_info(device, c["workload"]["chips"])
    captures = rec.pop("captures")
    t_check = time.perf_counter()
    numbers, active, checked = drv.check(captures)
    log(f"check: {checked} of {len(captures)} captured steps against the reference in "
        f"{time.perf_counter() - t_check:.2f} s")
    rec["active_rows_per_problem"] = active
    del captures
    numbers["launch_gap"] = float(abs(rec["launches"] - rec["steps"])) if device != "cpu" \
        else 0.0
    numbers["fallbacks"] = float(fallbacks())
    correct, checks = check_limits(numbers, {"launch_gap": 0.0, "fallbacks": 0.0,
                                             **c["limits"]["limits"]})
    log("numbers of the check: " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()))
    metrics = c["per_layer"] if trace else c["end_to_end"]
    out_metrics = {}
    for m in metrics:
        value = reader(m["name"]).read(rec)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev_info.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": out_metrics, "device": dev_info}
    if trace:
        result["breakdown"] = trace_mod.breakdown(rec["trace"])
    result["checks"] = checks
    return result


def spread_line(rec) -> str:
    """Medians and maxima of the window's step times, and the generator's
    lateness: information beside the metrics."""
    import numpy as np

    if rec.get("latencies_ms"):
        lat = np.asarray(rec["latencies_ms"])
        q = np.percentile(lat, [50, 90, 95, 99])
        return (f"latency ms: median {q[0]:.4f}, p90 {q[1]:.4f}, p95 {q[2]:.4f}, p99 "
                f"{q[3]:.4f}, max {lat.max():.4f} over {lat.size} steps; generator "
                f"lateness at most {rec['lateness_s'] * 1e3:.4f} ms")
    per = np.asarray(rec.get("chunk_ms_per_step") or [float("nan")])
    return (f"ms a step by chunk: median {np.median(per):.4f}, min {per.min():.4f}, max "
            f"{per.max():.4f} over {per.size} chunks")


def fallbacks() -> int:
    """Fallbacks of the MPC dispatch from the fused kernel, logged once each."""
    from safe_control_tpu_torch.solvers import mpc_cbf

    return len(mpc_cbf._FUSED_FALLBACK_SEEN)


def traced(drv, device) -> dict:
    """A traced slice after the window: device activity, kernel time by
    name and idle gaps from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        steps = drv.traced_slice(lambda: record_function(trace_mod.SLICE))
    red = trace_mod.reduce_events(trace_mod.events_of(prof))
    return dict(trace=red, trace_steps=steps)

