"""The control of the check: the same sampled steps answered in the
nearest precision below the configuration's (bfloat16 for float32), held
against the reference like the program's answers.  Where the port runs
that precision (its general path: the MPC cells), the port is the
control; where it does not (the CBF-QP's polish has no bfloat16 LU), the
reference in bfloat16 stands in the port's place.

    python3 portbench/control.py --workload du_fleet.track --seeds 1 2 3

prints, for each seed, the numbers of the program's check and of the
control's, one JSON line each; the limits of ``limits/<cell>.json`` lie
between the two.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.drivers import common  # noqa: E402
from portbench.reference import tracking as ref_tracking  # noqa: E402

LOWER = torch.bfloat16


def _cast(tree, dtype):
    return torch.utils._pytree.tree_map(
        lambda t: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t, tree)


class _RefOut:
    """The reference's answers in the shape of a port's step output."""

    def __init__(self, ref):
        self.x, self.mode, self.goal_idx, self.ret, self.u = (
            ref["x"], ref["mode"], ref["goal_idx"], ref["ret"], ref["u"])
        self.mpc = None


def control_numbers(drv, captures, finite_only=False):
    """The check's numbers with the control in the program's place, on the
    steps the check compares; ``finite_only``: each gap over the control's
    finite answers alone."""
    from safe_control_tpu_torch.sim import tracking

    model, tcfg, st = common.ref_setup(drv.config)
    chosen = common.choose(drv.seed, captures, drv.traffic.get("samples", len(captures)))
    acc = {}
    for b in drv.blocks(chosen):
        rows = torch.arange(b.u.shape[0], device=b.u.device)
        if drv.config["tracker"]["controller"] == "mpc_cbf":
            cfg = common.port_tracker_config(drv.config)
            spec = common.port_spec(drv.config)
            out = tracking.step(cfg, spec, _cast(b.before, LOWER), _cast(b.wps, LOWER), b.n,
                                _cast(b.obs, LOWER))
            low = common.StepOut(out.state, out.u)
        else:
            ref_low = ref_tracking.step(model, tcfg, st,
                                        _cast(common.ref_state(b.before, rows), LOWER),
                                        _cast(b.wps, LOWER), b.n, _cast(b.obs, LOWER))
            low = _RefOut(ref_low)
        got, _ = common.compare_step(model, tcfg, st, b.before, low, rows, b.wps, b.n, b.obs,
                                     finite_only)
        if b.obs_after is not None:  # the moving obstacles, in the lower precision
            moved = ref_tracking.move_obstacles(_cast(b.obs, LOWER), tcfg["dt"], drv.y_range)
            got["obs_gap"] = common.max_abs(moved.float() - b.obs_after.float(), finite_only)
        got["nonfinite_rows"] = float((~torch.isfinite(low.u.float())).any(-1).sum())
        common.merge_max(acc, got)
    return acc


def readings(cell, seed, seconds, device="cuda", overrides=None, held_back=False):
    """(the program's numbers, the control's, the control's over its
    finite answers) on one seed; ``held_back``: a cell that BENCHMARK.json
    leaves out."""
    bench = harness.load_benchmark(held_back)
    c = harness.resolve(bench, cell)
    for part, extra in (overrides or {}).items():
        c[part] = {**c[part], **extra}
    drv = harness.driver_class(c["traffic"])(c["config"], c["traffic"], seed, device)
    drv.warmup()
    rec = drv.window(seconds)
    program = drv.check(rec["captures"])[0]
    control = control_numbers(drv, rec["captures"])
    finite = control_numbers(drv, rec["captures"], finite_only=True)
    return program, control, finite


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control readings of a cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        program, control, finite = readings(args.workload, seed, args.seconds)
        print(json.dumps({"cell": args.workload, "seed": seed, "program": program,
                          "control": control, "control_finite": finite,
                          "seconds": time.perf_counter() - t0},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
