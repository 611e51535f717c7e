"""Arithmetic that several metric readers share: the kernels' roofline
shares from a traced slice and the yardstick of ``roofline.py``."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import roofline
from portbench.reference.models import make_model
from portbench.trace import kernel_time

B3_KERNEL = "mpc_fused_kernel"
B2_KERNEL = "qp_admm_kernel"


def rate(rec):
    """Robot-steps completed in the window over the window's whole length."""
    if "robot_steps" not in rec:
        return None
    return rec["robot_steps"] / rec["window_s"]


def idle_pct(rec):
    """100 x (1 - the union of device activity intervals / the traced slice)."""
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _per_launch(rec, pattern):
    tr = rec.get("trace")
    if tr is None:
        return None
    seconds, launches = kernel_time(tr, pattern)
    if not launches or seconds <= 0:
        return None
    return seconds / launches


def b3_roofline_pct(rec):
    """B3 at the cell's shape; the rho Jc'Jc updates for the active rows a
    problem that the reference met on the sampled steps, scaled to B."""
    t = _per_launch(rec, B3_KERNEL)
    active = rec.get("active_rows_per_problem")
    if t is None or active is None:
        return None
    c, tr = rec["config"], rec["traffic"]
    m = c["mpc"]
    B = tr.get("batch", 1)
    model = make_model(c["model"], SimpleNamespace(**c["spec"]))
    n, mu = model.n, model.m
    N, K = m["horizon"], m["num_obs"]
    NC = N * K + 2 * N * len(model.bounded_states())
    circles = sum(1 for o in c["scene"]["obstacles"] if len(o) < 7 or o[6] < 0.5)
    h_ops = roofline.b3_h_ops(c["model"], circles, len(c["scene"]["obstacles"]))
    step_ops = roofline.B3_MODEL_OPS[c["model"]][0]
    flops = roofline.b3_flops(B, n, mu, N, K, NC, step_ops, active * B, h_ops, model.rel_deg,
                              outer=m["outer_iters"], newton=m["newton_iters"])
    least, _ = roofline.bound_s(flops, roofline.b3_bytes(B, n, mu, N, K))
    return 100.0 * least / t


def b2_roofline_pct(rec):
    """B2 at the cell's shape: n inputs, the obstacle rows and the input box."""
    t = _per_launch(rec, B2_KERNEL)
    if t is None:
        return None
    c, tr = rec["config"], rec["traffic"]
    B, n = tr["batch"], 2
    m = c["tracker"]["num_obs"] + n
    flops = roofline.b2_flops(B, n, m, c["tracker"]["qp_iters"])
    least, _ = roofline.bound_s(flops, roofline.b2_bytes(B, n, m))
    return 100.0 * least / t
