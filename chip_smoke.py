"""Smoke test of the PyTorch port on one NVIDIA GPU (the port's main paths).

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the three CUDA kernels from ``csrc/`` (one nvcc
   each, started together); reports the fused DU MPC kernel's build
   (registers, stack frame and spills from ptxas) and its launch shape.
2. Holds the DU kernel against its plain PyTorch version on the card with
   the main path's inputs and the full 8x3 budget (max |du| < 5e-3, viol
   atol 1e-3): at B=4096, cold start and the warm start one step later, and
   on ragged batches, B=1 and B=17 (a partly filled warp and block) and
   B=4097; prints whether each pair is bit-identical.  Then 64 problems
   against the general ``mpc_cbf.solve``.
3. Drives the MPC-CBF main path, ``entry.build_step(batch=4096,
   device="cuda")``, for 5 warm-started steps; every output must be finite,
   the kernel's launch count must rise by at least 5, and on each step the
   first 64 robots' controls must agree with the kernel's plain version
   given the same inputs.
4. Times the DU kernel and its plain version, and solves/s of the main path
   through the kernel and through the general solve; the kernel alone at
   B=1 (one problem's critical path) and B=16384 (a full card); and at
   B=4096 its operation count (the rho Jc'Jc updates counted from the plain
   version's activation tests on these inputs), its bound at 67 TFLOP/s and
   the share of it reached.
5. Reports the QP ADMM kernel's build (seconds, ptxas registers, stack and
   spills) and its launch shape at m=7 and m=153: lanes a problem, register
   rows a lane, problems and threads a block.
6. Holds the QP kernel against its plain version: (a) the DoubleIntegrator2D
   CBF-QPs of ``entry.build_cbf_qp_step`` at 1600 iterations, at B=4096 and
   on ragged batches, B=1 (a lone group), B=17 (a partly filled warp) and
   B=4097 (a ragged block) (max |dx| < 1e-3, equal ``feasible`` flags);
   (b) feasible random QPs at n=3, m=153 (the Manipulator2D scale), B=256,
   300 iterations (max |dx| < 2e-3 where both solve, at least 3/4 solved);
   both print whether each pair is bit-identical; (c) against the general
   ``qp.solve_qp`` on 64 main-path problems (|dx| < 2e-3 where both are
   feasible, equal ``feasible`` flags).
7. Drives the CBF-QP path, ``entry.build_cbf_qp_step(4096, device="cuda")``,
   for 5 closed-loop steps: finite outputs of the right shapes, at least 5
   QP kernel launches, and each step's first 64 robots within 1e-3 of the
   plain version on the same inputs.
8. Times the QP kernel's launch at B=1, 4096 and 16384, the kernel through
   its wrapper (and the wrapper's ``qp.equilibrate`` and ``qp.finish``
   alone) and its plain version, and CBF-QP steps/s through the kernel and
   through the general path; the kernel's operation count, bound and share
   reached.
9. Reports the generic fused MPC kernel's build: seconds, threads a block,
   and registers, stack, spills, dynamic shared memory and blocks an SM (the
   CUDA occupancy calculator) per model instantiation.
10. Holds the fused kernel against its plain version (max |du| < 5e-3,
    max |dxs| < 5e-3, viol atol 1e-3, the JAX package's kernel-class
    envelope): (a) Quad3D N=10 at B=4096, cold start and the warm start one
    step later; (b) DynamicUnicycle2D N=8 on ``entry.build_step``'s cold
    start at B=4096, against its plain version and against the DU kernel
    (the first 64 problems within the envelope, and 95% of the batch: a few
    cost-flat problems settle apart in float32); (c) VTOL2D N=16 (M=64, more than 48 KB of shared memory) at B=256;
    (d) SingleIntegrator2D and DoubleIntegrator2D N=10 at B=64.  Prints
    whether each pair is bit-identical.
11. Drives the fused path, ``entry.build_fused_step(4096, device="cuda")``
    (Quad3D N=10 through ``mpc_cbf.solve_dispatch``), for 5 warm-started
    steps: finite outputs of the right shapes, at least 5 fused kernel
    launches, each step's first 64 robots within 5e-3 of the plain version.
12. Times the fused kernel at B=1, 4096 and 16384 and its plain version at
    B=4096, the fused path's solves/s through the kernel and through the
    general solve, the kernel's operation count, bound and share reached
    (active rows counted in phase 10a), and the single-robot latency:
    microseconds per solve over a chain of warm-started B=1
    ``solve_dispatch`` calls, Quad3D N=10 and DU N=8, 25 through the fused
    kernel and 5 through the general solve (seconds a solve, host-bound).

13. The tracking loop, one robot: the DynamicUnicycle2D MPC-CBF scenario of
    ``tests/test_tracking_e2e.py`` (N=8, K=5, the 8x3 budget, tf 120 s)
    through ``sim.controller.LocalTrackingController(device="cuda")`` with
    ``use_fused_kernel``.  Gates: the run ends in RET_DONE and never returns
    RET_INFEASIBLE, every waypoint is passed within 0.35 m, the fused
    kernel launches once a control step, and no fused-fallback reason is
    logged.  Prints ms per control step (host clock) beside the 50 ms
    period.
14. The same for the DoubleIntegrator2D CBF-QP scenario (1600 ADMM
    iterations, tf 100 s): the same gates, with one QP kernel launch a
    control step.
15. A fleet through ``sim.tracking.run`` at B=4096: the DoubleIntegrator2D
    CBF-QP scenario for 2000 steps (robot 0 at the scenario's start, the
    others within +-0.1 m of it, from ``np.random.default_rng(0)``) and
    the DynamicUnicycle2D MPC-CBF one through the fused kernel for 50
    steps.  Gates: one kernel launch a step; robot 0 meets phase 14's
    predicates; for the first 64 robots, the first 20 (DI) and 5 (DU)
    recorded steps' controls within QP_U_TOL / U_TOL of ``tracking.step``
    run again on the recorded state with the kernel's plain version bound
    in its place.  Reports the share of robots that end in RET_DONE or
    RET_INFEASIBLE, robot-steps/s, ms a step and the kernel's share of the
    step (CUDA events around the launch, over the replayed steps).

16. B3's six later instantiations (Unicycle2D, KinematicBicycle2D and its
    C3BF and DPCBF variants, Quad2D, Manipulator2D): each one's registers,
    stack, spills, shared bytes and blocks an SM; each against its plain
    version at N=10, B=256 (``entry.build_fused_step``'s starts; C3BF and
    DPCBF among moving obstacles, the robots moving), cold start and the
    warm start one step later, in the kernel envelope, bits printed; at
    B=4096 its launch time, operation count (``b3_flops`` with the model's
    step and barrier operations and relative degree), bound and share.
    Manipulator2D has no MPC cost weights in the JAX package or the port (its
    MPC raises KeyError); unit weights stand in for this check.  Then five
    warm-started DPCBF ``solve_dispatch`` steps at B=4096: one launch a step,
    no fallback logged.
17. The dynamic-obstacle scenario of ``tests/test_dynamic_env_e2e.py`` (8
    moving obstacles, 2 waypoints, dt 0.05, a_max 5, radius 0.3):
    ``tracking.run_dynamic`` with the CBF-QP for 800 steps, one
    KinematicBicycle2D_DPCBF and one _C3BF robot (RET_DONE, never
    RET_INFEASIBLE, one B2 launch a step), then a DPCBF fleet at B=4096
    (robot 0 at the start, the others within +-0.1 m, ``default_rng(0)``):
    one launch a step, robot 0 meets the predicates, the first 64 robots'
    first 20 controls within QP_U_TOL of ``tracking.step`` replayed with
    B2's plain version; the shares of robots RET_DONE / RET_INFEASIBLE,
    robot-steps/s, ms a step and B2's share of it.
18. The Manipulator2D CBF-QP at B=4096 through ``cbf_qp.solve_batch`` (5
    obstacle slots x 23 link circles + 3 input rows: n=3, m=118, 32 lanes a
    problem) against its plain version (max |dx| < 2e-3, equal feasible
    flags, bits printed); the launch's time, bound and share.
19. The MPC variants on the general solve (no kernel takes them): optimal
    decay on the tight scene of ``tests/test_optimal_decay.py`` at B=64
    (every problem feasible, viol < 1e-3, max omega > 1.05, u[0] = -1); the
    KKT polish (``polish_iters=3`` at the parity tests' accuracy budget) in
    float64 on the c2 anchors of ``tests/data`` (within 1e-3 of the
    goldens); ``newton_f64`` on ``entry.build_step``'s inputs at B=256
    (finite, 95% within 5e-3 of the float32 solve); ``MPCConfig.rti``
    VTOL2D N=30 (M=120) for one robot, 5 warm-started steps, ms a step
    beside the 50 ms period.

20. B3's DynamicBicycle2D and DriftingCar instantiations (unit cost weights:
    neither model has MPC weights in either package): each one's build
    report, each against its plain version at N=10 on
    ``entry.build_fused_step``'s starts at B=256 (cold and warm) and
    B=4096, bit-identical (gated); at B=4096 the launch time, operation
    count, bound and share.
21. The Monte Carlo DPCBF sweep at ``examples/monte_carlo_sweep.py``'s
    defaults (1024 scenarios, 400 steps, 8 moving obstacles, the CBF-QP at
    400 iterations) through ``parallel.monte_carlo``: one B2 launch a step
    (gated), the success and collision rates, the spread of min h (each
    scenario's least clearance), scenarios/s, ms a step and B2's share, the
    first 64 scenarios' first 20 controls against B2's plain version.
22. MPCC (``solvers/mpcc.py``, N=30, M=90, the general AL-GN solve): one
    float64 solve at a 3x2 budget on the card and on the CPU (|du| <= 1e-6)
    and one float32 solve at the full 12x4 budget, eager, timed.
23. The drift scenario of ``tests/drift_scenario_common.py`` (gatekeeper,
    lane-change backup, two moving cars, 160 steps) through
    ``sim.drift_sim.DriftingCarSimulator``'s captured CUDA graph: no
    collision and x_final[0] > 40; capture seconds, ms a replayed step, an
    eager step, the graph's node count; the first replayed step against an
    eager step (within 1e-6); then 20 replayed steps of the backup-CBF
    configuration (finite, no collision).

Phase 12's general-solve chains (``CHAIN_GENERAL``) and phase 19d's RTI
steps (``RTI_STEPS``) run at a cut depth, 2 each, to leave room for these.

Every time is printed beside the card's name and power limit, and each
phase's wall seconds from phase 13 on.  Prints one JSON line of per-kernel
numbers (with each kernel's bound and launches a step), then, as the last
line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device and
when any check fails.
"""

from __future__ import annotations

import json
import logging
import re
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
BATCH = 4096
STEPS = 5
U_TOL = 5e-3  # kernel-class envelope: same algorithm, other op order
VIOL_TOL = 1e-3
N_GENERAL = 64  # problems checked against the general solve
QP_X_TOL = 1e-3  # QP kernel vs its plain version at the main path's shapes
QP_WIDE_TOL = 2e-3  # at m=153, and against the general solve_qp (JAX's envelope)
QP_U_TOL = 1e-3  # CBF-QP path: first 64 robots vs the plain version
CHAIN = 25  # warm-started B=1 solves timed for the single-robot latency
CHAIN_GENERAL = 2  # the same through the general solve (host-bound, seconds a solve)
RTI_STEPS = 2  # phase 19d's warm-started VTOL2D N=30 RTI steps (the general solve)
FLEET = 4096  # robots of the tracking fleet (phase 15)
FLEET_DI_STEPS = 2000  # the DI scenario's 100 s at dt 0.05
FLEET_DU_STEPS = 50
REPLAY = {"cbf_qp": 20, "mpc_cbf": 5}  # fleet steps replayed with the plain version
PASS_TOL = 0.35  # every waypoint passed this close (tests/test_tracking_e2e.py)
# The dynamic-obstacle scenario of tests/test_dynamic_env_e2e.py: 8 obstacles
# moving at (-0.5, +-0.5), bouncing in y within [0, 15].
DYN_BASE = [[8.0, 9.0, 0.5], [10.0, 4.0, 0.5], [12.0, 5.0, 0.5], [14.0, 9.0, 0.5],
            [16.0, 6.0, 0.5], [18.0, 14.0, 0.5], [20.0, 4.0, 0.5], [22.0, 12.0, 0.5]]
DYN_VELS = [[-0.5, 0.5] if i % 2 == 0 else [-0.5, -0.5] for i in range(8)]
DYN_WAYPOINTS = [[1.0, 7.5], [20.0, 7.5]]
DYN_STEPS = 800
# Manipulator2D's CBF-QP: three circles its links reach, two dummy slots.
ARM_OBSTACLES = [[1.6, 1.2, 0.3, 0, 0, 0, 0], [0.4, 1.9, 0.3, 0, 0, 0, 0],
                 [-1.0, 1.5, 0.4, 0, 0, 0, 0]]
# The scenario of tests/test_tracking_e2e.py (examples/test_tracking.py).
WAYPOINTS = [[2, 2, 1.5707963267948966], [2, 12, 0], [12, 12, 0], [12, 2, 0]]
KNOWN_OBS = [
    [2.2, 5.0, 0.2], [3.0, 5.0, 0.2], [4.0, 9.0, 0.3], [1.5, 10.0, 0.5], [9.0, 11.0, 1.0],
    [7.0, 7.0, 3.0], [4.0, 3.5, 1.5], [10.0, 7.3, 0.4], [6.0, 13.0, 0.7], [5.0, 10.0, 0.6],
    [11.0, 5.0, 0.8], [13.5, 11.0, 0.6], [2.0, 7.0, 0.7], [2.0, 8.0, 0.5],
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str, keep=None) -> str:
    """One entry per compiled kernel: registers, stack frame and spills;
    ``keep``: only the kernels of these names (with template arguments, as
    ``qp_admm_kernel<2,8,1>``)."""
    out, name, stack = [], "", ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            # the last "<name>_kernel" of the mangled name, and its int template arguments
            found = re.findall(r"([a-z]+(?:_[a-z]+)*_kernel)(I(?:Li\d+E)+E)?", ln.split("'")[1])
            if found:
                args = re.findall(r"Li(\d+)E", found[-1][1])
                name = found[-1][0] + (f"<{','.join(args)}>" if args else "")
            else:
                name = ln.split("'")[1]
        elif "bytes stack frame" in ln:
            stack = ln.strip()
        elif "Used" in ln and "registers" in ln and (keep is None or name in keep):
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {stack}")
    return " | ".join(out)


def fused_ptxas(report: str) -> str:
    """Registers, stack and spills of each model instantiation of the fused
    kernel (the model is the mangled template argument)."""
    out, model, frame = [], "", ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"IN9mpc_fused(\d+)", ln)
            model = ln[found.end():found.end() + int(found.group(1))] if found else "?"
        elif "bytes stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append((model, ln.split("Used")[1].split(",")[0].strip(), frame))
    return out


def max_where(t, mask) -> float:
    """max of ``t`` over ``mask`` (inf when the mask is empty: a failed gate)."""
    return t[mask].max().item() if bool(mask.any()) else float("inf")


def sync_time(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class ActiveRows(torch.overrides.TorchFunctionMode):
    """Counts the constraint rows that enter H in a plain version's Newton
    steps: the true entries of its comparisons ``act > 0.0`` of activations
    that ``match`` picks (B1's plain version tests one row at a time, B3's
    all rows at once)."""

    def __init__(self, match):
        super().__init__()
        self.match, self.calls, self.counts = match, 0, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in (torch.Tensor.gt, torch.Tensor.__gt__) and len(args) == 2
                and isinstance(args[1], float) and args[1] == 0.0 and self.match(args[0])):
            self.calls += 1
            self.counts.append(out.sum())
        return out

    def total(self) -> int:
        return int(torch.stack(self.counts).sum()) if self.counts else 0


# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, at
# 700 W): float32 outside the tensor cores, and HBM3.  Operations count each
# add, subtract, multiply, divide, square root, floor, sine, cosine and power
# once; comparisons, min/max, abs and negation are free.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# Operations of one Quad3D RK4 step (mpc_fused_models.h::Quad3D::step): the
# allocation 28, four derivatives 8, three stage states 72, the update 84,
# three angle wraps 15.
QUAD3D_STEP_OPS = 207
# (step, barrier value) operations of the six models that came later, from
# csrc/mpc_fused_models.h the same way (an angle wrap 5): Unicycle2D's
# Euler step 15; the bicycles' 25 (the clip free); Quad2D's 31;
# Manipulator2D's 6 and its constant position 2 + a circle 6; C3BF's
# collision cone 29, DPCBF's parabola 42 (atan2, sin, cos, three square
# roots, one division and the rest).
NEW_B3_OPS = {
    "Unicycle2D": (15, 6), "KinematicBicycle2D": (25, 6), "KinematicBicycle2D_C3BF": (25, 29),
    "KinematicBicycle2D_DPCBF": (25, 42), "Quad2D": (31, 6), "Manipulator2D": (6, 8),
}
# The drift models (mpc_fused_models.h): DynamicBicycle2D's step 104 (the
# slip angles 13, the drive force 3, each axle's Fiala force 24 with tan,
# atan, the square root and two reciprocals, the rates 25 with their six
# sines and cosines, the Euler update 10; the clamp free) and its barrier
# at a constant position 2 + a circle 6; DriftingCar's step 120 (the body's
# and the pose's 16) and a circle 6.
DRIFT_B3_OPS = {"DynamicBicycle2D": (104, 8), "DriftingCar": (120, 6)}


def bound(flops, nbytes):
    """(least milliseconds, "operations" or "bytes")."""
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cbf_qp_data(x, gl, ob):
    """The CBF-QPs (P, q, A, l, u) that one step of the CBF-QP path solves
    (DoubleIntegrator2D, 'cbf' mode) at states ``x``, goals ``gl``, obstacles
    ``ob``."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import DOUBLE_INTEGRATOR_2D, make_spec
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import cbf_qp

    spec = make_spec(DOUBLE_INTEGRATOR_2D)
    di = get_model(DOUBLE_INTEGRATOR_2D)
    u_ref = di.nominal_input(x, gl, spec)
    return cbf_qp._assemble(di, DOUBLE_INTEGRATOR_2D, spec, x, u_ref, ob, entry.DT, "cbf")[:5]


def wide_qps(dev, batch=256, n=3, m=153):
    """Feasible-by-construction random QPs at the Manipulator2D scale: the
    bounds bracket A x_star, and 100 of the 153 rows are one-sided
    (CBF-style).  From ``np.random.default_rng(7)``."""
    import numpy as np

    rng = np.random.default_rng(7)
    M = rng.normal(size=(batch, n, n))
    x_star = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n))
    Ax = np.einsum("bmn,bn->bm", A, x_star)
    lo = Ax - rng.uniform(0.05, 1.5, size=(batch, m))
    hi = Ax + rng.uniform(0.05, 1.5, size=(batch, m))
    hi[:, :100] = np.inf
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in
            (M @ M.transpose(0, 2, 1) + np.eye(n), rng.normal(size=(batch, n)), A, lo, hi)]


def b1_flops(obs, active_rows):
    """Operations of B1's solve on these problems, counted from its code
    (N=8, K=5, M=16, 8x3 budget), with H as its lower triangle and the
    rho Jc'Jc update only for the ``active_rows`` the Newton steps met."""
    N, K, M, NR, NC, steps = 8, 5, 16, 48, 56, 24
    circles = int((obs[..., 6] < 0.5).sum())
    supers = obs.shape[0] * K - circles
    hv = (6 * circles + 14 * supers) / obs.shape[0]  # barrier values, per problem
    hg = (2 * circles + 16 * supers) / obs.shape[0]  # their position gradients
    # per stage: dynamics 25, state rows 8, v rows 2, CBF rows 8 each
    values = hv + N * (25 + 8 + 2 + 2 * hv + 8 * K) + 2 * M
    # tangents: TX, TY, TX2, TY2 (5 a column each) and the CBF Jacobian rows
    tangents = N * (326 + 2 * hg + 224 * K)
    tri = M * (M + 1) // 2
    newton = (values + tangents + (NR - M) * (2 + 4 * M + 2 * tri) + M * 2
              + NC * (5 + 3 * M)                  # activations, rs, grad
              + 48 + 34 + M + 3 * tri + 4 * M     # input-move grad, damping, Hf
              + sum(i * (i + 1) for i in range(M)) + tri   # Cholesky
              + 2 * (M * M)                       # the two substitutions
              + M * (2 * M - 1) + 4 * M + 6       # predicted decrease
              + 6 * (values + 4 * NR + 7 * NC + 3) + 12 * M + 2 * M)  # line search, update
    per_problem = (values + tangents + NC * 34 + steps * newton + 8 * (values + 3 * NC)
                   + values + NC)
    return obs.shape[0] * per_problem + active_rows * (M + 2 * tri)


def b2_flops(B, n, m, iters, stages=8):
    """Operations of B2's staged ADMM on B problems, counted from its code."""
    tri = n * (n + 1) // 2
    sweep = 5 * n + 2 * n * n + m * (4 * n + 9)
    stage = 3 * tri + n + sum(i * (i + 1) for i in range(n)) + n * n + m * 4 * n + 3
    return B * (iters * sweep + stages * stage + m * 2 * tri)


def b3_flops(B, n, m, N, K, NC, step_ops, active_rows, h_ops=6, rel_deg=1):
    """Operations of B3's solve for a model of ``step_ops`` operations a
    ``step`` and ``h_ops`` a barrier value (6: a circle), from its code.  A
    dual-number operation is counted as two (a value and a tangent: the
    Quad3D step multiplies duals by constants only).  Relative degree 2
    adds a step and K barrier values a stage, and 6 operations a CBF row."""
    M, NR, steps = N * m, N * (n + m), 24
    tri = M * (M + 1) // 2
    stage = rel_deg * (step_ops + K * h_ops) + 2 * n + (3 if rel_deg == 1 else 9) * K
    rollout = K * h_ops + N * (stage + 2 * (NC - N * K) // (2 * N)) + 2 * N * m
    newton = (M * (2 * rollout + NC) + 2 * M * (NR + NC) + 2 * tri * NR + 2 * M + 3 * tri
              + sum(i * (i + 1) for i in range(M)) + tri + 2 * M * M + 2 * M * M
              + 6 * (rollout + 4 * NR + 7 * NC) + 12 * M)
    per_problem = (M * 2 * rollout + NC * 2 * M + steps * newton
                   + 8 * (rollout + 3 * NC) + rollout + NC)
    return B * per_problem + active_rows * 2 * tri


def passes_waypoints(path):
    """``(passed, distances)``: whether the path ``(T, >=2)`` (numpy) passes
    within PASS_TOL of every waypoint after the first, and its least
    distance to each."""
    import numpy as np

    wps = np.asarray(WAYPOINTS)[1:, :2]
    d = np.linalg.norm(path[:, None, :2] - wps[None], axis=-1).min(0)
    return bool((d < PASS_TOL).all()), d


class LogRecords(logging.Handler):
    """Collects the records of a logger (the fused-fallback warnings)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def single_robot(dev, card, phase, robot_spec, pos_controller, x0, tf, counter):
    """Drive one robot through ``LocalTrackingController(device=dev)`` over
    the scenario until a terminal code or ``tf``; gate it, print it and
    return ``(steps, ms a control step)``."""
    import numpy as np

    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.sim.controller import LocalTrackingController
    from safe_control_tpu_torch.solvers import mpc_cbf

    t_phase = time.perf_counter()
    c = LocalTrackingController(x0, robot_spec, controller_type={"pos": pos_controller},
                                dt=0.05, device=dev)
    c.obs = np.hstack([np.asarray(KNOWN_OBS), np.zeros((len(KNOWN_OBS), 4))])
    c.set_waypoints(np.asarray(WAYPOINTS))
    log = LogRecords()
    logger = logging.getLogger("safe_control_tpu_torch.solvers")
    logger.addHandler(log)
    seen = len(mpc_cbf._FUSED_FALLBACK_SEEN)
    counter.LAUNCH_COUNT = 0
    rets, xs = [], [c.state.x[0]]
    t0 = time.perf_counter()
    try:
        for k in range(int(round(tf / c.dt))):
            if k == 1:  # the first step's first-use costs are not a control period
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            rets.append(c.control_step())
            xs.append(c.state.x[0])
            if rets[-1] in (tracking.RET_DONE, tracking.RET_INFEASIBLE):
                break
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(log)
    ms = (time.perf_counter() - t0) / max(len(rets) - 1, 1) * 1e3
    launches = counter.LAUNCH_COUNT
    passed, dmin = passes_waypoints(torch.stack(xs).cpu().numpy())
    fallbacks = len(log.records) + len(mpc_cbf._FUSED_FALLBACK_SEEN) - seen
    name = robot_spec["model"]
    print(f"phase {phase} [{card}] single robot, {name} {pos_controller} through "
          f"LocalTrackingController(device='cuda'): {len(rets)} control steps, last code "
          f"{rets[-1]}, {rets.count(tracking.RET_INFEASIBLE)} infeasible, kernel launches "
          f"{launches}, fused fallbacks logged {fallbacks}, least distance to waypoints 2-4 "
          + ", ".join(f"{d:.3f}" for d in dmin)
          + f" m; {ms:.3f} ms a control step (host clock) against the 50 ms period; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if not (rets[-1] == tracking.RET_DONE and tracking.RET_INFEASIBLE not in rets and passed
            and launches == len(rets) and fallbacks == 0):
        raise SystemExit(f"phase {phase} failed: the {name} {pos_controller} scenario did not "
                         f"complete cleanly through the kernel")
    return len(rets), ms


def replay(cfg, spec, st0, traj, args_at, qp, per_robot_obs=False):
    """A fleet run's first steps again, one at a time, from ``st0``:
    ``tracking.step(cfg, spec, state, *args_at(i))`` for step i.  Returns the
    kernel's ms a step (CUDA events around B2's or B3's launch), whether the
    states equal the run's ``traj``, and for the first N_GENERAL robots each
    step's max |du| against the same step with the kernel's plain version
    bound in its place (``per_robot_obs``: the obstacles, the third
    argument, are per robot and are cut to those robots too)."""
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    counter = qpk if qp else mf
    k, n_replay = N_GENERAL, REPLAY["cbf_qp" if qp else "mpc_cbf"]
    timed_name = "_sweep_cuda" if qp else "solve_fused_batch"
    launch = getattr(counter, timed_name)
    events = []

    def timed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    states, st, same_x = [], st0, True
    setattr(counter, timed_name, timed)
    try:
        for i in range(n_replay):
            states.append(type(st)(*(torch.utils._pytree.tree_map(lambda t: t[:k], tuple(st)))))
            st = tracking.step(cfg, spec, st, *args_at(i)).state
            same_x = same_x and torch.equal(st.x, traj["x"][:, i])
        torch.cuda.synchronize()
    finally:
        setattr(counter, timed_name, launch)
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events) / len(events)

    plain_name = "solve_qp_batch" if qp else "solve_fused_batch"
    bound_fn = getattr(counter, plain_name)
    setattr(counter, plain_name, getattr(counter, plain_name + "_reference"))
    try:
        def cut(args):
            return (*args[:2], args[2][:k], *args[3:]) if per_robot_obs else args

        dev_plain = [(tracking.step(cfg, spec, sti, *cut(args_at(i))).u - traj["u"][:k, i])
                     .abs().max().item() for i, sti in enumerate(states)]
        torch.cuda.synchronize()
    finally:
        setattr(counter, plain_name, bound_fn)
    return kernel_ms, same_x, dev_plain


def fleet(dev, card, pos_controller, n_steps):
    """Phase 15: ``tracking.run`` over a fleet of FLEET robots; gated and
    printed.  Returns ``(launches, ms a step, kernel ms a step)``."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import (
        DOUBLE_INTEGRATOR_2D,
        DYNAMIC_UNICYCLE_2D,
        make_spec,
    )
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    qp = pos_controller == "cbf_qp"
    if qp:
        name, spec = DOUBLE_INTEGRATOR_2D, make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.0, a_max=1.5,
                                                     radius=0.25)
    else:
        name, spec = DYNAMIC_UNICYCLE_2D, make_spec(DYNAMIC_UNICYCLE_2D, w_max=0.5, a_max=1.0,
                                                    radius=0.25)
    cfg = tracking.TrackerConfig(
        model_name=name, pos_controller=pos_controller, dt=0.05,
        mpc=mpc_cbf.MPCConfig(horizon=8, num_obs=5, use_fused_kernel=True))
    rng = np.random.default_rng(0)
    x0 = np.zeros((FLEET, 4))
    x0[:, :2] = 2.0
    x0[1:, :2] += rng.uniform(-0.1, 0.1, (FLEET - 1, 2))
    if not qp:
        x0[:, 2] = np.pi / 2
    st0 = tracking.init_state(cfg, spec, torch.as_tensor(x0, dtype=torch.float32, device=dev),
                              np.pi / 2, first_goal=WAYPOINTS[0][:2])
    wps = torch.tensor(WAYPOINTS, dtype=torch.float32, device=dev)
    known = pad_obstacles(KNOWN_OBS, 16, device=dev)
    args = (wps, len(WAYPOINTS), known)
    counter = qpk if qp else mf
    tracking.step(cfg, spec, st0, *args)  # warm-up: first use of every op
    torch.cuda.synchronize()

    counter.LAUNCH_COUNT = 0
    t0 = time.perf_counter()
    final, traj = tracking.run(cfg, spec, st0, *args, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.LAUNCH_COUNT
    step_ms = wall / n_steps * 1e3

    k = N_GENERAL
    kernel_ms, same_x, dev_plain = replay(cfg, spec, st0, traj, lambda i: args, qp)

    ret = final.ret
    done = (ret == tracking.RET_DONE).float().mean().item()
    infeasible = (ret == tracking.RET_INFEASIBLE).float().mean().item()
    rets0 = traj["ret"][0].cpu().numpy()
    path0 = torch.cat([st0.x[:1], traj["x"][0]]).cpu().numpy()
    passed0, dmin0 = passes_waypoints(path0)
    robot0_ok = bool(rets0[-1] == tracking.RET_DONE and not (rets0 == tracking.RET_INFEASIBLE).any()
                     and passed0)
    tol = QP_U_TOL if qp else U_TOL
    label = f"{name} {pos_controller}" + ("" if qp else " through the fused kernel")
    bound_note = ""
    if qp:  # B2 at this path's shape: n=2, m = the constraint slots + the input box
        qn, qm = 2, cfg.num_obs + 2
        b2_bound, b2_by = bound(b2_flops(FLEET, qn, qm, cfg.qp_iters),
                                FLEET * (qn * qn + 2 * qn + qm * qn + 4 * qm) * 4)
        bound_note = (f" (n={qn}, m={qm}: bound {b2_bound:.4f} ms by {b2_by}, "
                      f"{100 * b2_bound / kernel_ms:.2f}% of it reached)")
    print(f"phase 15 [{card}] fleet, {label}: tracking.run of {n_steps} steps at B={FLEET}, "
          f"kernel launches {launches}; {FLEET * n_steps / wall:.1f} robot-steps/s, "
          f"{step_ms:.3f} ms a step, the kernel {kernel_ms:.4f} ms a step{bound_note} "
          f"({100 * kernel_ms / step_ms:.1f}% of the step); at the end {100 * done:.2f}% of the "
          f"robots RET_DONE and {100 * infeasible:.2f}% RET_INFEASIBLE; robot 0 last code "
          f"{rets0[-1]}, least distance to waypoints 2-4 " + ", ".join(f"{d:.3f}" for d in dmin0)
          + f" m; replayed states equal the run's {same_x}; per-step max|du| of {k} robots "
          f"against the plain version: " + ", ".join(f"{d:.3e}" for d in dev_plain)
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if launches != n_steps:
        raise SystemExit(f"phase 15 failed: {launches} kernel launches in {n_steps} steps")
    if qp and not robot0_ok:
        raise SystemExit("phase 15 failed: robot 0 of the fleet did not complete the scenario")
    if not same_x or max(dev_plain) >= tol:
        raise SystemExit(f"phase 15 failed: the {label} fleet disagrees with the plain version")
    return launches, step_ms, kernel_ms


class UnitWeights:
    """The JAX package, and so the port, has no MPC cost weights for
    Manipulator2D, DynamicBicycle2D or DriftingCar (their MPC raises
    KeyError).  Within this context unit weights stand in, so that the
    fused kernel's instantiations of them can be held to their plain
    versions."""

    UNIT = {"Manipulator2D": ([1.0] * 3, [0.5] * 3), "DynamicBicycle2D": ([1.0] * 5, [0.5] * 2),
            "DriftingCar": ([1.0] * 8, [0.5] * 2)}

    def __enter__(self):
        from safe_control_tpu_torch.solvers import mpc_cbf

        self.weights = mpc_cbf._WEIGHTS
        self.weights.update(self.UNIT)

    def __exit__(self, *exc):
        for name in self.UNIT:
            del self.weights[name]


def b3_pair(label, model, sp, args, cf, errs, active=None, bits=None):
    """B3 against its plain version on ``args``: gated in the kernel
    envelope, printed, the largest difference appended to ``errs`` (and
    whether the bits agree to ``bits``, when given); the plain version's
    activation tests counted by ``active`` when given.  Returns the
    kernel's result."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    kern = mf.solve_fused_batch(model, sp, *args, entry.DT, cf)
    torch.cuda.synchronize()
    if active is None:
        plain = mf.solve_fused_batch_reference(model, sp, *args, entry.DT, cf)
    else:
        with active:
            plain = mf.solve_fused_batch_reference(model, sp, *args, entry.DT, cf)
    torch.cuda.synchronize()
    du_ = (kern.U - plain.U).abs().max().item()
    dxs = (kern.xs - plain.xs).abs().max().item()
    dv = (kern.viol - plain.viol).abs().max().item()
    same = torch.equal(kern.U, plain.U) and torch.equal(kern.xs, plain.xs) and \
        torch.equal(kern.viol, plain.viol)
    errs.append(max(du_, dxs, dv))
    if bits is not None:
        bits.append(same)
    print(f"phase {label} fused kernel vs plain ({model} N={cf.horizon}, B={args[0].shape[0]}): "
          f"max|du| {du_:.3e}, max|dxs| {dxs:.3e}, max|dviol| {dv:.3e}, bit-identical {same}, "
          f"finite {bool(torch.isfinite(kern.U).all())}, "
          f"{int((kern.viol > VIOL_TOL).sum())} with viol > {VIOL_TOL}")
    if not (du_ < U_TOL and dxs < U_TOL and dv <= VIOL_TOL and bool(torch.isfinite(kern.U).all())):
        raise SystemExit(f"phase {label} failed: fused kernel disagrees with its plain version")
    return kern


def new_b3_models(dev, card, b3_report):
    """Phase 16: B3's six later instantiations.  Returns the JSON shapes."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    t_phase = time.perf_counter()
    for model in NEW_B3_OPS:
        print(f"phase 16 build [{card}] {b3_report[model]}")
    errs, shapes = [], []
    cf = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    with UnitWeights():
        for model, (step_ops, h_ops) in NEW_B3_OPS.items():
            sp = make_spec(model)
            fstep, args = entry.build_fused_step(256, model_name=model, horizon=10, device=dev)
            b3_pair("16 (cold)", model, sp, args, cf, errs)
            x1, u1, U1 = fstep(*args)
            b3_pair("16 (warm)", model, sp, (x1, args[1], args[2], u1, U1), cf, errs)
            # at B=4096: the launch, its operations (active rows from the
            # plain version's tests on the same inputs), bound and share
            big = entry.build_fused_step(BATCH, model_name=model, horizon=10, device=dev)[1]
            nc = mpc_cbf._num_constraints(get_model(model), cf)
            active = ActiveRows(lambda t, nc=nc: t.dim() == 2 and t.shape[-1] == nc)
            with active:
                mf.solve_fused_batch_reference(model, sp, *big, entry.DT, cf)
            run = lambda: mf.solve_fused_batch(model, sp, *big, entry.DT, cf)
            run()
            ms = sync_time(run, 3)
            mdl = get_model(model)
            n, m, M = mdl.N_STATES, mdl.N_CONTROLS, 10 * mdl.N_CONTROLS
            ops = b3_flops(BATCH, n, m, 10, 5, nc, step_ops, active.total(), h_ops, mdl.REL_DEG)
            bnd, by = bound(ops, BATCH * (2 * n + 35 + m + 2 * M + 11 * n + 1) * 4)
            print(f"phase 16 [{card}] {model} N=10 B={BATCH}: fused kernel {ms:.4f} ms a launch, "
                  f"{ops:.4e} operations ({active.total()} active constraint rows), bound "
                  f"{bnd:.4f} ms by {by}, {100 * bnd / ms:.2f}% of it reached")
            shapes.append({"shape": f"{model} N=10 B={BATCH}", "ms": ms, "bound_ms": bnd,
                           "bound_by": by, "max_abs_err": max(errs[-2:])})
    # the DPCBF fused path: five warm-started solve_dispatch steps at B=4096
    model = "KinematicBicycle2D_DPCBF"
    fstep, args = entry.build_fused_step(BATCH, model_name=model, horizon=10, device=dev)
    log = LogRecords()
    logger = logging.getLogger("safe_control_tpu_torch.solvers")
    logger.addHandler(log)
    seen = len(mpc_cbf._FUSED_FALLBACK_SEEN)
    mf.LAUNCH_COUNT = 0
    x, up, U = args[0], args[3], args[4]
    t0 = time.perf_counter()
    try:
        for _ in range(STEPS):
            x, up, U = fstep(x, args[1], args[2], up, U)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(log)
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    launches = mf.LAUNCH_COUNT
    fallbacks = len(log.records) + len(mpc_cbf._FUSED_FALLBACK_SEEN) - seen
    finite = all(bool(torch.isfinite(t).all()) for t in (x, up, U))
    print(f"phase 16 [{card}] {model} fused path: {STEPS} warm-started solve_dispatch steps at "
          f"B={BATCH}, fused kernel launches {launches}, fallbacks logged {fallbacks}, finite "
          f"{finite}, {step_ms:.3f} ms a step (host clock); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if launches != STEPS or fallbacks or not finite:
        raise SystemExit("phase 16 failed: the DPCBF fused path did not run through the kernel")
    return shapes, max(errs), launches


def dynamic_env(dev, card):
    """Phase 17: the dynamic-obstacle scenario (tests/test_dynamic_env_e2e.py)
    through the CBF-QP and B2: one robot of each barrier, then a DPCBF fleet.
    Returns (fleet launches, ms a step, B2 ms a step, max |du| to the plain
    version)."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    moving = pad_obstacles(np.hstack([DYN_BASE, DYN_VELS, np.zeros((8, 2))]), 8, device=dev)
    wps = torch.tensor(DYN_WAYPOINTS, dtype=torch.float32, device=dev)
    y_range = (0.0, 15.0)
    for model in ("KinematicBicycle2D_DPCBF", "KinematicBicycle2D_C3BF"):
        spec = make_spec(model, a_max=5.0, radius=0.3)
        cfg = tracking.TrackerConfig(model_name=model, pos_controller="cbf_qp", dt=0.05,
                                     num_obs=8)
        st = tracking.init_state(cfg, spec, torch.tensor([[1.0, 7.5, 0.0, 1.0]], device=dev),
                                 0.0, first_goal=DYN_WAYPOINTS[0])
        qpk.LAUNCH_COUNT = 0
        t0 = time.perf_counter()
        final, _, traj = tracking.run_dynamic(cfg, spec, st, wps, 2, moving, DYN_STEPS,
                                              y_range=y_range)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DYN_STEPS * 1e3
        rets = traj["ret"][0].cpu().numpy()
        done = np.flatnonzero(rets == tracking.RET_DONE)
        ok = (int(final.ret[0]) == tracking.RET_DONE
              and not (rets == tracking.RET_INFEASIBLE).any()
              and qpk.LAUNCH_COUNT == DYN_STEPS)
        print(f"phase 17 [{card}] single robot, {model} cbf_qp among 8 moving obstacles, "
              f"tracking.run_dynamic of {DYN_STEPS} steps: QP kernel launches {qpk.LAUNCH_COUNT}, "
              f"last code {int(final.ret[0])}, {int((rets == tracking.RET_INFEASIBLE).sum())} "
              f"infeasible, RET_DONE first at step {done[0] if len(done) else None}; "
              f"{ms:.3f} ms a step (host clock) against the 50 ms period")
        if not ok:
            raise SystemExit(f"phase 17 failed: the {model} dynamic-obstacle scenario")

    # the DPCBF fleet: robot 0 at the start, the others within +-0.1 m
    model = "KinematicBicycle2D_DPCBF"
    spec = make_spec(model, a_max=5.0, radius=0.3)
    cfg = tracking.TrackerConfig(model_name=model, pos_controller="cbf_qp", dt=0.05, num_obs=8)
    rng = np.random.default_rng(0)
    x0 = np.tile([1.0, 7.5, 0.0, 1.0], (FLEET, 1))
    x0[1:, :2] += rng.uniform(-0.1, 0.1, (FLEET - 1, 2))
    st0 = tracking.init_state(cfg, spec, torch.as_tensor(x0, dtype=torch.float32, device=dev),
                              0.0, first_goal=DYN_WAYPOINTS[0])
    tracking.step(cfg, spec, st0, wps, 2, moving)  # warm-up
    torch.cuda.synchronize()
    qpk.LAUNCH_COUNT = 0
    t0 = time.perf_counter()
    final, _, traj = tracking.run_dynamic(cfg, spec, st0, wps, 2, moving, DYN_STEPS,
                                          y_range=y_range)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qpk.LAUNCH_COUNT
    # the first steps again: each starts from the obstacles the run saw
    obs_seq = [moving]
    for _ in range(REPLAY["cbf_qp"]):
        obs_seq.append(tracking.step_dynamic_obstacles(obs_seq[-1], cfg.dt, None, y_range))
    k = N_GENERAL
    kernel_ms, same_x, dev_plain = replay(cfg, spec, st0, traj,
                                          lambda i: (wps, 2, obs_seq[i]), True)
    rets0 = traj["ret"][0].cpu().numpy()
    robot0_ok = bool(rets0[-1] == tracking.RET_DONE
                     and not (rets0 == tracking.RET_INFEASIBLE).any())
    done = (final.ret == tracking.RET_DONE).float().mean().item()
    infeasible = (final.ret == tracking.RET_INFEASIBLE).float().mean().item()
    step_ms = wall / DYN_STEPS * 1e3
    qn, qm = 2, cfg.num_obs + 2  # B2 at this path's shape
    b2_bound, b2_by = bound(b2_flops(FLEET, qn, qm, cfg.qp_iters),
                            FLEET * (qn * qn + 2 * qn + qm * qn + 4 * qm) * 4)
    print(f"phase 17 [{card}] fleet, {model} cbf_qp among 8 moving obstacles: "
          f"tracking.run_dynamic of {DYN_STEPS} steps at B={FLEET}, QP kernel launches "
          f"{launches}; {FLEET * DYN_STEPS / wall:.1f} robot-steps/s, {step_ms:.3f} ms a step, "
          f"B2 {kernel_ms:.4f} ms a step (n={qn}, m={qm}: bound {b2_bound:.4f} ms by {b2_by}, "
          f"{100 * b2_bound / kernel_ms:.2f}% of it reached; {100 * kernel_ms / step_ms:.1f}% "
          f"of the step); at the "
          f"end {100 * done:.2f}% of the robots RET_DONE and {100 * infeasible:.2f}% "
          f"RET_INFEASIBLE; robot 0 last code {rets0[-1]}; replayed states equal the run's "
          f"{same_x}; per-step max|du| of {k} robots against the plain version: "
          + ", ".join(f"{d:.3e}" for d in dev_plain)
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if launches != DYN_STEPS or not robot0_ok:
        raise SystemExit("phase 17 failed: the DPCBF fleet did not run the scenario cleanly")
    if not same_x or max(dev_plain) >= QP_U_TOL:
        raise SystemExit("phase 17 failed: the DPCBF fleet disagrees with the plain version")
    return launches, step_ms, kernel_ms, max(dev_plain)


def manipulator_cbf_qp(dev, card):
    """Phase 18: the Manipulator2D CBF-QP (n=3, m=118) through B2 at B=4096.
    Returns the JSON shape."""
    import numpy as np

    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import cbf_qp, qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    name = "Manipulator2D"
    spec, model = make_spec(name), get_model(name)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.2, 1.2, (BATCH, 3)), dtype=torch.float32, device=dev)
    u_ref = torch.as_tensor(rng.uniform(-2.0, 2.0, (BATCH, 3)), dtype=torch.float32, device=dev)
    obs = pad_obstacles(ARM_OBSTACLES, 5, device=dev)[None].repeat(BATCH, 1, 1)
    qpk.LAUNCH_COUNT = 0
    kern = cbf_qp.solve_batch(name, spec, x, u_ref, obs, entry.DT, backend="pallas")
    torch.cuda.synchronize()
    launches = qpk.LAUNCH_COUNT
    data = cbf_qp._assemble(model, name, spec, x, u_ref, obs, entry.DT, "cbf")[:5]
    plain = qpk.solve_qp_batch_reference(*data)
    torch.cuda.synchronize()
    n, m = data[0].shape[-1], data[2].shape[-2]
    dx = (kern.u - plain.x).abs().max().item()
    feas_same = torch.equal(kern.feasible, plain.prim_res < 1e-3)
    same = torch.equal(kern.u, plain.x)
    scaled = qp.equilibrate(*data)
    run = lambda: qpk._sweep_cuda(*scaled[:5], 1600, 1.0, 1e-6, 1.6)
    run()
    ms = sync_time(run, 5)
    ops = b2_flops(BATCH, n, m, 1600)
    bnd, by = bound(ops, BATCH * (n * n + 2 * n + m * n + 4 * m) * 4)
    G, R = qpk.launch_shape(m)
    print(f"phase 18 [{card}] Manipulator2D CBF-QP through cbf_qp.solve_batch at B={BATCH} "
          f"(n={n}, m={m}: {G} lanes a problem, {R} register rows a lane): QP kernel launches "
          f"{launches}, vs plain max|dx| {dx:.3e}, feasible flags equal {feas_same} "
          f"({int(kern.feasible.sum())} feasible), bit-identical {same}; the launch {ms:.4f} ms, "
          f"{ops:.4e} operations (1600 iterations), bound {bnd:.4f} ms by {by}, "
          f"{100 * bnd / ms:.2f}% of it reached")
    if not (launches == 1 and dx < QP_WIDE_TOL and feas_same):
        raise SystemExit("phase 18 failed: the Manipulator2D CBF-QP disagrees with the plain version")
    return {"shape": f"Manipulator2D CBF-QP n={n} m={m} B={BATCH}", "ms": ms, "bound_ms": bnd,
            "bound_by": by, "max_abs_err": dx}


def mpc_variants(dev, card):
    """Phase 19: optimal decay, the KKT polish, newton_f64 and MPCConfig.rti
    on the card (the general solve: no kernel takes them)."""
    import os

    import numpy as np

    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.solvers import mpc_cbf

    t_phase = time.perf_counter()
    du_name = "DynamicUnicycle2D"
    du_spec = make_spec(du_name, a_max=1.0, w_max=0.5)
    # (a) the optimal-decay tight scene (tests/test_optimal_decay.py), B=64
    b = 64
    ins = (torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev).repeat(b, 1),
           torch.tensor([[4.0, 0.0, 0.0, 0.0]], device=dev).repeat(b, 1),
           pad_obstacles([[1.2, 0.0, 0.5, 0, 0, 0, 0]], 5, device=dev)[None].repeat(b, 1, 1),
           torch.zeros((b, 2), device=dev))
    plain_cfg = mpc_cbf.MPCConfig(horizon=8, num_obs=5)
    od_cfg = plain_cfg._replace(optimal_decay=True)
    r_plain = mpc_cbf.solve(du_name, du_spec, *ins,
                            mpc_cbf.init_state(du_name, plain_cfg, b, device=dev), entry.DT,
                            plain_cfg)
    t0 = time.perf_counter()
    r_od = mpc_cbf.solve(du_name, du_spec, *ins, mpc_cbf.init_state(du_name, od_cfg, b, device=dev),
                         entry.DT, od_cfg)
    torch.cuda.synchronize()
    od_ms = (time.perf_counter() - t0) * 1e3
    om = r_od.state.U[:, :, 2:].amax((1, 2))
    od_ok = bool(r_od.feasible.all() and (r_od.viol < 1e-3).all() and (om > 1.05).all()
                 and (r_od.u[:, 0] == -1.0).all() and (r_plain.viol > 0.1).all())
    print(f"phase 19a [{card}] optimal decay, the tight scene at B={b}: plain MPC viol "
          f"{r_plain.viol.min().item():.3f}..{r_plain.viol.max().item():.3f}; optimal-decay "
          f"feasible {int(r_od.feasible.sum())}/{b}, max viol {r_od.viol.max().item():.2e}, "
          f"least max omega {om.min().item():.3f}, u[0] {r_od.u[:, 0].unique().tolist()}; "
          f"{od_ms:.1f} ms a solve (host clock)")
    if not od_ok:
        raise SystemExit("phase 19a failed: the optimal-decay MPC missed the tight scene")

    # (b) the KKT polish at the accuracy budget, float64, on the c2 anchors
    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                "parity_goldens.npz"))
    acc = mpc_cbf.MPCConfig(horizon=8, num_obs=5, outer_iters=30, newton_iters=8,
                            polish_iters=3)
    f64 = dict(dtype=torch.float64, device=dev)
    xs = torch.as_tensor(data["c2_x"], **f64)
    nb = xs.shape[0]
    goal = torch.as_tensor(data["c2_goal"], **f64).expand(nb, -1)
    obs = pad_obstacles(data["c2_obs"], 5, **f64)[None].expand(nb, -1, -1)
    ups = torch.as_tensor(data["c2_uprev"], **f64)
    t0 = time.perf_counter()
    r_acc = mpc_cbf.solve(du_name, du_spec, xs, goal, obs, ups,
                          mpc_cbf.init_state(du_name, acc, nb, **f64), entry.DT, acc)
    torch.cuda.synchronize()
    pol_s = time.perf_counter() - t0
    dev_gold = np.abs(r_acc.u.cpu().numpy() - data["c2_gold"]).max()
    print(f"phase 19b [{card}] KKT polish (polish_iters=3, 30x8 budget, float64) on the {nb} c2 "
          f"anchors: max|u - golden| {dev_gold:.3e} (BASELINE criterion < 1e-3); "
          f"{pol_s:.2f} s for the batch")
    if not dev_gold < 1e-3:
        raise SystemExit("phase 19b failed: the polished solve misses the c2 goldens")

    # (c) newton_f64 on the main path's inputs at B=256, against the float32 solve
    _, args = entry.build_step(256, device=dev)
    base = mpc_cbf.MPCConfig(horizon=8, num_obs=5)
    st = mpc_cbf.init_state(du_name, base, 256, device=dev)._replace(U=args[4])
    r32 = mpc_cbf.solve(du_name, du_spec, *args[:4], st, entry.DT, base)
    t0 = time.perf_counter()
    r64 = mpc_cbf.solve(du_name, du_spec, *args[:4], st, entry.DT, base._replace(newton_f64=True))
    torch.cuda.synchronize()
    nf_ms = (time.perf_counter() - t0) * 1e3
    per_du = (r64.state.U - r32.state.U).abs().amax((1, 2))
    within = int((per_du < U_TOL).sum())
    finite = bool(torch.isfinite(r64.state.U).all())
    print(f"phase 19c [{card}] newton_f64 on entry.build_step's inputs at B=256 against the "
          f"float32 solve: finite {finite}, {within}/256 within {U_TOL}, median|du| "
          f"{per_du.median().item():.3e}, max|du| {per_du.max().item():.3e}; {nf_ms:.1f} ms a "
          f"solve (host clock)")
    if not (finite and within >= 0.95 * 256):
        raise SystemExit("phase 19c failed: newton_f64 left the float32 envelope")

    # (d) MPCConfig.rti, VTOL2D N=30 (M=120), one robot: the general solve
    vt = "VTOL2D"
    rti = mpc_cbf.MPCConfig.rti(horizon=30, num_obs=5)
    x = torch.tensor([[8.0, 38.0, 0.05, 12.0, 0.5, 0.0]], device=dev)
    gl = torch.tensor([[80.0, 40.0, 0, 0, 0, 0]], device=dev)
    ob = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5, device=dev)[None]
    st = mpc_cbf.init_state(vt, rti, 1, device=dev)
    up = torch.zeros((1, 4), device=dev)
    from safe_control_tpu_torch.dynamics import get_model

    vmodel, vspec = get_model(vt), make_spec(vt)
    times = []
    for _ in range(RTI_STEPS):
        t0 = time.perf_counter()
        res = mpc_cbf.solve_dispatch(vt, vspec, x, gl, ob, up, st, entry.DT, rti)
        x = vmodel.step(x, res.u, vspec, entry.DT)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        up, st = res.u, res.state
    rti_ok = bool(torch.isfinite(x).all())
    print(f"phase 19d [{card}] MPCConfig.rti (2x2), VTOL2D N=30 (M=120, the general solve), "
          f"one robot, {RTI_STEPS} warm-started steps: " + ", ".join(f"{t:.1f}" for t in times)
          + f" ms a step (host clock) against the 50 ms period, finite {rti_ok}; host-bound: "
          f"thousands of small launches a solve; phase {time.perf_counter() - t_phase:.1f} s")
    if not rti_ok:
        raise SystemExit("phase 19d failed: the RTI solve diverged")


# The drift scenario of tests/drift_scenario_common.py: a five-lane straight
# track, the ego car in lane 1 at 10 m/s, the backup lane 3, two obstacle
# cars moving ahead; the VehicleConfig of the reference's drift example.
DRIFT_DT = 0.05
DRIFT_LANE_W, DRIFT_LANES, DRIFT_TRACK = 4.0, 5, 300.0
DRIFT_EGO, DRIFT_MIDDLE, DRIFT_BACKUP = 1, 2, 3
DRIFT_TF = 8.0  # 160 steps
DRIFT_BACKUPCBF_STEPS = 20
SWEEP_BATCH, SWEEP_STEPS = 1024, 400  # examples/monte_carlo_sweep.py's defaults


def drift_spec():
    import math

    from safe_control_tpu_torch.core.spec import DRIFTING_CAR, make_spec

    return make_spec(
        DRIFTING_CAR, a_cg=1.4, b_cg=1.4, wheel_base=2.8, body_length=4.5, body_width=2.0,
        radius=1.2, mass=2500.0, izz=5000.0, cc_f=80000.0, cc_r=100000.0, mu=1.0, r_w=0.35,
        gamma_stab=0.95, delta_max=math.radians(20), delta_dot_max=math.radians(25),
        tau_max=4000.0, tau_dot_max=8000.0, v_max=20.0, v_min=0.0, r_max=2.0,
        beta_max=math.radians(45))


def drift_scene(dev):
    """(env, path, x0, backup lane y) of the drift scenario on ``dev``."""
    import numpy as np

    from safe_control_tpu_torch.envs.drifting_env import DriftingEnv
    from safe_control_tpu_torch.solvers import mpcc

    env = DriftingEnv("straight", track_width=DRIFT_LANE_W * DRIFT_LANES,
                      track_length=DRIFT_TRACK, num_lanes=DRIFT_LANES, device=dev)
    ego_y = env.get_lane_center(DRIFT_EGO)
    env.add_dynamic_obstacle_car(50.0, env.get_lane_center(DRIFT_MIDDLE), 0.0, 2.0, 0.0,
                                 radius=1.0)
    env.add_dynamic_obstacle_car(35.0, 4.0, 0.0, 0.75, 0.0, radius=1.0)
    sx = np.linspace(0.0, DRIFT_TRACK, 601)
    path = mpcc.make_path(sx, np.full_like(sx, ego_y), device=dev)
    x0 = np.array([1.0, ego_y, 0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    return env, path, x0, env.get_lane_center(DRIFT_BACKUP)


def drift_b3_models(dev, card, b3_report):
    """Phase 20: B3's DynamicBicycle2D and DriftingCar instantiations (unit
    cost weights) against their plain versions, bits printed and gated, and
    timed at B=4096.  Returns (JSON shapes, max difference, all bits equal)."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    t_phase = time.perf_counter()
    errs, bits, shapes = [], [], []
    cf = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    with UnitWeights():
        for model, (step_ops, h_ops) in DRIFT_B3_OPS.items():
            print(f"phase 20 build [{card}] {b3_report[model]}")
            sp = make_spec(model)
            fstep, args = entry.build_fused_step(256, model_name=model, horizon=10, device=dev)
            b3_pair("20 (cold)", model, sp, args, cf, errs, bits=bits)
            x1, u1, U1 = fstep(*args)
            b3_pair("20 (warm)", model, sp, (x1, args[1], args[2], u1, U1), cf, errs, bits=bits)
            big = entry.build_fused_step(BATCH, model_name=model, horizon=10, device=dev)[1]
            nc = mpc_cbf._num_constraints(get_model(model), cf)
            active = ActiveRows(lambda t, nc=nc: t.dim() == 2 and t.shape[-1] == nc)
            b3_pair("20 (B=4096)", model, sp, big, cf, errs, active=active, bits=bits)
            run = lambda: mf.solve_fused_batch(model, sp, *big, entry.DT, cf)
            ms = sync_time(run, 3)
            mdl = get_model(model)
            n, m, M = mdl.N_STATES, mdl.N_CONTROLS, 10 * mdl.N_CONTROLS
            ops = b3_flops(BATCH, n, m, 10, 5, nc, step_ops, active.total(), h_ops, mdl.REL_DEG)
            bnd, by = bound(ops, BATCH * (2 * n + 35 + m + 2 * M + 11 * n + 1) * 4)
            print(f"phase 20 [{card}] {model} N=10 B={BATCH}: fused kernel {ms:.4f} ms a launch, "
                  f"{ops:.4e} operations ({active.total()} active constraint rows), bound "
                  f"{bnd:.4f} ms by {by}, {100 * bnd / ms:.2f}% of it reached")
            shapes.append({"shape": f"{model} N=10 B={BATCH}", "ms": ms, "bound_ms": bnd,
                           "bound_by": by, "max_abs_err": max(errs[-3:]),
                           "bit_identical": all(bits[-3:])})
    print(f"phase 20 [{card}] the drift instantiations bit-identical to their plain versions "
          f"in every pair: {all(bits)}; phase {time.perf_counter() - t_phase:.1f} s")
    if not all(bits):
        raise SystemExit("phase 20 failed: a drift instantiation is not bit-identical to its "
                         "plain version")
    return shapes, max(errs), all(bits)


def monte_carlo_sweep(dev, card):
    """Phase 21: the Monte Carlo DPCBF sweep at examples/monte_carlo_sweep.py's
    defaults (B=1024 scenarios, 400 steps, 8 moving obstacles, the CBF-QP at
    400 iterations) through ``parallel.monte_carlo``: one B2 launch a step,
    the first 64 scenarios' first 20 controls within QP_U_TOL of the steps
    replayed with B2's plain version.  Returns (launches, ms a step, B2 ms a
    step, max |du|, the B2 bound, its kind)."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.parallel import monte_carlo as mc
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    model = "KinematicBicycle2D_DPCBF"
    spec = make_spec(model, a_max=5.0, radius=0.3)
    cfg = tracking.TrackerConfig(model_name=model, pos_controller="cbf_qp", dt=0.05, num_obs=8,
                                 qp_iters=400)
    wps = torch.tensor(DYN_WAYPOINTS, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    st0 = mc.dpcbf_sweep_init(cfg, spec, gen, SWEEP_BATCH, wps, device=dev)
    tracking.step(cfg, spec, st0.tracker, wps, 2, st0.obs)  # warm-up
    torch.cuda.synchronize()
    qpk.LAUNCH_COUNT = 0
    t0 = time.perf_counter()
    final, traj = mc.run_sweep_chunk(cfg, spec, st0, wps, 2, SWEEP_STEPS, with_trajectory=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qpk.LAUNCH_COUNT
    succ, coll = (float(v) for v in mc.sweep_stats(final))
    # min h: the least clearance |p - o| - (r_o + radius) of each scenario
    # over its steps and obstacles, from the stacked trajectory
    d = traj["x"][:, :, None, :2] - traj["obs_xy"]
    clear = torch.sqrt((d * d).sum(-1)) - (st0.obs[:, None, :, 2] + spec.radius)
    min_h = clear.amin(dim=(1, 2)).cpu().numpy()
    q = np.percentile(min_h, [0, 5, 50, 95, 100])
    obs_seq = [st0.obs]
    for _ in range(REPLAY["cbf_qp"]):
        obs_seq.append(tracking.step_dynamic_obstacles(obs_seq[-1], cfg.dt, y_range=(0.0, 15.0)))
    kernel_ms, same_x, dev_plain = replay(cfg, spec, st0.tracker, traj,
                                          lambda i: (wps, 2, obs_seq[i]), True,
                                          per_robot_obs=True)
    step_ms = wall / SWEEP_STEPS * 1e3
    qn, qm = 2, cfg.num_obs + 2
    b2_bound, b2_by = bound(b2_flops(SWEEP_BATCH, qn, qm, cfg.qp_iters),
                            SWEEP_BATCH * (qn * qn + 2 * qn + qm * qn + 4 * qm) * 4)
    print(f"phase 21 [{card}] Monte Carlo DPCBF sweep, {SWEEP_BATCH} scenarios x {SWEEP_STEPS} "
          f"steps (parallel.monte_carlo.run_sweep_chunk): QP kernel launches {launches} "
          f"({launches / SWEEP_STEPS:.3f} a step); success {100 * succ:.2f}%, collision "
          f"{100 * coll:.2f}%; min h (least clearance, m) min {q[0]:.4f}, p5 {q[1]:.4f}, "
          f"median {q[2]:.4f}, p95 {q[3]:.4f}, max {q[4]:.4f}; {SWEEP_BATCH / wall:.1f} "
          f"scenarios/s ({SWEEP_BATCH * SWEEP_STEPS / wall:.1f} scenario-steps/s), "
          f"{step_ms:.3f} ms a step, B2 {kernel_ms:.4f} ms a step (bound {b2_bound:.4f} ms by "
          f"{b2_by}, {100 * b2_bound / kernel_ms:.2f}% of it reached; "
          f"{100 * kernel_ms / step_ms:.1f}% of the step); replayed states equal the run's "
          f"{same_x}; per-step max|du| of {N_GENERAL} scenarios against the plain version: "
          + ", ".join(f"{v:.3e}" for v in dev_plain)
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if launches != SWEEP_STEPS:
        raise SystemExit("phase 21 failed: the sweep did not make one B2 launch a step")
    if not same_x or max(dev_plain) >= QP_U_TOL or not np.isfinite(min_h).all():
        raise SystemExit("phase 21 failed: the sweep disagrees with the plain version")
    return launches, step_ms, kernel_ms, max(dev_plain), b2_bound, b2_by


def mpcc_alone(dev, card):
    """Phase 22: MPCC on the drift scenario's start, horizon 30 (M=90): one
    float64 solve at a 3x2 budget on the card and on the CPU with the same
    inputs (|du| <= 1e-6), then one float32 solve at the full 12x4 budget,
    eager, timed."""
    from safe_control_tpu_torch.solvers import al_gn, mpcc

    t_phase = time.perf_counter()
    spec = drift_spec()
    _, path, x0, _ = drift_scene("cpu")
    x8 = torch.tensor(x0, dtype=torch.float64)[None] + 0.05
    cut = mpcc.MPCCConfig(horizon=30, v_ref=10.0, al=al_gn.ALGNConfig(outer_iters=3,
                                                                      newton_iters=2))
    outs, secs = {}, {}
    for where in ("cpu", dev):
        p = mpcc.Path(*(t.to(where, torch.float64) for t in path))
        t0 = time.perf_counter()
        r = mpcc.solve(spec, x8.to(where), p, mpcc.init_state(cut, 1, device=where,
                                                               dtype=torch.float64),
                       torch.zeros((1, 2), dtype=torch.float64, device=where), DRIFT_DT, cut)
        outs[str(where)] = r.us.cpu()
        torch.cuda.synchronize()
        secs[str(where)] = time.perf_counter() - t0
    du64 = (outs["cpu"] - outs[str(dev)]).abs().max().item()
    full = mpcc.MPCCConfig(horizon=30, v_ref=10.0)
    p32 = mpcc.Path(*(t.to(dev) for t in path))
    args = (spec, x8.float().to(dev), p32, mpcc.init_state(full, 1, device=dev),
            torch.zeros((1, 2), device=dev), DRIFT_DT)
    mpcc.solve(*args, cut)  # warm-up of the float32 launch paths at the cut budget
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r32 = mpcc.solve(*args, full)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(r32.us).all())
    print(f"phase 22 [{card}] MPCC N=30 (M=90): float64 3x2 solve on the card "
          f"{secs[str(dev)]:.2f} s and on the CPU {secs['cpu']:.2f} s, max|du| card vs CPU {du64:.3e} (gate 1e-6); "
          f"float32 at the full 12x4 budget, eager on the card: {ms32:.1f} ms a solve (host "
          f"clock) against the 50 ms period, finite {finite}, u {r32.u[0].tolist()}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if du64 > 1e-6 or not finite:
        raise SystemExit("phase 22 failed: the MPCC solve on the card disagrees with the CPU")
    return du64, ms32


def drift_scenario(dev, card):
    """Phase 23: the drift scenario through the captured CUDA graph of
    ``sim.drift_sim`` (the gatekeeper with the lane-change backup, MPCC at
    N=30 and 12x4, 160 steps): no collision and x_final[0] > 40; the first
    replayed step against an eager step on the card (graph=False, within
    1e-6); then the backup-CBF configuration for 20 replayed steps (finite,
    no collision).  Returns a dict of the numbers."""
    import numpy as np

    from safe_control_tpu_torch.sim import drift_sim
    from safe_control_tpu_torch.solvers import mpcc

    t_phase = time.perf_counter()
    spec = drift_spec()
    env, path, x0, backup_y = drift_scene(dev)
    mcfg = mpcc.MPCCConfig(horizon=30, v_ref=10.0)

    def config(algo):
        return drift_sim.DriftSimConfig(dt=DRIFT_DT, algo=algo, backup="lane_change",
                                        nominal_steps=30, backup_steps=60, event_offset_steps=1,
                                        discount_steps=5, target_velocity=10.0)

    sim = drift_sim.DriftingCarSimulator(spec, env, path, x0, mcfg, config("gatekeeper"),
                                         backup_y, device=dev)
    t0 = time.perf_counter()
    collided = sim.step()  # capture, then the first replay
    first_s = time.perf_counter() - t0
    eager = drift_sim.DriftingCarSimulator(spec, env, path, x0, mcfg, config("gatekeeper"),
                                           backup_y, device=dev, graph=False)
    t0 = time.perf_counter()
    eager.step()
    eager_ms = (time.perf_counter() - t0) * 1e3
    dx_first = float(np.abs(sim.trajectory[0] - eager.trajectory[0]).max())
    del eager
    n_steps = int(round(DRIFT_TF / DRIFT_DT))
    t0 = time.perf_counter()
    done = 1
    while done < n_steps and not collided:
        collided = sim.step()
        done += 1
    replay_ms = (time.perf_counter() - t0) / max(done - 1, 1) * 1e3
    xf = sim.trajectory[-1]
    nodes = sim.graph_nodes()
    print(f"phase 23 [{card}] drift scenario (gatekeeper, lane-change backup, two moving cars, "
          f"MPCC N=30 12x4) through the captured CUDA graph: {done} steps, collision "
          f"{sim.stats['collision']}, x_final {xf[:2].tolist()}, nominal steps "
          f"{sim.stats['nominal_steps']}, backup steps {sim.stats['backup_steps']}; capture "
          f"{sim.capture_seconds:.2f} s (warm-up included; the first step {first_s:.2f} s), "
          f"{replay_ms:.1f} ms a replayed step (host clock, the host read included) against the "
          f"50 ms period, an eager step on the card {eager_ms:.1f} ms; graph nodes {nodes}; "
          f"first step replay vs eager max|dx| {dx_first:.3e}")
    if sim.stats["collision"] or not xf[0] > 40.0:
        raise SystemExit("phase 23 failed: the drift scenario collided or made no progress")
    if dx_first > 1e-6:
        raise SystemExit("phase 23 failed: the graph's first step disagrees with an eager step")
    capture_s = sim.capture_seconds
    del sim
    bsim = drift_sim.DriftingCarSimulator(spec, env, path, x0, mcfg, config("backupcbf"),
                                          backup_y, device=dev)
    t0 = time.perf_counter()
    bcoll = bsim.step()
    b_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(DRIFT_BACKUPCBF_STEPS - 1):
        bcoll = bsim.step() or bcoll
    b_ms = (time.perf_counter() - t0) / (DRIFT_BACKUPCBF_STEPS - 1) * 1e3
    b_finite = bool(np.isfinite(np.asarray(bsim.trajectory)).all())
    print(f"phase 23 [{card}] backup-CBF configuration: {DRIFT_BACKUPCBF_STEPS} replayed steps, "
          f"collision {bcoll}, finite {b_finite}, backup steps {bsim.stats['backup_steps']}, "
          f"min h {bsim.stats['global_min_h']:.4f}; capture {bsim.capture_seconds:.2f} s (the "
          f"first step {b_first_s:.2f} s), {b_ms:.1f} ms a replayed step; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if bcoll or not b_finite:
        raise SystemExit("phase 23 failed: the backup-CBF configuration collided or diverged")
    return dict(steps=done, replay_ms=replay_ms, capture_s=capture_s,
                eager_ms=eager_ms, dx_first=dx_first, nodes=nodes, backupcbf_ms=b_ms)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    import numpy as np

    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.core.spec import (
        DOUBLE_INTEGRATOR_2D,
        DYNAMIC_UNICYCLE_2D,
        QUAD_3D,
        SINGLE_INTEGRATOR_2D,
        VTOL_2D,
        make_spec,
    )
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import mpc_cbf, qp
    from safe_control_tpu_torch.solvers import mpc_du_kernel as duk
    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- phase 1: build (all three kernels, one nvcc each, in parallel) -----
    _build.build_all(["mpc_du_kernel", "qp_admm_kernel", "mpc_fused_kernel"])
    _build.load_mpc_du_kernel()
    info = _build.BUILD_INFO["mpc_du_kernel"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase 1 build: mpc_du_kernel {info['seconds']:.1f} s (cached={info['cached']}); "
          f"ptxas: {ptxas_summary(info['ptxas'])}; at B={BATCH} "
          f"{-(-BATCH // duk.PROBLEMS_PER_BLOCK)} blocks of {duk.THREADS} threads "
          f"({duk.LANES} lanes a problem) on {sms} SMs")

    # ---- phase 2: kernel vs its plain version at the main path's shapes --
    step_k, args = entry.build_step(BATCH, device=dev, use_fused_kernel=True)
    xs, goals, obs, u_prevs, Us = args
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    params = (entry.DT, spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2, spec.cbf_beta,
              spec.radius, spec.v_max, spec.a_max, spec.w_max)
    # the cold start, the warm start one step later, and ragged batches: a
    # partly filled block (B=17, 4097) and a partly filled warp (B=1, 17)
    x1, u1, U1 = step_k(xs, goals, obs, u_prevs, Us)
    warm = (x1, goals, obs, u1, U1)
    pairs = [(f"B={BATCH} cold", args), (f"B={BATCH} warm", warm),
             ("B=1 warm", [t[:1] for t in warm]), ("B=17 warm", [t[:17] for t in warm]),
             ("B=4097 cold", entry.build_step(4097, device=dev)[1])]
    torch.cuda.synchronize()
    max_abs_err = 0.0
    b1_active = ActiveRows(lambda t: t.dim() == 1)  # one (B,) activation a row
    for label, ins in pairs:
        kern = duk.solve_du_batch(*ins, params)
        torch.cuda.synchronize()
        if label == f"B={BATCH} cold":
            with b1_active:
                plain = duk.solve_du_batch_reference(*ins, params)
        else:
            plain = duk.solve_du_batch_reference(*ins, params)
        torch.cuda.synchronize()
        du_ = (kern.u - plain.u).abs().max().item()
        dU = (kern.U - plain.U).abs().max().item()
        dv = (kern.viol - plain.viol).abs().max().item()
        same = torch.equal(kern.U, plain.U) and torch.equal(kern.viol, plain.viol)
        max_abs_err = max(max_abs_err, dU, dv)
        print(f"phase 2 kernel vs plain ({label}): max|du| {du_:.3e}, max|dU| {dU:.3e}, "
              f"max|dviol| {dv:.3e}, bit-identical {same}")
        if not (du_ < U_TOL and dv <= VIOL_TOL):
            raise SystemExit(f"phase 2 failed: kernel disagrees with its plain version ({label})")
    if b1_active.calls != 24 * duk.NC:
        raise SystemExit(f"phase 2 failed: counted {b1_active.calls} activation tests, "
                         f"not one a constraint row and Newton step")

    cfg = mpc_cbf.MPCConfig(horizon=8, num_obs=5)
    k = N_GENERAL
    st = mpc_cbf.MPCState(U=Us[:k], lam=torch.zeros((k, 56), device=dev))
    gen = mpc_cbf.solve(DYNAMIC_UNICYCLE_2D, spec, xs[:k], goals[:k], obs[:k],
                        u_prevs[:k], st, entry.DT, cfg)
    kern = duk.solve_du_batch(xs[:k], goals[:k], obs[:k], u_prevs[:k], Us[:k], params)
    torch.cuda.synchronize()
    dev_general = (kern.u - gen.u).abs().max().item()
    dviol_general = (kern.viol - gen.viol).abs().max().item()
    print(f"phase 2 kernel vs general solve ({k} problems): max|du| {dev_general:.3e}, "
          f"max|dviol| {dviol_general:.3e}")
    if not (dev_general < U_TOL and dviol_general <= VIOL_TOL):
        raise SystemExit("phase 2 failed: kernel disagrees with the general solve")

    # ---- phase 3: the main path --------------------------------------------
    duk.LAUNCH_COUNT = 0
    x, up, U = xs, u_prevs, Us
    inputs = []
    for _ in range(STEPS):
        inputs.append((x, up, U))
        x, up, U = step_k(x, goals, obs, up, U)
    torch.cuda.synchronize()
    launches = duk.LAUNCH_COUNT
    outs_ok = all(bool(torch.isfinite(t).all()) for t in (x, up, U))
    shapes_ok = (tuple(x.shape), tuple(up.shape), tuple(U.shape)) == (
        (BATCH, 4), (BATCH, 2), (BATCH, 8, 2))
    print(f"phase 3 main path: {STEPS} steps at B={BATCH}, kernel launches {launches}, "
          f"finite {outs_ok}, shapes {shapes_ok}")
    if launches < STEPS or not outs_ok or not shapes_ok:
        raise SystemExit("phase 3 failed: main path did not run through the kernel cleanly")
    # Each step's first k robots again, from the same inputs: through the
    # kernel's plain version (gated) and through the general solve (printed
    # only: two float32 solves of one problem by different operation orders
    # drift apart up to ~1e-2 in cost-flat directions once warm-started).
    step_p, _ = entry.build_step(BATCH, device=dev, use_fused_kernel=False)
    dev_plain, dev_general = [], []
    for xi, upi, Ui in inputs:
        ins = (xi[:k], goals[:k], obs[:k], upi[:k], Ui[:k])
        _, u_k, _ = step_k(*ins)
        dev_plain.append((u_k - duk.solve_du_batch_reference(*ins, params).u).abs().max().item())
        dev_general.append((u_k - step_p(*ins)[1]).abs().max().item())
    torch.cuda.synchronize()
    print(f"phase 3 per-step max|du| of {k} robots, kernel vs plain version: "
          + ", ".join(f"{d:.3e}" for d in dev_plain)
          + "; vs general solve: " + ", ".join(f"{d:.3e}" for d in dev_general))
    if max(dev_plain) >= U_TOL:
        raise SystemExit("phase 3 failed: main path disagrees with the kernel's plain version")

    # ---- phase 4: times -------------------------------------------------------
    run_kernel = lambda: duk.solve_du_batch(xs, goals, obs, u_prevs, Us, params)
    run_plain = lambda: duk.solve_du_batch_reference(xs, goals, obs, u_prevs, Us, params)
    run_kernel()
    ms = sync_time(run_kernel, 10)
    run_plain()
    plain_ms = sync_time(run_plain, 2)
    step_kernel = lambda: step_k(xs, goals, obs, u_prevs, Us)
    step_plain = lambda: step_p(xs, goals, obs, u_prevs, Us)
    step_kernel()
    step_ms_k = sync_time(step_kernel, 10)
    step_plain()
    step_ms_p = sync_time(step_plain, 2)
    print(f"phase 4 [{card}] B={BATCH}: kernel {ms:.3f} ms/solve-batch vs plain version "
          f"{plain_ms:.1f} ms; main path {BATCH / step_ms_k * 1e3:.1f} solves/s through the "
          f"kernel vs {BATCH / step_ms_p * 1e3:.1f} solves/s through the general solve "
          f"({step_ms_k:.3f} vs {step_ms_p:.1f} ms/step)")
    # the per-problem critical path (B=1) and a full card (B=16384, kernel only)
    sizes_ms = {}
    for b_, reps in ((1, 20), (16384, 5)):
        ins = [t[:1] for t in args] if b_ == 1 else entry.build_step(b_, device=dev)[1]
        run = lambda: duk.solve_du_batch(*ins, params)
        run()
        sizes_ms[b_] = sync_time(run, reps)
    b1_ops = b1_flops(obs, b1_active.total())
    b1_bound, b1_by = bound(b1_ops, BATCH * (61 + 17) * 4)
    print(f"phase 4 [{card}] kernel at B=1 {sizes_ms[1]:.4f} ms, B={BATCH} {ms:.4f} ms, "
          f"B=16384 {sizes_ms[16384]:.4f} ms; B={BATCH}: {b1_ops:.4e} operations "
          f"({b1_active.total()} active constraint rows in the Newton steps), bound "
          f"{b1_bound:.4f} ms by {b1_by} at {FP32_PEAK / 1e12:.0f} TFLOP/s, "
          f"{100 * b1_bound / ms:.2f}% of it reached")

    # ---- phase 5: the QP ADMM kernel's build ---------------------------------
    _build.load_qp_admm_kernel()
    info = _build.BUILD_INFO["qp_admm_kernel"]
    qp_shapes = []
    for qm_ in (7, 153):
        g_, r_ = qpk.launch_shape(qm_)
        qp_shapes.append(f"m={qm_}: {g_} lanes a problem, {r_} register rows a lane, "
                         f"{qpk.THREADS // g_} problems a block of {qpk.THREADS} threads")
    g7 = qpk.launch_shape(7)[0]
    path_kernels = {"qp_admm_kernel<2,%d,%d>" % qpk.launch_shape(7),
                    "qp_admm_kernel<3,%d,%d>" % qpk.launch_shape(153)}
    print(f"phase 5 build: qp_admm_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside mpc_du_kernel); ptxas at n=2, m=7 and n=3, m=153: "
          f"{ptxas_summary(info['ptxas'], path_kernels)}; launch shape "
          + "; ".join(qp_shapes) + f"; at B={BATCH}, m=7: {-(-BATCH * g7 // qpk.THREADS)} blocks "
          f"on {sms} SMs")

    # ---- phase 6: QP kernel vs its plain version -------------------------------
    cstep_k, (qxs, qgoals, qobs) = entry.build_cbf_qp_step(BATCH, device=dev)
    qp_data = cbf_qp_data(qxs, qgoals, qobs)
    # the path's B, a lone group (B=1), a partly filled warp (B=17) and a
    # ragged block (B=4097)
    q_pairs = [(f"B={BATCH}", qp_data), ("B=1", [t[:1] for t in qp_data]),
               ("B=17", [t[:17] for t in qp_data]),
               ("B=4097", cbf_qp_data(*entry.build_cbf_qp_step(4097, device=dev)[1]))]
    qp_dx = qp_dy = 0.0
    for label, data in q_pairs:
        kern = qpk.solve_qp_batch(*data)
        torch.cuda.synchronize()
        plain = qpk.solve_qp_batch_reference(*data)
        torch.cuda.synchronize()
        dx = (kern.x - plain.x).abs().max().item()
        dy = (kern.y - plain.y).abs().max().item()
        qp_dx, qp_dy = max(qp_dx, dx), max(qp_dy, dy)
        feas_k, feas_p = kern.prim_res < 1e-3, plain.prim_res < 1e-3
        feas_same = torch.equal(feas_k, feas_p)
        same = torch.equal(kern.x, plain.x) and torch.equal(kern.y, plain.y)
        print(f"phase 6a QP kernel vs plain ({label}, n=2, m=7, 1600 iters): max|dx| {dx:.3e}, "
              f"max|dy| {dy:.3e}, bit-identical {same}, feasible flags equal {feas_same} "
              f"({int(feas_k.sum())} feasible)")
        if not (dx < QP_X_TOL and feas_same):
            raise SystemExit(f"phase 6a failed: QP kernel disagrees with its plain version ({label})")

    wide = wide_qps(dev)
    wb, wm, wn = wide[2].shape
    kern_w = qpk.solve_qp_batch(*wide, iters=300)
    torch.cuda.synchronize()
    plain_w = qpk.solve_qp_batch_reference(*wide, iters=300)
    both = (kern_w.prim_res < 1e-4) & (plain_w.prim_res < 1e-4)
    wide_dx = max_where((kern_w.x - plain_w.x).abs().amax(-1), both)
    same = torch.equal(kern_w.x, plain_w.x) and torch.equal(kern_w.y, plain_w.y)
    print(f"phase 6b QP kernel vs plain (B={wb}, n={wn}, m={wm}, 300 iters): "
          f"{int(both.sum())}/{wb} solved by both, max|dx| {wide_dx:.3e}, bit-identical {same}")
    if not (wide_dx < QP_WIDE_TOL and int(both.sum()) * 4 >= 3 * wb):
        raise SystemExit("phase 6b failed: QP kernel disagrees with its plain version at m=153")

    k = N_GENERAL
    sub = [t[:k] for t in qp_data]
    kern_g = qpk.solve_qp_batch(*sub)
    gen = qp.solve_qp(*sub, iters=1600)
    torch.cuda.synchronize()
    fk, fg = kern_g.prim_res < 1e-3, gen.prim_res < 1e-3
    gen_dx = max_where((kern_g.x - gen.x).abs().amax(-1), fk & fg)
    print(f"phase 6c QP kernel vs general solve_qp ({k} problems): max|dx| {gen_dx:.3e} "
          f"on {int((fk & fg).sum())} feasible in both, feasible flags equal {torch.equal(fk, fg)}")
    if not (gen_dx < QP_WIDE_TOL and torch.equal(fk, fg)):
        raise SystemExit("phase 6c failed: QP kernel disagrees with the general solve_qp")

    # ---- phase 7: the CBF-QP path ----------------------------------------------
    qpk.LAUNCH_COUNT = 0
    x = qxs
    q_inputs, q_us = [], []
    for _ in range(STEPS):
        q_inputs.append(x)
        x, u_c, feas_c, hmin_c = cstep_k(x, qgoals, qobs)
        q_us.append(u_c)
    torch.cuda.synchronize()
    qp_launches = qpk.LAUNCH_COUNT
    outs_ok = all(bool(torch.isfinite(t).all()) for t in (x, u_c, hmin_c))
    shapes_ok = [tuple(t.shape) for t in (x, u_c, feas_c, hmin_c)] == [
        (BATCH, 4), (BATCH, 2), (BATCH,), (BATCH,)]
    print(f"phase 7 CBF-QP path: {STEPS} steps at B={BATCH}, QP kernel launches {qp_launches}, "
          f"finite {outs_ok}, shapes {shapes_ok}, feasible {int(feas_c.sum())}/{BATCH}, "
          f"min h_min {hmin_c.min().item():.3e}")
    if qp_launches < STEPS or not outs_ok or not shapes_ok:
        raise SystemExit("phase 7 failed: CBF-QP path did not run through the kernel cleanly")
    dev_plain = []
    for xi, ui in zip(q_inputs, q_us):
        data = cbf_qp_data(xi[:k], qgoals[:k], qobs[:k])
        dev_plain.append((ui[:k] - qpk.solve_qp_batch_reference(*data).x).abs().max().item())
    torch.cuda.synchronize()
    print(f"phase 7 per-step max|du| of {k} robots, kernel path vs plain version: "
          + ", ".join(f"{d:.3e}" for d in dev_plain))
    if max(dev_plain) >= QP_U_TOL:
        raise SystemExit("phase 7 failed: CBF-QP path disagrees with the kernel's plain version")

    # ---- phase 8: QP times ------------------------------------------------------
    sweep_ms = {}
    for b_, reps in ((1, 20), (BATCH, 10), (16384, 10)):
        data = [t[:1] for t in qp_data] if b_ == 1 else qp_data if b_ == BATCH else \
            cbf_qp_data(*entry.build_cbf_qp_step(b_, device=dev)[1])
        scaled = qp.equilibrate(*data)
        run_sweep = lambda: qpk._sweep_cuda(*scaled[:5], 1600, 1.0, 1e-6, 1.6)
        run_sweep()
        sweep_ms[b_] = sync_time(run_sweep, reps)
    print(f"phase 8 [{card}] QP kernel launch (n=2, m=7, 1600 iterations): B=1 "
          f"{sweep_ms[1]:.4f} ms, B={BATCH} {sweep_ms[BATCH]:.4f} ms, B=16384 "
          f"{sweep_ms[16384]:.4f} ms")
    run_qk = lambda: qpk.solve_qp_batch(*qp_data)
    run_qp = lambda: qpk.solve_qp_batch_reference(*qp_data)
    run_qk()
    qp_ms = sync_time(run_qk, 10)
    # the wrapper's parts, each alone: the host enqueues its small ops
    # faster than the card runs them, or not
    scaled = qp.equilibrate(*qp_data)
    x_s, y_s = qpk._sweep_cuda(*scaled[:5], 1600, 1.0, 1e-6, 1.6)
    eq_ms = sync_time(lambda: qp.equilibrate(*qp_data), 10)
    fin_ms = sync_time(lambda: qp.finish(*qp_data, scaled, x_s, y_s, True), 10)
    run_qp()
    qp_plain_ms = sync_time(run_qp, 2)
    cstep_g, _ = entry.build_cbf_qp_step(BATCH, device=dev, backend="xla")
    cstep_kernel = lambda: cstep_k(qxs, qgoals, qobs)
    cstep_general = lambda: cstep_g(qxs, qgoals, qobs)
    cstep_kernel()
    cstep_ms_k = sync_time(cstep_kernel, 10)
    cstep_general()
    cstep_ms_g = sync_time(cstep_general, 2)
    qn, qm = qp_data[0].shape[-1], qp_data[2].shape[-2]
    b2_ops = b2_flops(BATCH, qn, qm, 1600)
    b2_bound, b2_by = bound(b2_ops, BATCH * (qn * qn + 2 * qn + qm * qn + 4 * qm) * 4)
    print(f"phase 8 [{card}] B={BATCH}: QP kernel {b2_ops:.4e} operations (n={qn}, m={qm}, "
          f"1600 iterations), bound {b2_bound:.4f} ms by {b2_by}, "
          f"{100 * b2_bound / sweep_ms[BATCH]:.2f}% "
          f"of it reached by the launch")
    print(f"phase 8 [{card}] B={BATCH}: QP kernel path {qp_ms:.3f} ms/solve-batch "
          f"(qp.equilibrate {eq_ms:.3f} ms, the launch {sweep_ms[BATCH]:.3f} ms, qp.finish "
          f"{fin_ms:.3f} ms, each alone) vs plain version {qp_plain_ms:.1f} ms; "
          f"CBF-QP path {1e3 / cstep_ms_k:.1f} steps/s ({BATCH * 1e3 / cstep_ms_k:.1f} "
          f"robot-steps/s, {cstep_ms_k:.3f} ms/step) through the kernel vs "
          f"{1e3 / cstep_ms_g:.1f} steps/s ({cstep_ms_g:.1f} ms/step) through the general "
          f"solve_qp")

    # ---- phase 9: the fused MPC kernel's build ----------------------------------
    _build.load_mpc_fused_kernel()
    info = _build.BUILD_INFO["mpc_fused_kernel"]
    q3_spec = make_spec(QUAD_3D)
    q3_cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    vt_spec = make_spec(VTOL_2D)
    vt_cfg = mpc_cbf.MPCConfig(horizon=16, num_obs=5)
    du_cfg = mpc_cbf.MPCConfig(horizon=8, num_obs=5)
    int_cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    shapes = {QUAD_3D: (q3_spec, q3_cfg), VTOL_2D: (vt_spec, vt_cfg), DYNAMIC_UNICYCLE_2D:
              (spec, du_cfg), SINGLE_INTEGRATOR_2D: (make_spec(SINGLE_INTEGRATOR_2D), int_cfg),
              DOUBLE_INTEGRATOR_2D: (make_spec(DOUBLE_INTEGRATOR_2D), int_cfg)}
    shapes.update({model: (make_spec(model), int_cfg) for model in NEW_B3_OPS})
    shapes.update({model: (make_spec(model), int_cfg) for model in DRIFT_B3_OPS})
    b3_report = {}
    with UnitWeights():  # to size Manipulator2D's parameter block
        for model, regs, frame in fused_ptxas(info["ptxas"]):
            sp, cf = shapes[model]
            smem = mf.shared_memory_bytes(model, sp, entry.DT, cf)
            per_sm = mf.blocks_per_sm(model, sp, entry.DT, cf)
            b3_report[model] = (f"{model} N={cf.horizon}: {regs}, {frame}, {smem} bytes dynamic "
                                f"shared, {per_sm} blocks an SM")
    threads = _build.load_mpc_fused_kernel().mpc_fused_threads()
    print(f"phase 9 build: mpc_fused_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside the other two), {threads}-thread blocks; "
          + " | ".join(v for k, v in b3_report.items()
                       if k not in NEW_B3_OPS and k not in DRIFT_B3_OPS))
    if set(b3_report) != set(mf.MODEL_IDS):
        raise SystemExit("phase 9 failed: not every model has a fused kernel instantiation")

    # ---- phase 10: fused kernel vs its plain version -------------------------------
    fused_errs = []

    q3_nc = mpc_cbf._num_constraints(get_model(QUAD_3D), q3_cfg)
    b3_active = ActiveRows(lambda t: t.dim() == 2 and t.shape[-1] == q3_nc)

    fstep_k, fargs = entry.build_fused_step(BATCH, device=dev)
    b3_pair("10a", QUAD_3D, q3_spec, fargs, q3_cfg, fused_errs, active=b3_active)
    if b3_active.calls != 24:
        raise SystemExit(f"phase 10a failed: counted {b3_active.calls} activation tests, "
                         f"not one a Newton step")
    fx1, fu1, fU1 = fstep_k(*fargs)
    b3_pair("10a", QUAD_3D, q3_spec, (fx1, fargs[1], fargs[2], fu1, fU1), q3_cfg, fused_errs)

    kern = b3_pair("10b", DYNAMIC_UNICYCLE_2D, spec, (xs, goals, obs, u_prevs, Us), du_cfg,
                   fused_errs)
    b1 = duk.solve_du_batch(xs, goals, obs, u_prevs, Us, params)
    du_model = get_model(DYNAMIC_UNICYCLE_2D)
    roll = [xs]
    for k in range(8):
        roll.append(du_model.step(roll[-1], b1.U[:, k], spec, entry.DT))
    torch.cuda.synchronize()
    # Two float32 solvers of one algorithm in other operation orders: on the
    # few problems whose cost is flat along a steering direction they settle
    # apart (both as far from a float64 solve), so the gate holds on the 64
    # problems that phase 2 holds the DU kernel to, and on a 95% share of the
    # batch; the whole batch is reported.
    per_du = (kern.U - b1.U).abs().amax((1, 2))
    per_dxs = (kern.xs - torch.stack(roll, dim=1)).abs().amax((1, 2))
    per_dv = (kern.viol - b1.viol).abs()
    k = N_GENERAL
    b13_du, b13_dxs, b13_dv = (t[:k].max().item() for t in (per_du, per_dxs, per_dv))
    agree = (per_du < U_TOL) & (per_dxs < U_TOL) & (per_dv <= VIOL_TOL)
    print(f"phase 10b fused kernel vs the DU kernel (cold start), first {k} problems: max|du| "
          f"{b13_du:.3e}, max|dxs| {b13_dxs:.3e}, max|dviol| {b13_dv:.3e}; all {BATCH}: "
          f"{int(agree.sum())} within the limits, max|du| {per_du.max().item():.3e}, median|du| "
          f"{per_du.median().item():.3e}, max|dviol| {per_dv.max().item():.3e}, "
          f"bit-identical {torch.equal(kern.U, b1.U)}")
    if not (b13_du < U_TOL and b13_dxs < U_TOL and b13_dv <= VIOL_TOL
            and int(agree.sum()) >= 0.95 * BATCH):
        raise SystemExit("phase 10b failed: the fused kernel disagrees with the DU kernel")

    rng = np.random.default_rng(11)
    vb = 256
    v_xs = torch.as_tensor(np.concatenate(
        [rng.uniform(5, 10, (vb, 1)), rng.uniform(36, 40, (vb, 1)), rng.uniform(-0.1, 0.1, (vb, 1)),
         rng.uniform(10, 13, (vb, 1)), rng.uniform(-0.5, 0.5, (vb, 1)), np.zeros((vb, 1))], axis=1),
        dtype=torch.float32, device=dev)
    v_goal = torch.tensor([80.0, 40.0, 0, 0, 0, 0], device=dev).repeat(vb, 1)
    v_obs = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5, device=dev)[None].repeat(vb, 1, 1)
    b3_pair("10c", VTOL_2D, vt_spec, (v_xs, v_goal, v_obs, torch.zeros((vb, 4), device=dev),
                                      torch.zeros((vb, 16, 4), device=dev)), vt_cfg, fused_errs)
    ib = 64
    two_obs = pad_obstacles([[2.5, 0.8, 0.4, 0, 0, 0, 0], [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], 5,
                            device=dev)[None].repeat(ib, 1, 1)
    for model, nx in ((SINGLE_INTEGRATOR_2D, 2), (DOUBLE_INTEGRATOR_2D, 4)):
        i_xs = torch.as_tensor(np.concatenate(
            [rng.uniform(0, 3, (ib, 2)), rng.uniform(-0.5, 0.5, (ib, nx - 2))], axis=1),
            dtype=torch.float32, device=dev)
        i_goal = torch.zeros((ib, nx), device=dev)
        i_goal[:, :2] = torch.tensor([5.0, 1.0], device=dev)
        b3_pair("10d", model, make_spec(model), (i_xs, i_goal, two_obs,
                                                 torch.zeros((ib, 2), device=dev),
                                                 torch.zeros((ib, 10, 2), device=dev)), int_cfg,
                fused_errs)
    fused_max_err = max(fused_errs)

    # ---- phase 11: the fused path ------------------------------------------------
    mf.LAUNCH_COUNT = 0
    x, up, U = fargs[0], fargs[3], fargs[4]
    f_inputs = []
    for _ in range(STEPS):
        f_inputs.append((x, up, U))
        x, up, U = fstep_k(x, fargs[1], fargs[2], up, U)
    torch.cuda.synchronize()
    fused_launches = mf.LAUNCH_COUNT
    outs_ok = all(bool(torch.isfinite(t).all()) for t in (x, up, U))
    shapes_ok = (tuple(x.shape), tuple(up.shape), tuple(U.shape)) == (
        (BATCH, 12), (BATCH, 4), (BATCH, 10, 4))
    print(f"phase 11 fused path: {STEPS} steps at B={BATCH}, fused kernel launches "
          f"{fused_launches}, finite {outs_ok}, shapes {shapes_ok}")
    if fused_launches < STEPS or not outs_ok or not shapes_ok:
        raise SystemExit("phase 11 failed: the fused path did not run through the kernel cleanly")
    k = N_GENERAL
    dev_plain = []
    for xi, upi, Ui in f_inputs:
        ins = (xi[:k], fargs[1][:k], fargs[2][:k], upi[:k], Ui[:k])
        _, u_k, _ = fstep_k(*ins)
        u_p = mf.solve_fused_batch_reference(QUAD_3D, q3_spec, *ins, entry.DT, q3_cfg).u
        dev_plain.append((u_k - u_p).abs().max().item())
    torch.cuda.synchronize()
    print(f"phase 11 per-step max|du| of {k} robots, fused path vs plain version: "
          + ", ".join(f"{d:.3e}" for d in dev_plain))
    if max(dev_plain) >= U_TOL:
        raise SystemExit("phase 11 failed: the fused path disagrees with the kernel's plain version")

    # ---- phase 12: fused times and single-robot latency ----------------------------
    run_fk = lambda: mf.solve_fused_batch(QUAD_3D, q3_spec, *fargs, entry.DT, q3_cfg)
    run_fp = lambda: mf.solve_fused_batch_reference(QUAD_3D, q3_spec, *fargs, entry.DT, q3_cfg)
    run_fk()
    f_ms = sync_time(run_fk, 5)
    # one problem's critical path (B=1) and four times the batch (B=16384)
    f_sizes_ms = {}
    for b_, reps in ((1, 20), (16384, 3)):
        ins = [t[:1] for t in fargs] if b_ == 1 else entry.build_fused_step(b_, device=dev)[1]
        run = lambda: mf.solve_fused_batch(QUAD_3D, q3_spec, *ins, entry.DT, q3_cfg)
        run()
        f_sizes_ms[b_] = sync_time(run, reps)
    run_fp()
    f_plain_ms = sync_time(run_fp, 1)
    fstep_g, _ = entry.build_fused_step(BATCH, device=dev, use_fused_kernel=False)
    fstep_kernel = lambda: fstep_k(*fargs)
    fstep_general = lambda: fstep_g(*fargs)
    fstep_kernel()
    fstep_ms_k = sync_time(fstep_kernel, 5)
    fstep_general()
    fstep_ms_g = sync_time(fstep_general, 1)
    print(f"phase 12 [{card}] Quad3D N=10: fused kernel at B=1 {f_sizes_ms[1]:.4f} ms, "
          f"B={BATCH} {f_ms:.4f} ms, B=16384 {f_sizes_ms[16384]:.4f} ms")
    print(f"phase 12 [{card}] B={BATCH} Quad3D N=10: fused kernel {f_ms:.3f} ms/solve-batch vs "
          f"plain version {f_plain_ms:.1f} ms; fused path {BATCH / fstep_ms_k * 1e3:.1f} solves/s "
          f"({fstep_ms_k:.3f} ms/step) through the kernel vs {BATCH / fstep_ms_g * 1e3:.1f} "
          f"solves/s ({fstep_ms_g:.1f} ms/step) through the general solve")

    q3 = get_model(QUAD_3D)
    q3_n, q3_m, q3_M = q3.N_STATES, q3.N_CONTROLS, 10 * q3.N_CONTROLS
    b3_ops = b3_flops(BATCH, q3_n, q3_m, 10, 5, q3_nc, QUAD3D_STEP_OPS, b3_active.total())
    b3_bound, b3_by = bound(b3_ops, BATCH * (2 * q3_n + 35 + q3_m + 2 * q3_M + 11 * q3_n + 1) * 4)
    print(f"phase 12 [{card}] B={BATCH} Quad3D N=10: fused kernel {b3_ops:.4e} operations "
          f"({b3_active.total()} active constraint rows in the Newton steps), bound "
          f"{b3_bound:.4f} ms by {b3_by}, {100 * b3_bound / f_ms:.2f}% of it reached")

    def chain_us(model_name, horizon, fused):
        """Microseconds per solve over a chain of warm-started B=1
        solve_dispatch calls (CHAIN through the kernel, CHAIN_GENERAL not)."""
        one_step, a = entry.build_fused_step(1, model_name=model_name, horizon=horizon,
                                             device=dev, use_fused_kernel=fused)
        one_step(*a)  # warm-up: first use of every launch path
        x, up, U = a[0], a[3], a[4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain = CHAIN if fused else CHAIN_GENERAL
        for _ in range(chain):
            x, up, U = one_step(x, a[1], a[2], up, U)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / chain * 1e6

    lat = {(mname, fused): chain_us(mname, hz, fused)
           for mname, hz in ((QUAD_3D, 10), (DYNAMIC_UNICYCLE_2D, 8)) for fused in (True, False)}
    print(f"phase 12 [{card}] single robot, {CHAIN} ({CHAIN_GENERAL} through the general "
          f"solve) chained warm-started steps (solve_dispatch "
          f"+ model.step): Quad3D N=10 {lat[(QUAD_3D, True)]:.1f} us/solve through the fused "
          f"kernel vs {lat[(QUAD_3D, False)]:.1f} us through the general solve; DU N=8 "
          f"{lat[(DYNAMIC_UNICYCLE_2D, True)]:.1f} vs {lat[(DYNAMIC_UNICYCLE_2D, False)]:.1f} us")

    # ---- phases 13-15: the tracking loop --------------------------------------
    single_robot(dev, card, 13, {"model": DYNAMIC_UNICYCLE_2D, "w_max": 0.5, "a_max": 1.0,
                                 "radius": 0.25, "mpc_horizon": 8, "use_fused_kernel": True},
                 "mpc_cbf", [2.0, 2.0, np.pi / 2, 0.0], 120.0, mf)
    single_robot(dev, card, 14, {"model": DOUBLE_INTEGRATOR_2D, "v_max": 1.0, "a_max": 1.5,
                                 "radius": 0.25}, "cbf_qp", [2.0, 2.0, np.pi / 2], 100.0, qpk)
    qp_fleet = fleet(dev, card, "cbf_qp", FLEET_DI_STEPS)
    du_fleet = fleet(dev, card, "mpc_cbf", FLEET_DU_STEPS)

    # ---- phases 16-19: the later models and MPC variants ------------------------
    b3_shapes, b3_new_err, b3_new_launches = new_b3_models(dev, card, b3_report)
    dyn = dynamic_env(dev, card)
    arm_shape = manipulator_cbf_qp(dev, card)
    mpc_variants(dev, card)

    # ---- phases 20-23: the drift models on B3, the sweep, MPCC, the drift car ------
    drift_shapes, drift_err, drift_bits = drift_b3_models(dev, card, b3_report)
    sweep = monte_carlo_sweep(dev, card)
    mpcc_alone(dev, card)
    drift_scenario(dev, card)

    print(json.dumps({"kernels": [{
        "name": "mpc_du_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/mpc_du_kernel.cu",
        "replaces": "safe_control_tpu/solvers/mpc_du_kernel.py:105",
        "launches": launches,
        "launches_per_step": launches / STEPS,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b1_bound,
        "bound_by": b1_by,
        "library_ms": None,
    }, {
        "name": "qp_admm_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/qp_admm_kernel.cu",
        "replaces": "safe_control_tpu/solvers/qp_kernel.py:101",
        "launches": qp_launches,
        "launches_per_step": qp_launches / STEPS,
        "tracking_launches": qp_fleet[0],
        "tracking_launches_per_step": qp_fleet[0] / FLEET_DI_STEPS,
        "tracking_ms_per_launch": qp_fleet[2],
        "dynamic_env_launches_per_step": dyn[0] / DYN_STEPS,
        "dynamic_env_ms_per_launch": dyn[2],
        "sweep_launches_per_step": sweep[0] / SWEEP_STEPS,
        "sweep_ms_per_launch": sweep[2],
        "shapes": [arm_shape, {"shape": f"DPCBF sweep n=2 m=10 B={SWEEP_BATCH}",
                               "ms": sweep[2], "bound_ms": sweep[4], "bound_by": sweep[5],
                               "max_abs_err": sweep[3]}],
        "max_abs_err": max(qp_dx, qp_dy, arm_shape["max_abs_err"], dyn[3], sweep[3]),
        "ms": qp_ms,
        "plain_ms": qp_plain_ms,
        "bound_ms": b2_bound,
        "bound_by": b2_by,
        "library_ms": None,
    }, {
        "name": "mpc_fused_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/mpc_fused_kernel.cu",
        "replaces": "safe_control_tpu/solvers/mpc_fused.py:913",
        "launches": fused_launches,
        "launches_per_step": fused_launches / STEPS,
        "tracking_launches": du_fleet[0],
        "tracking_launches_per_step": du_fleet[0] / FLEET_DU_STEPS,
        "tracking_ms_per_launch": du_fleet[2],
        "dpcbf_launches_per_step": b3_new_launches / STEPS,
        "shapes": b3_shapes + drift_shapes,
        "drift_bit_identical": drift_bits,
        "max_abs_err": max(fused_max_err, b3_new_err, drift_err),
        "ms": f_ms,
        "plain_ms": f_plain_ms,
        "bound_ms": b3_bound,
        "bound_by": b3_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
