"""Smoke test of the PyTorch port on one NVIDIA GPU (the port's main paths).

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the three CUDA kernels from ``csrc/`` (one nvcc
   each, started together; the QP and fused kernels' builds run on in
   background threads through phases 2-8, each waited for before the phase
   that first loads it); reports the fused DU MPC kernel's build
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
   spills) and its launch shape at n=2, m=7 (B=4096), n=2, m=10 (B=2^19,
   one lane a problem) and n=3, m=153: lanes a problem, register rows a
   lane, problems and threads a block.  The B2 phases print the shape they
   took.
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
   QP kernel launches and one finish kernel launch with each, and each
   step's first 64 robots within 1e-3 of the plain version on the same
   inputs.
8. Times the QP kernel's launch at B=1, 4096 and 16384, the kernel through
   its wrapper (and the wrapper's ``qp.equilibrate`` and its finish kernel
   alone, beside the general path's ``qp.finish``) and its plain version,
   and CBF-QP steps/s through the kernel and through the general path; the
   kernel's operation count, bound and share reached.
   8b. The finish kernel (``csrc/qp_finish_kernel.cu``) against
   ``_finish_plain`` on B2's iterates, x, y and both residuals bit for bit,
   else the phase fails: the CBF-QP path's n=2 m=7 B=4096, n=2 and n=3 at
   m=13 (B=4096), Manipulator2D's CBF-QP (n=3, m=118, B=4096), random QPs
   at m=153 (B=256) and 300 rows (B=64); each timed beside the general
   path's ``qp.finish``, with its bytes' bound.
9. Reports the generic fused MPC kernel's build: seconds, and per model the
   instantiation its configuration launches, with its threads a block (one
   warp at M <= 32, else 128), registers, stack, spills, dynamic shared
   memory and blocks an SM (the CUDA occupancy calculator); every model has
   three, the shared-memory layout in one warp and in 128 threads and the
   wide one (phase 28b).
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
    kernel and CHAIN_GENERAL through the general solve (seconds a solve,
    host-bound).

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
    CBF-QP scenario for 900 steps (robot 0 completes it at step 876; 2000
    before phases 24-27 needed the time) (robot 0 at the scenario's start,
    the others within +-0.1 m of it, from ``np.random.default_rng(0)``) and
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
    ``tracking.run_dynamic`` with the CBF-QP for DYN_STEPS steps, one
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
    VTOL2D N=30 (M=120) for one robot, RTI_STEPS warm-started steps, ms a
    step beside the 50 ms period (eager; the solve factors and substitutes
    in D steps above D=40), and the aten dispatches of one solve.

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
    21b. B2 at the sweep's benchmark scale (2^19 scenarios, n=2, m=10, 400
    iterations, one lane a problem): the QPs of the sweep's first step
    against the plain sweep on a seeded sample with the first and last
    blocks, bit for bit (gated), one launch counted in ``LANE_LAUNCH_COUNT``
    (gated), the launch's ms, bound and share; then the finish kernel on
    the same step's inputs against ``_finish_plain`` on all 2^19 problems,
    bit for bit (gated), timed beside ``qp.finish``.
22. MPCC (``solvers/mpcc.py``, N=30, M=90, the general AL-GN solve): one
    float64 solve at a 3x2 budget on the card and on the CPU (|du| <= 1e-6)
    and one float32 solve at the full 12x4 budget, eager, timed.
23. The drift scenario of ``tests/drift_scenario_common.py`` (gatekeeper,
    lane-change backup, two moving cars, 100 steps) through
    ``sim.drift_sim.DriftingCarSimulator``'s captured CUDA graph: no
    collision and x_final[0] > 40; capture seconds, ms a replayed step, an
    eager step, the graph's node count; the first replayed step against the
    capture's warm-up, an eager step (within 1e-6); then
    DRIFT_BACKUPCBF_STEPS replayed steps of the backup-CBF configuration
    (finite, no collision).

24. The warehouse case study of ``tests/test_warehouse_e2e.py`` through
    ``sim.warehouse_sim``'s captured CUDA graphs: one eager step of each
    strategy on the card against its first replayed step (within 1e-6),
    BackupCBF's first step from rest on the JAX package's branch (the QP
    fails, the nominal [3, 0]); the gatekeeper at levels 1-7, 1200 steps
    each (no collision, min h > -0.05, backup steps > 0, past waypoint 1);
    BackupCBF reaching the goal at level 1 (min h > -0.05, min rollout h <
    3) and colliding at levels 2-7.
25. The tracked heterogeneous fleet (``parallel.fleet.step_fleet``):
    ``tests/test_fleet.py``'s 24 robots for 200 steps (no infeasible or
    colliding robot, closest pair > 0.45 m); anchor 5 at
    ``examples/heterogeneous_fleet.py``'s defaults (3 x 1365 robots in
    serpentine lattices, 200 steps in chunks of 10, margin 0.3): one B2
    launch a group a step (gated), finite states, each group's first 64
    robots' first 20 controls within QP_U_TOL of B2's plain version;
    agent-steps/s, waypoint progress, B2's time, bound and share; one chunk
    traced with ``utils.profiling.trace_to`` (the device's busy share, the
    five longest kernels).
26. The shielded fleet (``step_fleet_shielded``): the two walls of 32 and
    the head-on pair of ``tests/test_fleet_shielded.py`` to its predicates;
    ``bench.py``'s 4,096-agent three-family anchor, 17 chunks of 4 steps:
    collision-free after every chunk, shields engaged; agent-steps/s.
27. The multi-device path on a NCCL process group of world size 1:
    ``run_sharded_sweep`` and ``step_fleet_shielded_sharded`` equal to their
    single-device paths bit for bit.

28. The VTOL corridor of ``tests/test_vtol_e2e.py`` (pillars at x=37,
    ``MPCConfig.rti``, N=30, D=120, the general solve; VTOL_STEPS steps or
    3 m past the pillars, VTOL_PAST_X) through ``LocalTrackingController``'s
    captured CUDA graph: no ground strike, x > 25 m, pillar clearance > 0.3
    m; the first replayed step against the capture's warm-up, an eager step
    on the card (within 1e-6); ms a replayed and an eager step, the
    capture's seconds and the graph's nodes.  The pop-in
    curve at the RTI budget (the pillars appear at step 32): clearance >=
    0.5 m and past the pillars; its 8x3 point is cut.  Then ``examples.vtol
    --rti`` over the whole route: it ends as the JAX package's script does at
    that budget (VTOL_RTI_JAX: RET_INFEASIBLE inside the 0.6 m radius of the
    (60, 12) circle; gated on the code, x within 2 m of the script's and the
    clearance under the radius).  The script's 8x3 default lands in the JAX
    package; the port's 8x3 route is not run here (about 6x the RTI graph).
28b. B3 at VTOL2D N=30 (M=120, the RTI budget), past a block's shared
    memory: the scaled Jc in the kernel's global workspace.  Its build (the
    wide instantiation's registers, shared bytes, workspace bytes, blocks
    an SM); the kernel against its plain version on 64 corridor starts
    (``vtol_starts``) at B=1 and B=64, in the kernel envelope, bits
    printed; ms a launch at B=1, 64 and 4096 (the 64 starts repeated), each
    with its operation count and bound (``b3_flops`` at the 2x2 budget, the
    active rows counted on the plain version's run); the plain version's ms.
    Then phase 28's corridor with ``use_fused_kernel``, through the
    controller's captured graph: phase 28's predicates (no ground strike, x
    > 25 m, pillar clearance > 0.3 m), one B3 launch a replayed step and no
    fallback, the first replay equal to the capture's eager warm-up, ms a
    replayed step.
29. ``tests/test_unknown_env_e2e.py``'s DI CBF-QP scenario whole (2400
    steps of one captured ``tracking.step``): RET_DONE, never
    RET_INFEASIBLE, at least 5 memory rows, no unknown obstacle touched, one
    B2 launch a step.  Then ``examples.unknown_env``'s default (DU MPC-CBF,
    N=7, fov) through B3 (``use_fused_kernel``) and through the general
    solve, and ``--unknown_detection ray`` through B3: the default's
    ``Success!``; the ray run ends as the JAX package's script does
    (UNKNOWN_RAY_JAX: a collision); the general-solve run is cut to
    UNKNOWN_GENERAL_TF and gated on no collision; the fused runs' first
    PLAIN_STEPS steps against B3's plain version.
30. The visibility scenarios of ``tests/test_visibility_violation.py``
    (RET_VISIBILITY seen and the run going on; the turning unicycle's arc;
    the camera leading), the three attitude controllers through the
    wrapper (yaw spread > 0.05, a grown footprint; their first PLAIN_STEPS
    steps against B2's plain version), the gatekeeper attitude on the DI
    MPC prediction (60 steps, never infeasible, replans > 0), ray detection
    through the wrapper (RET_DONE) and the VTOL ground and pitch oracle.
31. Every ``examples`` module through ``main([...])`` at its defaults, cut
    by its own switches where an earlier phase runs its scenario
    (EXAMPLE_RUNS prints each cut), gated on its printed predicate and, on
    the CBF-QP paths, on B2's launches.

Cut depths, to keep the whole script inside its time: phase 12's
general-solve chains (``CHAIN_GENERAL``) and phase 19d's RTI steps
(``RTI_STEPS``) run 1 step each (5, then 2, before); phase 15's DI fleet
900 steps (2000 before phases 24-27 came); phase 17's runs DYN_STEPS (800,
then 400, before; its robots reach RET_DONE at steps 255-285); phase 23's
backup-CBF steps DRIFT_BACKUPCBF_STEPS (20, then 10) and its gatekeeper
run DRIFT_TF (160 steps before phases 28-31).  Phases 28-31 cut the VTOL
pop-in curve's 8x3 point, run examples.vtol at --rti only, run
examples.unknown_env through the general solve for UNKNOWN_GENERAL_TF
seconds, and shorten the command lines that repeat earlier phases
(EXAMPLE_RUNS).  Phase 24 runs its gatekeeper levels and
its BackupCBF levels at once, in two host threads on two CUDA streams, and
it runs between phases 8 and 9: it launches no kernel, and it covers the
fused kernel's build (26 instantiations, two a model: about 2 minutes) that
phase 9 waits for.
With phases 28-31 (closed-loop scenarios of host-bound general-solve
graphs) the script's budget is 950 s of its 1200 s limit; a new phase
needs a cut elsewhere first.  Phase 28b (15-30 s) came without one:
phase 24's move before phase 9 keeps the longer fused build off the clock.

Every time is printed beside the card's name and power limit, and each
phase's wall seconds from phase 13 on.  Prints one JSON line of per-kernel
numbers (with each kernel's bound and launches a step), then, as the last
line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device and
when any check fails.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import re
import subprocess
import sys
import time

import torch

from portbench import roofline
from portbench.roofline import FP32_PEAK, HBM_RATE, b2_bytes, b2_flops, b3_bytes, b3_flops

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
CHAIN_GENERAL = 1  # the same through the general solve (host-bound, seconds a solve)
RTI_STEPS = 1  # phase 19d's warm-started VTOL2D N=30 RTI steps (the general solve)
FLEET = 4096  # robots of the tracking fleet (phase 15)
FLEET_DI_STEPS = 900  # robot 0 reaches RET_DONE at step 876 (45 s at dt 0.05)
FLEET_DU_STEPS = 50
REPLAY = {"cbf_qp": 20, "mpc_cbf": 5}  # fleet steps replayed with the plain version
PASS_TOL = 0.35  # every waypoint passed this close (tests/test_tracking_e2e.py)
# The dynamic-obstacle scenario of tests/test_dynamic_env_e2e.py: 8 obstacles
# moving at (-0.5, +-0.5), bouncing in y within [0, 15].
DYN_BASE = [[8.0, 9.0, 0.5], [10.0, 4.0, 0.5], [12.0, 5.0, 0.5], [14.0, 9.0, 0.5],
            [16.0, 6.0, 0.5], [18.0, 14.0, 0.5], [20.0, 4.0, 0.5], [22.0, 12.0, 0.5]]
DYN_VELS = [[-0.5, 0.5] if i % 2 == 0 else [-0.5, -0.5] for i in range(8)]
DYN_WAYPOINTS = [[1.0, 7.5], [20.0, 7.5]]
DYN_STEPS = 300  # the robots of phase 17 reach RET_DONE at steps 255-285
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


def b2_shape(B: int, n: int, m: int) -> str:
    """B2's launch shape for ``B`` problems of ``n`` variables and ``m`` rows,
    in words."""
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    G, R = qpk.launch_shape(B, n, m)
    if G == 1:
        return f"one lane a problem, {R} row slots"
    return f"{G} lanes a problem, {R} register rows a lane"


def fused_instantiation(mangled: str) -> tuple:
    """``(model, wide, threads, clocked)`` of an instantiation of the fused
    kernel from its mangled name: the model is its first template argument,
    ``wide`` its second (the layout with a global workspace; False for a
    build without it), ``threads`` its third (a block's threads; 128 for a
    build without it) and ``clocked`` whether its pack holds the phase
    clock's buffer; ``("?", False, 128, False)`` for another name."""
    found = re.search(r"IN9mpc_fused(\d+)", mangled)
    if not found:
        return "?", False, 128, False
    end = found.end() + int(found.group(1))
    args = re.match(r"ELb([01])E(?:Li(\d+)E)?(?:J(Py)?E)?", mangled[end:])
    if args is None:
        return mangled[found.end():end], False, 128, False
    return (mangled[found.end():end], args.group(1) == "1", int(args.group(2) or 128),
            args.group(3) is not None)


def fused_ptxas(report: str, clock: bool = False) -> list:
    """``(model, wide, threads, registers, stack and spills)`` of each
    instantiation of the fused kernel without its phase clock (with
    ``clock``, of each with it), from nvcc's ``-Xptxas -v`` report
    (``fused_instantiation``)."""
    out, kind, frame = [], ("?", False, 128, False), ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            kind = fused_instantiation(ln)
        elif "bytes stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and kind[3] == clock:
            out.append((*kind[:3], ln.split("Used")[1].split(",")[0].strip(), frame))
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
    """(least milliseconds, "operations" or "bytes"): ``roofline.bound_s``."""
    seconds, by = roofline.bound_s(flops, nbytes)
    return seconds * 1e3, by


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
    """Operations of B1's solve on the problems of ``obs`` (B, K, 7), whose
    slots of flag < 0.5 hold circles (``roofline.b1_flops``)."""
    circles = int((obs[..., 6] < 0.5).sum())
    return roofline.b1_flops(circles, obs.shape[0] * obs.shape[1], obs.shape[0], active_rows)


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
    # the captured step's warm-up run (before its capture) launched the kernel too
    warmup = c.step_object().warmup_launches.get(counter.__name__, 0)
    passed, dmin = passes_waypoints(torch.stack(xs).cpu().numpy())
    fallbacks = len(log.records) + len(mpc_cbf._FUSED_FALLBACK_SEEN) - seen
    name = robot_spec["model"]
    print(f"phase {phase} [{card}] single robot, {name} {pos_controller} through "
          f"LocalTrackingController(device='cuda'): {len(rets)} control steps, last code "
          f"{rets[-1]}, {rets.count(tracking.RET_INFEASIBLE)} infeasible, kernel launches "
          f"{launches} ({warmup} of them the graph's warm-up run), fused fallbacks logged "
          f"{fallbacks}, least distance to waypoints 2-4 "
          + ", ".join(f"{d:.3f}" for d in dmin)
          + f" m; {ms:.3f} ms a control step (host clock) against the 50 ms period; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if not (rets[-1] == tracking.RET_DONE and tracking.RET_INFEASIBLE not in rets and passed
            and launches == len(rets) + warmup and fallbacks == 0):
        raise SystemExit(f"phase {phase} failed: the {name} {pos_controller} scenario did not "
                         f"complete cleanly through the kernel")
    return len(rets), ms


def replay(cfg, spec, st0, traj, args_at, qp):
    """A fleet run's first steps again, one at a time, from ``st0``:
    ``tracking.step(cfg, spec, state, *args_at(i))`` for step i.  Returns the
    kernel's ms a step (CUDA events around B2's or B3's launch), whether the
    states equal the run's ``traj``, and for the first N_GENERAL robots each
    step's max |du| against the same step with the kernel's plain version
    bound in its place (per-robot waypoints and obstacles, the 3-D
    arguments, are cut to those robots too)."""
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
            return tuple(a[:k] if isinstance(a, torch.Tensor) and a.dim() == 3 else a
                         for a in args)

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
        b2_bound, b2_by = bound(b2_flops(FLEET, qn, qm, cfg.qp_iters), b2_bytes(FLEET, qn, qm))
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


def b3_build_report(ptxas: str, shapes: dict) -> tuple:
    """Phase 9: per model, the fused kernel's instantiation that its
    configuration in ``shapes`` (model -> (spec, MPCConfig)) launches, as a
    line: threads a block, registers, stack and spills, dynamic shared
    memory, blocks an SM; and per model the wide instantiation's (registers,
    stack and spills).  Exits unless every model has its three: the shared
    layout in one warp and in 128 threads, and the wide one."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    report, wide_ptxas, kinds = {}, {}, {}
    with UnitWeights():  # to size Manipulator2D's parameter block
        for model, wide, threads, regs, frame in fused_ptxas(ptxas):
            kinds.setdefault(model, set()).add((wide, threads))
            sp, cf = shapes[model]
            if wide:
                wide_ptxas[model] = (regs, frame)
                continue
            if threads != mf.block_threads(model, sp, entry.DT, cf):
                continue  # not the instantiation this configuration launches
            smem = mf.shared_memory_bytes(model, sp, entry.DT, cf)
            per_sm = mf.blocks_per_sm(model, sp, entry.DT, cf)
            report[model] = (f"{model} N={cf.horizon}: {threads}-thread blocks, {regs}, "
                             f"{frame}, {smem} bytes dynamic shared, {per_sm} blocks an SM")
    three = {(False, mf.WARP), (False, mf.MAX_DECISION), (True, mf.MAX_DECISION)}
    if (set(report) != set(mf.MODEL_IDS) or set(wide_ptxas) != set(mf.MODEL_IDS)
            or any(kinds[model] != three for model in mf.MODEL_IDS)):
        raise SystemExit("phase 9 failed: not every model has its three fused kernel "
                         "instantiations (shared memory in one warp and in 128 threads, and "
                         "the wide layout's workspace)")
    return report, wide_ptxas


def b3_pair(label, model, sp, args, cf, errs, active=None, bits=None, plain_ms=None):
    """B3 against its plain version on ``args``: gated in the kernel
    envelope, printed, the largest difference appended to ``errs`` (and
    whether the bits agree to ``bits``, when given); the plain version's
    activation tests counted by ``active`` when given, and its wall
    milliseconds appended to ``plain_ms`` when given.  Returns the
    kernel's result."""
    import contextlib

    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    kern = mf.solve_fused_batch(model, sp, *args, entry.DT, cf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with active if active is not None else contextlib.nullcontext():
        plain = mf.solve_fused_batch_reference(model, sp, *args, entry.DT, cf)
    torch.cuda.synchronize()
    if plain_ms is not None:
        plain_ms.append((time.perf_counter() - t0) * 1e3)
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
            n, m = mdl.N_STATES, mdl.N_CONTROLS
            ops = b3_flops(BATCH, n, m, 10, 5, nc, step_ops, active.total(), h_ops, mdl.REL_DEG)
            bnd, by = bound(ops, b3_bytes(BATCH, n, m, 10, 5))
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
    b2_bound, b2_by = bound(b2_flops(FLEET, qn, qm, cfg.qp_iters), b2_bytes(FLEET, qn, qm))
    print(f"phase 17 [{card}] fleet, {model} cbf_qp among 8 moving obstacles: "
          f"tracking.run_dynamic of {DYN_STEPS} steps at B={FLEET}, QP kernel launches "
          f"{launches}; {FLEET * DYN_STEPS / wall:.1f} robot-steps/s, {step_ms:.3f} ms a step, "
          f"B2 {kernel_ms:.4f} ms a step (n={qn}, m={qm}, {b2_shape(FLEET, qn, qm)}: bound "
          f"{b2_bound:.4f} ms by {b2_by}, "
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


def manipulator_inputs(dev):
    """Manipulator2D's CBF-QP inputs at B=4096, from ``default_rng(0)``:
    (name, spec, model, x, u_ref, obstacles)."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.dynamics import get_model

    name = "Manipulator2D"
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.2, 1.2, (BATCH, 3)), dtype=torch.float32, device=dev)
    u_ref = torch.as_tensor(rng.uniform(-2.0, 2.0, (BATCH, 3)), dtype=torch.float32, device=dev)
    obs = pad_obstacles(ARM_OBSTACLES, 5, device=dev)[None].repeat(BATCH, 1, 1)
    return name, make_spec(name), get_model(name), x, u_ref, obs


def finish_bytes(B, n, m):
    """Bytes the finish kernel must move: a problem's inputs (P, q, A, l, u,
    their scaled copies, d, e, x, y) and outputs (x, y, two residuals) in
    float32; 520 B at n=2, m=10."""
    return 4.0 * B * (2 * n * n + 4 * n + 2 * m * n + 6 * m + n + m + 2)


def finish_check(label, data, x, y, scaled):
    """The finish kernel against ``_finish_plain`` on one set of inputs:
    (bit-identical in x, y and both residuals, max |difference|)."""
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    got = qpk._finish_cuda(*data, scaled, x, y, True)
    want = qpk._finish_plain(*data, scaled, x, y, True)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max((g - w).abs().nan_to_num(float("inf")).max().item() for g, w in zip(got, want))
    if not same:
        raise SystemExit(f"the finish kernel disagrees with _finish_plain ({label}): "
                         f"max |difference| {err:.3e}")
    return same, err


def finish_kernel(dev, card, qp_data):
    """Phase 8b: the finish kernel against its plain version, bit for bit in
    x, y and both residuals, on B2's iterates at the CUDA path's shapes:
    the CBF-QP path (n=2, m=7, B=4096, one thread a problem), and one block
    a problem at n=2 and n=3 with m=13 (B=4096), Manipulator2D's CBF-QP
    (n=3, m=118, B=4096), and random QPs at m=153 (B=256) and 300 rows
    (B=64).  Each is timed against the general path's ``qp.finish`` on the
    same inputs.  Returns (launches counted, [shape dicts], the plain
    version's ms at the first shape)."""
    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.solvers import cbf_qp, qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    name, spec, model, ax, au, aobs = manipulator_inputs(dev)
    arm = cbf_qp._assemble(model, name, spec, ax, au, aobs, entry.DT, "cbf")[:5]
    cases = [("CBF-QP", qp_data, 1600), ("random", wide_qps(dev, BATCH, 2, 13), 1600),
             ("random", wide_qps(dev, BATCH, 3, 13), 1600), ("Manipulator2D CBF-QP", arm, 1600),
             ("random", wide_qps(dev), 300), ("random", wide_qps(dev, 64, 2, 300), 300)]
    qpk.FINISH_LAUNCH_COUNT = 0
    shapes, plain_ms = [], None
    for label, data, iters in cases:
        B, m, n = data[2].shape
        scaled = qp.equilibrate(*data)
        x, y = qpk._sweep_cuda(*scaled[:5], iters, 1.0, 1e-6, 1.6)
        shape = f"{label} n={n} m={m} B={B}"
        same, err = finish_check(shape, data, x, y, scaled)
        ms = sync_time(lambda: qpk._finish_cuda(*data, scaled, x, y, True), 10)
        qp.finish(*data, scaled, x, y, True)  # its first call sets up the batched LU
        general_ms = sync_time(lambda: qp.finish(*data, scaled, x, y, True), 10)
        if plain_ms is None:
            plain_ms = sync_time(lambda: qpk._finish_plain(*data, scaled, x, y, True), 1)
        bnd, by = bound(0.0, finish_bytes(B, n, m))
        shapes.append({"shape": shape, "ms": ms, "general_ms": general_ms, "bound_ms": bnd,
                       "bound_by": by, "max_abs_err": err})
        work = _build.load_qp_finish_kernel().qp_finish_workspace(B, n, m)
        print(f"phase 8b [{card}] the finish kernel at {shape} ({iters} iterations, "
              f"workspace {4 * work / 2**20:.1f} MiB), bit-identical to _finish_plain {same}: "
              f"{ms:.4f} ms a launch vs the general "
              f"path's qp.finish {general_ms:.4f} ms ({general_ms / ms:.1f}x); bound "
              f"{bnd:.4f} ms by {by}")
    return len(cases), shapes, plain_ms


def manipulator_cbf_qp(dev, card):
    """Phase 18: the Manipulator2D CBF-QP (n=3, m=118) through B2 at B=4096.
    Returns the JSON shape."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.solvers import cbf_qp, qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    name, spec, model, x, u_ref, obs = manipulator_inputs(dev)
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
    bnd, by = bound(ops, b2_bytes(BATCH, n, m))
    print(f"phase 18 [{card}] Manipulator2D CBF-QP through cbf_qp.solve_batch at B={BATCH} "
          f"(n={n}, m={m}: {b2_shape(BATCH, n, m)}): QP kernel launches "
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
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        mpc_cbf.solve_dispatch(vt, vspec, x, gl, ob, up, st, entry.DT, rti)
    print(f"phase 19d [{card}] MPCConfig.rti (2x2), VTOL2D N=30 (M=120, the general solve, "
          f"factored and substituted in D steps), one robot, {RTI_STEPS} warm-started steps: "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" ms a step (host clock, eager) against the 50 ms period, finite {rti_ok}; "
          f"{Count.n} aten dispatches a solve (host-bound; phase 28 replays it as one CUDA "
          f"graph); phase {time.perf_counter() - t_phase:.1f} s")
    if not rti_ok:
        raise SystemExit("phase 19d failed: the RTI solve diverged")


# The drift scenario of tests/drift_scenario_common.py: a five-lane straight
# track, the ego car in lane 1 at 10 m/s, the backup lane 3, two obstacle
# cars moving ahead; the VehicleConfig of the reference's drift example.
DRIFT_DT = 0.05
DRIFT_LANE_W, DRIFT_LANES, DRIFT_TRACK = 4.0, 5, 300.0
DRIFT_EGO, DRIFT_MIDDLE, DRIFT_BACKUP = 1, 2, 3
DRIFT_TF = 5.0  # 100 steps (160 before phases 28-31); x passes 40 m near step 80
DRIFT_BACKUPCBF_STEPS = 5
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
            n, m = mdl.N_STATES, mdl.N_CONTROLS
            ops = b3_flops(BATCH, n, m, 10, 5, nc, step_ops, active.total(), h_ops, mdl.REL_DEG)
            bnd, by = bound(ops, b3_bytes(BATCH, n, m, 10, 5))
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
                                          lambda i: (wps, 2, obs_seq[i]), True)
    step_ms = wall / SWEEP_STEPS * 1e3
    qn, qm = 2, cfg.num_obs + 2
    b2_bound, b2_by = bound(b2_flops(SWEEP_BATCH, qn, qm, cfg.qp_iters),
                            b2_bytes(SWEEP_BATCH, qn, qm))
    print(f"phase 21 [{card}] Monte Carlo DPCBF sweep, {SWEEP_BATCH} scenarios x {SWEEP_STEPS} "
          f"steps (parallel.monte_carlo.run_sweep_chunk): QP kernel launches {launches} "
          f"({launches / SWEEP_STEPS:.3f} a step); success {100 * succ:.2f}%, collision "
          f"{100 * coll:.2f}%; min h (least clearance, m) min {q[0]:.4f}, p5 {q[1]:.4f}, "
          f"median {q[2]:.4f}, p95 {q[3]:.4f}, max {q[4]:.4f}; {SWEEP_BATCH / wall:.1f} "
          f"scenarios/s ({SWEEP_BATCH * SWEEP_STEPS / wall:.1f} scenario-steps/s), "
          f"{step_ms:.3f} ms a step, B2 {kernel_ms:.4f} ms a step (n={qn}, m={qm}, "
          f"{b2_shape(SWEEP_BATCH, qn, qm)}; bound {b2_bound:.4f} ms by "
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


def sweep_scale_b2(dev, card):
    """Phase 21b: B2 at the DPCBF sweep's benchmark scale, 2^19 scenarios
    (the cell ``dpcbf_sweep.mc512k``, the one-lane shape at n=2, m=10, 400
    iterations).  The QPs are the sweep's own: those of its first step,
    taken at B2's launch.  x and y of one launch against the plain sweep on
    a seeded sample of 4,096 problems and the first and last blocks': bit
    for bit, else the phase fails.  The launch alone is timed.  Then the
    finish kernel on the same step's inputs against ``_finish_plain`` on
    every problem, bit for bit, timed beside ``qp.finish``.  Returns (ms,
    bound, its kind, max |dx|, max |dy|, shape in words, the finish's shape
    dict)."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.parallel import monte_carlo as mc
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    B = 2**19
    model = "KinematicBicycle2D_DPCBF"
    spec = make_spec(model, a_max=5.0, radius=0.3)
    cfg = tracking.TrackerConfig(model_name=model, pos_controller="cbf_qp", dt=0.05, num_obs=8,
                                 qp_iters=400)
    wps = torch.tensor(DYN_WAYPOINTS, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2**31 + 21)
    st0 = mc.dpcbf_sweep_init(cfg, spec, gen, B, wps, device=dev)
    seen, seen_fin, sweep_cuda, finish_cuda = [], [], qpk._sweep_cuda, qpk._finish_cuda
    qpk._sweep_cuda = lambda *a: seen.append(a) or sweep_cuda(*a)
    qpk._finish_cuda = lambda *a: seen_fin.append(a) or finish_cuda(*a)
    try:
        tracking.step(cfg, spec, st0.tracker, wps, 2, st0.obs)
    finally:
        qpk._sweep_cuda, qpk._finish_cuda = sweep_cuda, finish_cuda
    if len(seen) != 1:
        raise SystemExit(f"phase 21b failed: the sweep's step made {len(seen)} B2 launches")
    scaled, args = seen[0][:5], seen[0][5:]
    _, qm, qn = scaled[2].shape
    counts = (qpk.LAUNCH_COUNT, qpk.LANE_LAUNCH_COUNT)
    x, y = sweep_cuda(*scaled, *args)
    lane = (qpk.LAUNCH_COUNT - counts[0], qpk.LANE_LAUNCH_COUNT - counts[1])
    per_block = qpk.THREADS // qpk.launch_shape(B, qn, qm)[0]
    rng = np.random.default_rng(2**31 + 29)
    rows = sorted(set(rng.choice(B, 4096, replace=False).tolist())
                  | set(range(per_block)) | set(range(B - per_block, B)))
    idx = torch.tensor(rows, device=dev)
    x_p, y_p = qpk._sweep_plain(*(t[idx] for t in scaled), *args)
    same = torch.equal(x[idx], x_p) and torch.equal(y[idx], y_p)
    dx = (x[idx] - x_p).abs().max().item()
    dy = (y[idx] - y_p).abs().max().item()
    ms = sync_time(lambda: sweep_cuda(*scaled, *args), 10)
    b2_bound, b2_by = bound(b2_flops(B, qn, qm, args[0]), b2_bytes(B, qn, qm))
    shape = b2_shape(B, qn, qm)
    print(f"phase 21b [{card}] B2 at the DPCBF sweep's benchmark scale: the QPs of the first "
          f"step of {B} scenarios (n={qn}, m={qm}, {args[0]} iterations), {shape}, "
          f"{-(-B // per_block)} blocks; launches counted (all, one lane) {lane}; against "
          f"the plain sweep on {len(rows)} problems (the first and last {per_block} among "
          f"them) max|dx| {dx:.3e}, max|dy| {dy:.3e}, bit-identical {same}; {ms:.4f} ms a "
          f"launch, bound {b2_bound:.4f} ms by {b2_by}, {100 * b2_bound / ms:.2f}% of it "
          f"reached; phase {time.perf_counter() - t_phase:.1f} s")
    if not same or not (torch.isfinite(x).all() and torch.isfinite(y).all()):
        raise SystemExit("phase 21b failed: B2 at 2^19 disagrees with the plain sweep")
    if lane != (1, 1):
        raise SystemExit(f"phase 21b failed: the launch did not count as one lane: {lane}")
    # the finish kernel on the same step's inputs (B2's iterate), every problem
    if len(seen_fin) != 1:
        raise SystemExit(f"phase 21b failed: the sweep's step made {len(seen_fin)} finish launches")
    fdata, fscaled, fx, fy = seen_fin[0][:5], *seen_fin[0][5:8]
    fsame, ferr = finish_check(f"DPCBF sweep B={B}", fdata, fx, fy, fscaled)
    fin_ms = sync_time(lambda: qpk._finish_cuda(*fdata, fscaled, fx, fy, True), 10)
    qp.finish(*fdata, fscaled, fx, fy, True)
    general_ms = sync_time(lambda: qp.finish(*fdata, fscaled, fx, fy, True), 10)
    fbnd, fby = bound(0.0, finish_bytes(B, qn, qm))
    print(f"phase 21b [{card}] the finish kernel on the same step's {B} problems: bit-identical "
          f"to _finish_plain {fsame}; {fin_ms:.4f} ms a launch vs the general path's qp.finish "
          f"{general_ms:.4f} ms; bound {fbnd:.4f} ms by {fby}, {100 * fbnd / fin_ms:.2f}% of it "
          f"reached")
    return (ms, b2_bound, b2_by, dx, dy, f"DPCBF sweep n={qn} m={qm} B={B}: {shape}",
            {"shape": f"DPCBF sweep n={qn} m={qm} B={B}", "ms": fin_ms, "general_ms": general_ms,
             "bound_ms": fbnd, "bound_by": fby, "max_abs_err": ferr})


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
    N=30 and 12x4, DRIFT_TF): no collision and x_final[0] > 40; the first
    replayed step against the capture's warm-up, an eager step on the card
    (within 1e-6); then the backup-CBF configuration for
    DRIFT_BACKUPCBF_STEPS replayed steps (finite, no collision).  Returns a
    dict of the numbers."""
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
    # the first replay against the capture's warm-up, an eager step on the
    # card from the same inputs: the next state x (the report's first 8)
    so = sim._step
    eager_ms = so.warmup_seconds * 1e3
    dx_first = float((so.static_out[-1][:8] - so.warmup_out[-1][:8]).abs().max())
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
          f"50 ms period, an eager step on the card (the capture's warm-up) {eager_ms:.1f} ms; "
          f"graph nodes {nodes}; first step replay vs eager max|dx| {dx_first:.3e}")
    if sim.stats["collision"] or not xf[0] > 40.0:
        raise SystemExit("phase 23 failed: the drift scenario collided or made no progress")
    if not dx_first <= 1e-6:
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


WAREHOUSE_LEVELS = range(1, 8)
# tests/test_warehouse_e2e.py's BCBF_EXPECTED: the stop backup survives level 1 only
BCBF_EXPECTED = {1: "reached", 2: "collision", 3: "collision", 4: "collision", 5: "collision",
                 6: "collision", 7: "collision"}
CORRIDOR_STEPS = 200  # tests/test_fleet.py's 10 s
FLEET_ANCHOR = 4096  # examples/heterogeneous_fleet.py's defaults: --n 4096 --steps 200 --chunk 10
FLEET_ANCHOR_STEPS = 200
FLEET_ANCHOR_CHUNK = 10
SHIELDED_ROWS = 2048  # bench.py::bench_fleet_shielded: 4096 agents, 17 chunks of 4 steps
SHIELDED_CHUNKS = 17


def warehouse(dev, card):
    """Phase 24: the warehouse case study through ``sim.warehouse_sim``'s
    captured CUDA graphs: the gatekeeper at every level (no collision, min h
    > -0.05, shields engaged, past the first leg), BackupCBF reaching the goal
    at level 1 and colliding at levels 2-7; the first step of each strategy
    replayed against an eager one (within 1e-6), BackupCBF's first step from
    rest on the JAX package's branch (the QP fails, the nominal [3, 0] is
    applied).  Returns a dict of the numbers."""
    import numpy as np

    from safe_control_tpu_torch.envs.warehouse_env import WarehouseEnv
    from safe_control_tpu_torch.shielding import gatekeeper as gk
    from safe_control_tpu_torch.sim import warehouse_sim as ws

    t_phase = time.perf_counter()
    env = WarehouseEnv(level=1, dt=ws.DT, device=dev)
    spots = ws.padded_spots(env)
    x0 = torch.tensor([[10.0, 10.0, 0.0, 0.0]], device=dev)
    goal = torch.tensor([[30.0, 10.0]], device=dev)  # waypoint 1
    ghosts = env.ghosts
    inputs = {"gatekeeper": lambda: (gk.init_state(ws.GK_CFG, 1, device=dev), x0, goal, ghosts,
                                     spots),
              "backup_cbf": lambda: (x0, goal, ghosts)}
    first = {}
    for name, make in inputs.items():
        eager = ws.step_object(name, dev, graph=False)
        eager(*make())  # first use of every op
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep_e = eager(*make())[-1].cpu()
        eager_ms = (time.perf_counter() - t0) * 1e3
        graphed = ws.step_object(name, dev)
        t0 = time.perf_counter()
        rep_g = graphed(*make())[-1].cpu()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(20):
            graphed(*make())[-1].cpu()
        replay_ms = (time.perf_counter() - t0) / 20 * 1e3
        first[name] = dict(eager_ms=eager_ms, first_s=first_s, capture_s=graphed.capture_seconds,
                           replay_ms=replay_ms, dx=(rep_e - rep_g).abs().max().item(),
                           report=rep_g.numpy())
        capture = "no graph" if graphed.capture_seconds is None else \
            f"captured in {graphed.capture_seconds:.2f} s"
        print(f"phase 24 [{card}] warehouse {name} step: eager on the card {eager_ms:.1f} ms, "
              f"{capture} (the first step {first_s:.2f} s), "
              f"{replay_ms:.2f} ms a replayed step (host clock, the host read included); first "
              f"step replay vs eager max|d| {first[name]['dx']:.3e}")
    b0 = first["backup_cbf"]["report"]  # x1 (4), u (2), h_min, qp_ok, using_backup
    rest_ok = bool(b0[7] == 0.0 and b0[8] == 0.0 and np.abs(b0[4:6] - [3.0, 0.0]).max() < 1e-6
                   and abs(b0[6] - 1.0) < 1e-6)
    print(f"phase 24 [{card}] BackupCBF from rest at level 1: u {b0[4:6].tolist()}, qp_ok "
          f"{bool(b0[7])}, using_backup {bool(b0[8])}, h_min {b0[6]:.6f} (the JAX package: "
          f"[3, 0], False, False, 1.0)")

    # Every level of both strategies at once, each in a host thread on a
    # CUDA stream of its own: one level's step is a graph of small kernels
    # that leaves most of the card idle.  warehouse_sim keeps one captured
    # step per stream; capture each one up front, one at a time, since a
    # capture must not overlap other work on the card.
    jobs = [(name, run, level, torch.cuda.Stream(dev))
            for name, run in (("gatekeeper", ws.run_gatekeeper_level),
                              ("backup_cbf", ws.run_backup_cbf_level))
            for level in WAREHOUSE_LEVELS]
    t0 = time.perf_counter()
    for name, _, _, stream in jobs:
        with torch.cuda.stream(stream):
            ws.step_object(name, dev)(*inputs[name]())
    torch.cuda.synchronize()
    captures_s = time.perf_counter() - t0

    def level_run(name, run, level, stream):
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            r = run(level, device=dev)
            return name, level, r, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = [f.result() for f in [pool.submit(level_run, *job) for job in jobs]]
    levels_s = time.perf_counter() - t0
    rows, ok = [], rest_ok and all(v["dx"] <= 1e-6 for v in first.values())
    for name, level, r, secs in done:
        if name == "gatekeeper":
            good = (r["outcome"] != "collision" and r["min_h"] > -0.05
                    and r["backup_steps"] > 0 and r["wp_i"] >= 2)
        else:
            good = r["outcome"] == BCBF_EXPECTED[level]
            if level == 1:
                good = good and r["min_h"] > -0.05 and r["min_rollout_h"] < 3.0
        ok = ok and good
        rows.append((name, level, r, secs))
        extra = (f"backup steps {r['backup_steps']}" if name == "gatekeeper"
                 else f"min rollout h {r['min_rollout_h']:.4f}")
        print(f"phase 24 [{card}] {name} level {level}: {r['outcome']} after "
              f"{r['steps']} steps, waypoint {r['wp_i']}, min h {float(r['min_h']):.4f}, "
              f"{extra}; {secs:.2f} s ({secs / (r['steps'] + 1) * 1e3:.2f} ms a step beside "
              f"the other level runs, the level's safe spots included)"
              f"{'' if good else ' FAILED'}")
    print(f"phase 24 [{card}] {len(jobs)} captures {captures_s:.1f} s, then the {len(jobs)} "
          f"level runs at once {levels_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not ok:
        raise SystemExit("phase 24 failed: a warehouse run missed the JAX package's predicates")
    return dict(first=first, rows=rows)


def device_summary(prof, window_s):
    """(busy share of the window, [(kernel, launches, ms)] of the five
    longest by total time) from a ``torch.profiler`` run's CUDA events;
    (None, []) when the trace holds no device time."""
    by_name, busy_us = {}, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    if busy_us == 0.0:
        return None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return busy_us * 1e-6 / window_s, [(k, n, t * 1e-3) for k, (n, t) in top]


def heterogeneous_fleet(dev, card):
    """Phase 25: the tracked heterogeneous fleet (``parallel.fleet``, B2
    once a group a step): ``tests/test_fleet.py``'s 24 robots for 200 steps
    (no infeasible step or collision, closest pair > 0.45 m), then anchor 5
    at ``examples/heterogeneous_fleet.py``'s defaults (3 x 1365 robots, 200
    steps in chunks of 10): 3 B2 launches a step, finite states, each
    group's first 64 robots' first 20 controls within QP_U_TOL of the steps
    replayed with B2's plain version; one chunk traced.  Returns a dict."""
    import numpy as np

    from safe_control_tpu_torch.parallel import fleet as fl
    from safe_control_tpu_torch.parallel import fleet_scenarios as fs
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import qp_kernel as qpk
    from safe_control_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    groups, specs, x0s, wps, n_wps, known = fs.corridor_fleet(dev)
    state = fl.init_fleet(groups, specs, x0s, [w[:, 0] for w in wps])
    t0 = time.perf_counter()
    for _ in range(CORRIDOR_STEPS):
        state = fl.step_fleet(groups, specs, state, wps, n_wps, known, True, 1, 0.5)
    stats_c = fl.fleet_stats(groups, state)
    pos = fl.fleet_positions(groups, state)
    d = torch.cdist(pos[:, :2].double(), pos[:, :2].double())
    d.fill_diagonal_(float("inf"))
    min_pair = d.min().item()
    corridor_s = time.perf_counter() - t0
    corridor_ok = stats_c["infeasible_or_collision"] == 0 and min_pair > 0.45
    print(f"phase 25 [{card}] corridor fleet (tests/test_fleet.py, 24 robots, {CORRIDOR_STEPS} "
          f"steps, chunk 1, "
          f"margin 0.5): {stats_c}, closest pair {min_pair:.4f} m; {corridor_s:.2f} s")

    groups, specs, x0s, wps, n_wps, known = fs.lattice_fleet(FLEET_ANCHOR, dev)
    chunk = FLEET_ANCHOR_CHUNK
    total = sum(g.count for g in groups)

    def step(s):
        return fl.step_fleet(groups, specs, s, wps, n_wps, known, True, chunk, 0.3)

    state = step(fl.init_fleet(groups, specs, x0s, [w[:, 0] for w in wps]))  # the first chunk
    torch.cuda.synchronize()
    s0 = state
    qpk.LAUNCH_COUNT = 0
    t0 = time.perf_counter()
    for _ in range(FLEET_ANCHOR_STEPS // chunk):
        state = step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qpk.LAUNCH_COUNT
    step_ms = wall / FLEET_ANCHOR_STEPS * 1e3
    finite = all(bool(torch.isfinite(t.x).all()) for t in state.trackers)
    stats = fl.fleet_stats(groups, state)
    progress = [t.goal_idx.float().mean().item() for t in state.trackers]

    # the first two timed chunks again, group by group, recording each step
    trajs, obs_chunks, s = [[] for _ in groups], [], s0
    for _ in range(2):
        obs = fl.coupling_obstacles(groups, s, known, 0.3)
        obs_chunks.append(obs)
        new = []
        for gi, g in enumerate(groups):
            st_g, tr = tracking.run(g.cfg, specs[gi], s.trackers[gi], wps[gi], n_wps[gi],
                                    obs[gi], chunk)
            trajs[gi].append(tr)
            new.append(st_g)
        s = fl.FleetState(tuple(new))
    fleet_two = step(step(s0))
    same_run = all(torch.equal(a.x, b.x) for a, b in zip(s.trackers, fleet_two.trackers))
    per_group = []
    for gi, g in enumerate(groups):
        traj = {k: torch.cat([t[k] for t in trajs[gi]], dim=1) for k in ("x", "u")}
        kernel_ms, same_x, dev_plain = replay(
            g.cfg, specs[gi], s0.trackers[gi], traj,
            lambda i, gi=gi: (wps[gi], n_wps[gi], obs_chunks[i // chunk][gi]), True)
        qn, qm = 2, g.cfg.num_obs + 2
        b2_bound, b2_by = bound(b2_flops(g.count, qn, qm, g.cfg.qp_iters),
                                b2_bytes(g.count, qn, qm))
        per_group.append(dict(model=g.cfg.model_name, B=g.count, n=qn, m=qm, ms=kernel_ms,
                              bound_ms=b2_bound, bound_by=b2_by, same_x=same_x,
                              max_abs_err=max(dev_plain)))
    b2_ms = sum(p["ms"] for p in per_group)

    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    with profiling.trace_to("build/trace_fleet") as prof:
        t0 = time.perf_counter()
        step(state)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    trace_s = time.perf_counter() - t_trace
    busy, top = device_summary(prof, window)
    print(f"phase 25 [{card}] anchor 5 (examples/heterogeneous_fleet.py): {total} agents "
          f"({' + '.join(str(g.count) for g in groups)}), {FLEET_ANCHOR_STEPS} steps in chunks of "
          f"{chunk}: {total * FLEET_ANCHOR_STEPS / wall:.1f} agent-steps/s, {step_ms:.3f} ms a "
          f"step, QP kernel launches {launches} ({launches / FLEET_ANCHOR_STEPS:.2f} a step); "
          f"mean waypoint progress per family (of 4) "
          + ", ".join(f"{p:.3f}" for p in progress) + f"; {stats}; finite {finite}")
    for p in per_group:
        print(f"phase 25 [{card}] B2 at {p['model']} (n={p['n']}, m={p['m']}, B={p['B']}, "
              f"400 iterations, {b2_shape(p['B'], p['n'], p['m'])}): {p['ms']:.4f} ms a launch, "
              f"bound {p['bound_ms']:.4f} ms by "
              f"{p['bound_by']}, {100 * p['bound_ms'] / p['ms']:.2f}% of it reached; replayed "
              f"states equal the run's {p['same_x']}, max|du| of {N_GENERAL} robots against the "
              f"plain version over {REPLAY['cbf_qp']} steps {p['max_abs_err']:.3e}")
    busy_txt = "not measured (no device time in the trace)" if busy is None else \
        f"{100 * busy:.1f}%"
    print(f"phase 25 [{card}] B2 {b2_ms:.3f} ms of a {step_ms:.3f} ms step "
          f"({100 * b2_ms / step_ms:.1f}%); the two replayed chunks equal step_fleet's "
          f"{same_run}; one traced chunk ({window * 1e3:.1f} ms with the profiler on): device "
          f"busy {busy_txt}; longest kernels "
          + "; ".join(f"{k[:60]} x{n} {ms:.2f} ms" for k, n, ms in top)
          + f"; the trace and its export {trace_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not corridor_ok:
        raise SystemExit("phase 25 failed: the corridor fleet collided or went infeasible")
    if launches != len(groups) * FLEET_ANCHOR_STEPS or not finite:
        raise SystemExit("phase 25 failed: the anchor fleet did not make one B2 launch a group "
                         "a step, or diverged")
    if not (same_run and all(p["same_x"] and p["max_abs_err"] < QP_U_TOL for p in per_group)):
        raise SystemExit("phase 25 failed: the anchor fleet disagrees with B2's plain version")
    return dict(launches=launches, step_ms=step_ms, groups=per_group, b2_ms=b2_ms,
                rate=total * FLEET_ANCHOR_STEPS / wall)


def shielded_fleet(dev, card):
    """Phase 26: the gatekeeper-shielded fleet (``parallel.fleet``):
    ``tests/test_fleet_shielded.py``'s two walls of 32 robots (24 chunks of
    5) and its head-on pair (30 chunks of 5) to that file's predicates, then
    ``bench.py``'s 4,096-agent three-family anchor (17 chunks of 4 steps,
    8 neighbours): collision-free after every chunk, shields engaged.
    Returns a dict."""
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.parallel import fleet as fl
    from safe_control_tpu_torch.parallel import fleet_scenarios as fs

    t_phase = time.perf_counter()

    def drive(groups, specs, state, wps, n_wps, known, chunks, n_steps, k):
        min_clear = float("inf")
        for _ in range(chunks):
            state = fl.step_fleet_shielded(groups, specs, state, wps, n_wps, known,
                                           n_steps=n_steps, k_neighbors=k)
            min_clear = min(min_clear, fl.min_pairwise_clearance(groups, state))
        return state, min_clear, fl.shielded_fleet_stats(groups, state)

    groups, specs, x0s, wps, n_wps, known = fs.two_walls(32, dev)
    t0 = time.perf_counter()
    st, walls_clear, walls = drive(groups, specs, fl.init_shielded_fleet(groups, x0s), wps, n_wps,
                                   known, 24, 5, 4)
    adv = (st.x[0][:, 0].max().item(), st.x[1][:, 0].min().item())
    walls_ok = (walls_clear > 0.0 and walls["backup_steps"] > 0 and walls["commits"] > 0
                and adv[0] > 1.0 and adv[1] < 7.0)
    walls_s = time.perf_counter() - t0
    groups1, specs1 = fs.two_walls(1, dev)[:2]
    pair_x0 = [torch.tensor([[0.0, 0.0, 0.0, 0.5]], device=dev),
               torch.tensor([[6.0, 0.0, -0.5, 0.0]], device=dev)]
    pair_wps = [torch.tensor([[[6.0, 0.0]]], device=dev), torch.tensor([[[0.0, 0.0]]], device=dev)]
    _, pair_clear, pair = drive(groups1, specs1, fl.init_shielded_fleet(groups1, pair_x0),
                                pair_wps, [1, 1], pad_obstacles(torch.zeros((0, 7)), 4,
                                                                device=dev), 30, 5, 1)
    pair_ok = pair_clear > 0.0 and pair["backup_steps"] > 0
    print(f"phase 26 [{card}] two walls of 32 (tests/test_fleet_shielded.py, 120 steps): min "
          f"clearance {walls_clear:.4f} m, {walls}, furthest DU x {adv[0]:.3f}, DI x "
          f"{adv[1]:.3f}; {walls_s:.2f} s; head-on pair: min clearance {pair_clear:.4f} m, "
          f"{pair}")

    groups, specs, x0s, wps, n_wps, known = fs.three_family_anchor(SHIELDED_ROWS, dev)
    total = sum(g.count for g in groups)

    def step(s):
        return fl.step_fleet_shielded(groups, specs, s, wps, n_wps, known, n_steps=4,
                                      k_neighbors=8)

    state = step(fl.init_shielded_fleet(groups, x0s))  # the bench's first chunk
    min_clear, wall = fl.min_pairwise_clearance(groups, state), 0.0
    for _ in range(SHIELDED_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        min_clear = min(min_clear, fl.min_pairwise_clearance(groups, state))
    stats = fl.shielded_fleet_stats(groups, state)
    finite = all(bool(torch.isfinite(x).all()) for x in state.x)
    anchor_ok = min_clear > 0.0 and stats["backup_steps"] > 0 and stats["commits"] > 0 and finite
    rate = total * SHIELDED_CHUNKS * 4 / wall
    print(f"phase 26 [{card}] three-family anchor (bench.py, {total} agents: "
          f"{' + '.join(str(g.count) for g in groups)} DU + KB + DI, 17 chunks of 4 steps, 8 "
          f"neighbours): {rate:.1f} agent-steps/s ({wall / SHIELDED_CHUNKS / 4 * 1e3:.2f} ms a "
          f"step), min clearance after every chunk {min_clear:.4f} m, {stats}, finite {finite}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if not (walls_ok and pair_ok and anchor_ok):
        raise SystemExit("phase 26 failed: a shielded fleet collided or its shields never engaged")
    return dict(rate=rate, min_clear=min_clear, stats=stats)


def multi_device(dev, card):
    """Phase 27: the multi-device path on the card, a NCCL process group of
    world size 1 on an in-process store: ``run_sharded_sweep`` (256 DPCBF
    scenarios, 20 steps in chunks of 10) and ``step_fleet_shielded_sharded``
    (two walls of 16, 4 chunks of 3) equal to the single-device paths bit
    for bit."""
    import torch.distributed as dist

    from safe_control_tpu_torch.core.spec import make_spec
    from safe_control_tpu_torch.parallel import fleet as fl
    from safe_control_tpu_torch.parallel import fleet_scenarios as fs
    from safe_control_tpu_torch.parallel import mesh as mesh_mod
    from safe_control_tpu_torch.parallel import monte_carlo as mc
    from safe_control_tpu_torch.sim import tracking

    t_phase = time.perf_counter()
    leaves = torch.utils._pytree.tree_leaves
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = mesh_mod.scenario_mesh(1, device=dev)
        model = "KinematicBicycle2D_DPCBF"
        spec = make_spec(model, a_max=5.0, radius=0.3)
        cfg = tracking.TrackerConfig(model_name=model, pos_controller="cbf_qp", dt=0.05,
                                     num_obs=8, qp_iters=400)
        wps = torch.tensor(DYN_WAYPOINTS, dtype=torch.float32, device=dev)
        st0 = mc.dpcbf_sweep_init(cfg, spec, torch.Generator(device=dev).manual_seed(1), 256,
                                  wps, device=dev)
        single = st0
        for _ in range(2):
            single = mc.run_sweep_chunk(cfg, spec, single, wps, 2, 10)
        final, res = mc.run_sharded_sweep(mesh, cfg, spec, st0, wps, 2, 20, chunk=10)
        sweep_same = (all(torch.equal(a, b) for a, b in zip(leaves(single), leaves(final)))
                      and [float(v) for v in mc.sweep_stats(single)]
                      == [float(res.success_rate), float(res.collision_rate)])

        groups, specs, x0s, fwps, n_wps, known = fs.two_walls(16, dev)
        s_ref = fl.init_shielded_fleet(groups, x0s)
        s_sh = mesh_mod.shard_leading_axis(mesh, s_ref)
        wps_sh = mesh_mod.shard_leading_axis(mesh, fwps)
        for _ in range(4):
            s_ref = fl.step_fleet_shielded(groups, specs, s_ref, fwps, n_wps, known, n_steps=3)
            s_sh = fl.step_fleet_shielded_sharded(groups, specs, s_sh, wps_sh, n_wps, known,
                                                  mesh, n_steps=3)
        s_sh = mesh_mod.gather_leading_axis(mesh, s_sh)
        fleet_same = all(torch.equal(a, b) for a, b in zip(leaves(s_ref), leaves(s_sh)))
        stats = fl.shielded_fleet_stats(groups, s_ref)
    finally:
        dist.destroy_process_group()
    print(f"phase 27 [{card}] NCCL world size 1: run_sharded_sweep (256 scenarios, 20 steps) "
          f"equal to run_sweep_chunk bit for bit {sweep_same} (success "
          f"{float(res.success_rate):.4f}); step_fleet_shielded_sharded (2 x 16 robots, 4 "
          f"chunks of 3) equal to step_fleet_shielded bit for bit {fleet_same} ({stats}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not (sweep_same and fleet_same):
        raise SystemExit("phase 27 failed: a sharded path differs from its single-device path")
    return dict(sweep_same=sweep_same, fleet_same=fleet_same)


# ---- phases 28-31: the examples' scenarios and command lines ------------------
# tests/test_vtol_e2e.py: the pillar row at x=37, the corridor's waypoints, the
# pop-in step and the 120-step budget.
VTOL_PILLARS = [[37.0, float(y), 0.5] for y in range(6, 10)]
VTOL_WPS = [[2.0, 10.0], [45.0, 10.0]]
VTOL_POPIN = 32
VTOL_POPIN_AFTER = 55  # steps after the pop-in: the whole avoidance manoeuvre
VTOL_STEPS = 120
# Both runs stop 3 m past the pillar line (the test's runs go on to the goal
# at x=45 or their step budget): the clearance is set while passing it.
VTOL_PAST_X = 40.0
# examples/test_vtol.py --rti through the JAX package on the CPU
# (tests/test_torch_jax_script_ends.py holds this line to the script): at the
# RTI budget the route's first leg passes within the robot's 0.6 m radius of
# the (60, 12, 1.5) circle, and the collision oracle ends the run.  The
# script's 8x3 default lands.
VTOL_RTI_JAX = "final x=59.1 m, altitude z=10.2 m, ret=-2, min obstacle clearance 0.49 m"
PLAIN_STEPS = 3  # steps of each new path held against the kernel's plain version
UNKNOWN_DI_STEPS = 2400  # tests/test_unknown_env_e2e.py's 120 s
# examples/test_unknown_env.py --unknown_detection ray through the JAX
# package on the CPU (the general solve; tests/test_torch_jax_script_ends.py
# holds this line to the script): ray detection keeps no obstacle memory, and
# the run ends in a collision.
UNKNOWN_RAY_JAX = ("waypoints reached: False, collision/infeasible: True, visibility "
                   "violations: 0, unknown obstacles in memory: 0/24")
# examples.unknown_env through the general solve: seconds of the script's 120
# (a replayed DU N=7 step takes ~90 ms; a whole run would be minutes)
UNKNOWN_GENERAL_TF = 5.0


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def plain_bound(qp):
    """The kernel's plain version in its wrapper's place (a context)."""
    import contextlib

    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    counter, name = (qpk, "solve_qp_batch") if qp else (mf, "solve_fused_batch")

    @contextlib.contextmanager
    def bound():
        fn = getattr(counter, name)
        setattr(counter, name, getattr(counter, name + "_reference"))
        try:
            yield
        finally:
            setattr(counter, name, fn)

    return bound()


def checked_steps(ctrl, n, qp, errs):
    """``n`` control steps of ``ctrl`` (its captured graph on the card), each
    held against ``tracking.step`` on the same state with the kernel's plain
    version bound in its place: appends max |du| to ``errs``; returns the
    return codes."""
    from safe_control_tpu_torch.sim import tracking

    rets = []
    for _ in range(n):
        before = torch.utils._pytree.tree_map(torch.clone, ctrl.state)
        wps, n_wps, known, unknown = ctrl._device_inputs()
        rets.append(ctrl.control_step())
        with plain_bound(qp):
            u = tracking.step(ctrl.cfg, ctrl.spec, before, wps, n_wps, known, unknown).u
        errs.append(float((u[0] - torch.as_tensor(ctrl.u_pos, device=u.device)).abs().max()))
    return rets


def graph_report(ctrl):
    """``(capture s, graph nodes)`` of a controller's captured step."""
    so = ctrl.step_object()
    return (float("nan") if so.capture_seconds is None else so.capture_seconds,
            so.graph_nodes())


# examples/test_vtol.py's robot (phase 28 and, with use_fused_kernel, 28b).
VTOL_ROBOT = {"model": "VTOL2D", "radius": 0.6, "v_max": 20.0, "reached_threshold": 1.0,
              "mpc_horizon": 30, "mpc_rti": True}


def vtol_controller(dev, robot_spec):
    """A ``LocalTrackingController`` at the corridor's start, its first step
    taken (the capture on the card): returns ``(ctrl, pillar rows, s of the
    first step, max difference of the first replay from the capture's
    warm-up (an eager step on the card from the same inputs), ms of that
    eager step, capture s, graph nodes)``."""
    import numpy as np

    from safe_control_tpu_torch.envs.env import Env
    from safe_control_tpu_torch.sim.controller import LocalTrackingController

    pillars = np.hstack([np.asarray(VTOL_PILLARS), np.zeros((4, 4))])
    ctrl = LocalTrackingController([2.0, 10.0, 0.0, 20.0, 0.0, 0.0], robot_spec,
                                   controller_type={"pos": "mpc_cbf"}, dt=0.05,
                                   env=Env(width=75.0, height=20.0), device=dev)
    ctrl.obs = pillars
    ctrl.set_waypoints(np.asarray(VTOL_WPS))
    t0 = time.perf_counter()
    ctrl.control_step()
    sync(dev)
    first_s = time.perf_counter() - t0
    so = ctrl.step_object()
    dx_first = 0.0  # eager on the CPU: nothing to compare
    if so.use_graph:
        diffs = [torch.where(torch.isnan(a.double()) & torch.isnan(b.double()), 0.0,
                             (a.double() - b.double()).abs()).max()
                 for a, b in zip(torch.utils._pytree.tree_leaves(so.static_out),
                                 torch.utils._pytree.tree_leaves(so.warmup_out))]
        dx_first = float(torch.stack(diffs).max())  # NaN propagates
    eager_ms = (so.warmup_seconds or float("nan")) * 1e3
    capture_s, nodes = graph_report(ctrl)
    return ctrl, pillars, first_s, dx_first, eager_ms, capture_s, nodes


def corridor_flight(ctrl, pillars, dev, n_steps, popin=None, path=None):
    """The corridor from the controller's start: returns (x, min clearance,
    ground strike, steps, ms a replayed step); each step's (x, z) appended
    to ``path`` when given."""
    import numpy as np

    ctrl.obs = np.zeros((0, 7)) if popin else pillars
    ctrl.set_waypoints(np.asarray(VTOL_WPS))
    min_pillar, ground, x = np.inf, False, None
    t0, steps = time.perf_counter(), 0
    for t in range(n_steps):
        if popin is not None and t == popin:
            ctrl.obs = pillars  # copied into the graph's inputs, no recapture
        ctrl.control_step()
        steps += 1
        x = ctrl.robot_state
        if path is not None:
            path.append((float(x[0]), float(x[1])))
        ground = ground or x[1] <= 0.0
        if popin is None or t >= popin:
            d = min(np.hypot(x[0] - r[0], x[1] - r[1]) - r[2] for r in VTOL_PILLARS)
            min_pillar = min(min_pillar, d)
        if int(ctrl.state.goal_idx[0]) >= len(ctrl.waypoints) or x[0] > VTOL_PAST_X:
            break
    sync(dev)
    return x, min_pillar, ground, steps, (time.perf_counter() - t0) / steps * 1e3


def vtol(dev, card):
    """Phase 28: the VTOL corridor and the pop-in curve of
    ``tests/test_vtol_e2e.py`` at the RTI budget through the captured
    controller step, then ``examples.vtol --rti`` over the whole route."""
    import contextlib
    import io

    from safe_control_tpu_torch.examples import vtol as vtol_example

    t_phase = time.perf_counter()
    # examples/test_vtol.py's robot: the same configuration, so that
    # examples.vtol below replays this graph.  The test's 8 selection slots
    # become the example's 10; the MPC reads the first 5, the same rows.
    spec = VTOL_ROBOT
    ctrl, pillars, first_s, dx_first, eager_ms, capture_s, nodes = vtol_controller(dev, spec)

    def fly(n_steps, popin=None, path=None):
        return corridor_flight(ctrl, pillars, dev, n_steps, popin, path)

    path = []
    x, clear, ground, steps, replay_ms = fly(VTOL_STEPS, path=path)
    print(f"phase 28 [{card}] VTOL2D corridor (tests/test_vtol_e2e.py, pillars at x=37, "
          f"MPCConfig.rti N=30, D=120, the general solve) through the captured controller "
          f"step: {steps} steps, final x {x[0]:.2f} m z {x[1]:.2f} m, pillar clearance "
          f"{clear:.3f} m, ground strike {ground}; {replay_ms:.1f} ms a replayed step (host "
          f"clock, the host read included) against the 50 ms period, an eager step on the card "
          f"(the capture's warm-up) {eager_ms:.1f} ms; capture {capture_s:.2f} s (warm-up "
          f"included; the first step {first_s:.2f} s), graph nodes {nodes}; the first replay "
          f"vs the warm-up, max difference over the step's outputs {dx_first:.3e}")
    if ground or not x[0] > 25.0 or not clear > 0.3:
        raise SystemExit("phase 28 failed: the VTOL corridor struck the ground, stalled or "
                         "came within 0.3 m of a pillar")
    if not dx_first <= 1e-6:
        raise SystemExit("phase 28 failed: the captured step's first replay disagrees with an "
                         "eager step")
    xp, clear_p, ground_p, steps_p, popin_ms = fly(VTOL_POPIN + VTOL_POPIN_AFTER,
                                                   popin=VTOL_POPIN)
    print(f"phase 28 [{card}] pop-in (the pillars appear at step {VTOL_POPIN}, ~3 m ahead): "
          f"RTI 2x2 clearance {clear_p:.3f} m, final x {xp[0]:.2f} m, ground strike "
          f"{ground_p}, {steps_p} steps, {popin_ms:.1f} ms a step; the 8x3 point cut (its "
          f"graph is ~6x the RTI step's, minutes of the script's budget)")
    if ground_p or not xp[0] > VTOL_PILLARS[0][0] or not clear_p >= 0.5:
        raise SystemExit("phase 28 failed: the RTI pop-in curve came within 0.5 m or did "
                         "not pass the pillars")
    del ctrl
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = vtol_example.main(["--rti", "--device", dev.type])
    route_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    x_end = float(lines[0].split("x=")[1].split(" m")[0])
    clear_end = float(lines[0].split("clearance ")[1].split(" m")[0])
    print(f"phase 28 [{card}] examples.vtol --rti (the whole route to the landing point): "
          f"{' | '.join(lines)}; rc {rc}; {route_s:.1f} s; the JAX package's script at this "
          f"budget ends the same way: {VTOL_RTI_JAX}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    x_jax = float(VTOL_RTI_JAX.split("x=")[1].split(" m")[0])
    if not (rc == 1 and "ret=-2" in lines[0] and abs(x_end - x_jax) < 2.0
            and 0.0 < clear_end < spec["radius"]):
        raise SystemExit("phase 28 failed: examples.vtol --rti did not end as the JAX "
                         "package's script does at the RTI budget")
    return dict(replay_ms=replay_ms, eager_ms=eager_ms, capture_s=capture_s, nodes=nodes,
                clearance=clear, popin=clear_p, path=path)


# Operations of one VTOL2D Euler step (mpc_fused_models.h::VTOL2D::step),
# counted as QUAD3D_STEP_OPS: sine and cosine 2, the body velocities 6, the
# airspeed 4, atan2 1, two lift / drag / moment evaluations 37 each, two
# rotations to the inertial frame 9 each, f 4, g 15, the update 60 and the
# angle wrap 5.
VTOL_STEP_OPS = 189
VTOL_B3_BATCH = 64  # corridor starts held to the plain version (phase 28b)
VTOL_B3_TILES = 64  # the 64 starts repeated: B=4096 for the launch's time


def vtol_starts(dev, B, N=30):
    """VTOL2D problems 12-22 m before the corridor's pillar row, cruising at
    12-14 m/s near z=10, goal (45, 10), cold starts, from
    ``np.random.default_rng(3)`` (also the inputs of the VTOL2D tests of
    ``tests/test_torch_mpc_fused.py``)."""
    import numpy as np

    from safe_control_tpu_torch.core.types import pad_obstacles

    rng = np.random.default_rng(3)
    xs = np.concatenate([rng.uniform(15, 25, (B, 1)), rng.uniform(9.5, 10.5, (B, 1)),
                         rng.uniform(-0.05, 0.05, (B, 1)), rng.uniform(12, 14, (B, 1)),
                         rng.uniform(-0.2, 0.2, (B, 1)), np.zeros((B, 1))], axis=1)
    pillars = [[37.0, float(y), 0.5, 0, 0, 0, 0] for y in range(6, 10)]
    return (torch.as_tensor(xs, dtype=torch.float32, device=dev),
            torch.tensor([45.0, 10.0, 0, 0, 0, 0], device=dev).repeat(B, 1),
            pad_obstacles(pillars, 5, device=dev)[None].repeat(B, 1, 1),
            torch.zeros((B, 4), device=dev), torch.zeros((B, N, 4), device=dev))


def vtol_b3(dev, card, wide_ptxas, general_path):
    """Phase 28b: B3 at VTOL2D N=30 (M=120; the scaled Jc in the global
    workspace), the RTI controller's solve: against its plain version at B=1
    and B=64, its times at B=1, 64 and 4096, and phase 28's corridor through
    it inside the controller's captured graph, its path beside
    ``general_path`` (phase 28's, through the general solve).
    ``wide_ptxas``: the wide VTOL2D instantiation's (registers, stack and
    spills).  Returns the JSON shape."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import VTOL_2D, make_spec
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    t_phase = time.perf_counter()
    sp = make_spec(VTOL_2D, radius=VTOL_ROBOT["radius"], v_max=VTOL_ROBOT["v_max"])
    cf = mpc_cbf.MPCConfig.rti(horizon=30, num_obs=5)
    mdl = get_model(VTOL_2D)
    n, m = mdl.N_STATES, mdl.N_CONTROLS
    nc = mpc_cbf._num_constraints(mdl, cf)
    ws = mf.workspace_floats(VTOL_2D, sp, entry.DT, cf)
    smem = mf.shared_memory_bytes(VTOL_2D, sp, entry.DT, cf)
    per_sm = mf.blocks_per_sm(VTOL_2D, sp, entry.DT, cf)
    big_b = VTOL_B3_BATCH * VTOL_B3_TILES
    print(f"phase 28b build [{card}] VTOL2D N=30 (M=120, NR=300, NC={nc}), the wide "
          f"instantiation: {wide_ptxas[0]}, {wide_ptxas[1]}, {smem} bytes dynamic shared, "
          f"{per_sm} blocks an SM, workspace {ws} floats a problem ({ws * 4 * big_b} bytes "
          f"at B={big_b})")
    admitted = mf.fused_available(VTOL_2D, cf)
    if not admitted or ws != 120 * nc:
        raise SystemExit(f"phase 28b failed: VTOL2D N=30 admitted {admitted}, workspace "
                         f"{ws} floats a problem, not its scaled Jc's {120 * nc}")

    # the kernel against its plain version; the activation tests counted
    nb = VTOL_B3_BATCH
    args = vtol_starts(dev, nb)
    one = tuple(t[:1] for t in args)
    errs, bits, plain_ms = [], [], []
    act = {b: ActiveRows(lambda t: t.dim() == 2 and t.shape[-1] == nc) for b in (1, nb)}
    b3_pair("28b", VTOL_2D, sp, one, cf, errs, active=act[1], bits=bits, plain_ms=plain_ms)
    b3_pair("28b", VTOL_2D, sp, args, cf, errs, active=act[nb], bits=bits, plain_ms=plain_ms)
    steps = cf.outer_iters * cf.newton_iters
    if act[1].calls != steps or act[nb].calls != steps:
        raise SystemExit("phase 28b failed: not one activation test a Newton step")

    # times: B=1, 64, and the 64 starts repeated to B=4096 (the same work a copy)
    big = tuple(t.repeat(VTOL_B3_TILES, *([1] * (t.dim() - 1))) for t in args)
    ms, bounds = {}, {}
    for b_, ins, reps, rows in ((1, one, 20, act[1].total()), (nb, args, 5, act[nb].total()),
                                (big_b, big, 3, VTOL_B3_TILES * act[nb].total())):
        run = lambda: mf.solve_fused_batch(VTOL_2D, sp, *ins, entry.DT, cf)
        run()
        ms[b_] = sync_time(run, reps)
        ops = b3_flops(b_, n, m, 30, 5, nc, VTOL_STEP_OPS, rows, 6, mdl.REL_DEG,
                       outer=cf.outer_iters, newton=cf.newton_iters)
        bounds[b_] = (ops, *bound(ops, b3_bytes(b_, n, m, 30, 5)))
    print(f"phase 28b [{card}] VTOL2D N=30 RTI: fused kernel "
          + ", ".join(f"B={b_} {ms[b_]:.4f} ms ({bounds[b_][0]:.4e} operations, bound "
                      f"{bounds[b_][1]:.4f} ms by {bounds[b_][2]}, "
                      f"{100 * bounds[b_][1] / ms[b_]:.2f}% of it)" for b_ in ms)
          + f"; plain version B=1 {plain_ms[0]:.1f} ms, B={nb} {plain_ms[1]:.1f} ms")

    # phase 28's corridor through B3, in the controller's captured graph
    log = LogRecords()
    logger = logging.getLogger("safe_control_tpu_torch.solvers")
    logger.addHandler(log)
    seen = len(mpc_cbf._FUSED_FALLBACK_SEEN)
    mf.LAUNCH_COUNT = 0
    try:
        ctrl, pillars, first_s, dx_first, eager_ms, capture_s, nodes = vtol_controller(
            dev, dict(VTOL_ROBOT, use_fused_kernel=True))
        so = ctrl.step_object()
        a_step, warmup = so.launches.get(mf.__name__, 0), so.warmup_launches.get(mf.__name__, 0)
        path = []
        x, clear, ground, flown, replay_ms = corridor_flight(ctrl, pillars, dev, VTOL_STEPS,
                                                             path=path)
        sync(dev)
    finally:
        logger.removeHandler(log)
    launches = mf.LAUNCH_COUNT
    fallbacks = len(log.records) + len(mpc_cbf._FUSED_FALLBACK_SEEN) - seen
    gaps = [max(abs(a[0] - b[0]), abs(a[1] - b[1])) for a, b in zip(path, general_path)]
    same_until = next((k for k, g in enumerate(gaps) if g > 1e-3), len(gaps))
    print(f"phase 28b [{card}] the corridor's path through B3 beside phase 28's through the "
          f"general solve: within 1e-3 m for the first {same_until} of {len(gaps)} common "
          f"steps, largest gap {max(gaps):.3f} m; x after each 20 steps "
          + ", ".join(f"{path[k][0]:.2f}/{general_path[k][0]:.2f}"
                      for k in range(19, len(gaps), 20)) + " m (B3/general)")
    print(f"phase 28b [{card}] VTOL2D corridor through B3 (use_fused_kernel, the captured "
          f"controller step): {flown} steps, final x {x[0]:.2f} m z {x[1]:.2f} m, pillar "
          f"clearance {clear:.3f} m, ground strike {ground}; B3 launches a replay {a_step}, "
          f"{launches} in all ({warmup} the warm-up's, 1 the first replay's, {flown} the "
          f"flight's), fallbacks logged {fallbacks}; {replay_ms:.2f} ms a replayed step (host "
          f"clock, the host read included) against the 50 ms period, an eager step "
          f"{eager_ms:.1f} ms; capture {capture_s:.2f} s (the first step {first_s:.2f} s), "
          f"graph nodes {nodes}; the first replay vs the warm-up, max difference "
          f"{dx_first:.3e}; phase {time.perf_counter() - t_phase:.1f} s")
    if ground or not x[0] > 25.0 or not clear > 0.3:
        raise SystemExit("phase 28b failed: the VTOL corridor through B3 struck the ground, "
                         "stalled or came within 0.3 m of a pillar")
    if not (a_step == 1 and launches == warmup + 1 + flown and fallbacks == 0):
        raise SystemExit("phase 28b failed: the corridor's step is not one B3 launch")
    if not dx_first <= 1e-6:
        raise SystemExit("phase 28b failed: the captured step's first replay disagrees with "
                         "an eager step")
    return {"shape": "VTOL2D N=30 RTI (M=120, Jc in the workspace) B=1", "ms": ms[1],
            "plain_ms": plain_ms[0], "bound_ms": bounds[1][1], "bound_by": bounds[1][2],
            "operations": bounds[1][0], f"ms_b{nb}": ms[nb], f"plain_ms_b{nb}": plain_ms[1],
            f"bound_ms_b{nb}": bounds[nb][1], f"ms_b{big_b}": ms[big_b],
            f"bound_ms_b{big_b}": bounds[big_b][1], "max_abs_err": max(errs),
            "bit_identical": all(bits), "launches": launches,
            "launches_per_step": a_step, "replayed_step_ms": replay_ms,
            "clearance_m": float(clear)}


def run_example(module, argv):
    """``module.main(argv)`` with its standard output captured: ``(rc, lines,
    seconds)``."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue().strip().splitlines(), time.perf_counter() - t0


def unknown_env(dev, card, errs):
    """Phase 29: ``tests/test_unknown_env_e2e.py``'s DI CBF-QP scenario whole,
    then ``examples.unknown_env``'s default through B3 and through the
    general solve, and ``--unknown_detection ray``.  Returns the launches
    (B2, B3) of its paths."""
    import numpy as np

    from safe_control_tpu_torch.core.spec import DOUBLE_INTEGRATOR_2D, make_spec
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.examples import unknown_env as ue
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.core.graphs import CapturedStep
    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    W, H, wps_all, known_all, unknown_all = ue.build_indoor_env()
    # the test's cut of the course: the first 6 waypoints, the obstacles on them
    wps = wps_all[:6, :2]
    known = np.vstack([known_all[[0, 1, 2]], known_all[4:8], known_all[11:12]])
    unknown = unknown_all[:15]
    spec = make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.5, a_max=1.8, radius=0.23,
                     fov_angle=np.radians(70.0), cam_range=4.5, nominal_k_v=1.8,
                     nominal_k_a=2.0, reached_threshold=0.45)
    cfg = tracking.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, pos_controller="cbf_qp",
                                 dt=0.05, num_obs=10, use_sensor=True, mem_slots=24,
                                 reached_threshold=0.45)
    st = tracking.init_state(cfg, spec, np.array([2.0, 2.0, 0.0, 0.0]), np.pi / 2,
                             first_goal=wps[0], device=dev)
    args = (torch.as_tensor(wps, dtype=torch.float32, device=dev),
            pad_obstacles(known, 12, device=dev), pad_obstacles(unknown, 16, device=dev))
    step = CapturedStep(lambda s, w, k, u: tracking.step(cfg, spec, s, w, len(wps), k, u),
                        dev.type == "cuda")
    qpk.LAUNCH_COUNT = 0
    n_steps = UNKNOWN_DI_STEPS
    rets, xs = [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = step(st, *args)
        st = out.state
        rets.append(out.ret[0].clone())  # a replay overwrites the graph's outputs
        xs.append(st.x[0, :2].clone())
    rets = torch.stack(rets).cpu().numpy()
    xs = torch.stack(xs).cpu().numpy()
    di_ms = (time.perf_counter() - t0) / n_steps * 1e3
    di_launches = qpk.LAUNCH_COUNT
    mem_rows = int(st.mem.valid.sum())
    dmin = min(float(np.linalg.norm(xs - ob[:2], axis=1).min() - ob[2] - 0.23)
               for ob in unknown)
    final = int(st.ret[0])
    print(f"phase 29 [{card}] unknown environment (tests/test_unknown_env_e2e.py, DI CBF-QP, "
          f"fov detection, {n_steps} steps of one captured graph): final code {final}, "
          f"RET_INFEASIBLE {int((rets == tracking.RET_INFEASIBLE).sum())} steps, memory rows "
          f"{mem_rows}, least clearance to an unknown obstacle {dmin:.3f} m; B2 launches "
          f"{di_launches}; {di_ms:.2f} ms a step")
    warmup = step.warmup_launches.get(qpk.__name__, 0)
    if not (final == tracking.RET_DONE and not np.any(rets == tracking.RET_INFEASIBLE)
            and mem_rows >= 5 and dmin > -1e-3 and di_launches == n_steps + warmup):
        raise SystemExit("phase 29 failed: the unknown-environment scenario did not complete "
                         "cleanly")

    b2, b3 = di_launches, 0
    runs = [("fused kernel (B3)", [], True),
            (f"general solve, --tf {UNKNOWN_GENERAL_TF:g} (cut)",
             ["--tf", f"{UNKNOWN_GENERAL_TF:g}"], False),
            ("--unknown_detection ray, fused kernel (B3)", ["--unknown_detection", "ray"], True)]
    tune = ue.apply_algo_tuning
    for label, extra, fused in runs:
        # the script has no switch for B3: the robot spec opts in, as a user's would
        ue.apply_algo_tuning = ((lambda spec, algo: dict(tune(spec, algo), use_fused_kernel=True))
                                if fused else tune)
        mf.LAUNCH_COUNT = 0
        # the first steps held against B3's plain version
        a = ue.build_parser().parse_args(extra + ["--device", dev.type])
        if fused:
            c, *_ = ue.make_controller(a, dev)
            checked_steps(c, PLAIN_STEPS, False, errs)
            del c
        mf.LAUNCH_COUNT = 0
        try:
            rc, lines, secs = run_example(ue, extra + ["--device", dev.type])
        finally:
            ue.apply_algo_tuning = tune
        launches = mf.LAUNCH_COUNT
        b3 += launches
        jax_note = (f" (the JAX package's script: {UNKNOWN_RAY_JAX})" if "ray" in label else "")
        print(f"phase 29 [{card}] examples.unknown_env defaults, {label}: {' | '.join(lines)}; "
              f"rc {rc}, B3 launches {launches}; {secs:.1f} s{jax_note}")
        if "ray" in label:  # ends as the JAX package's script does (UNKNOWN_RAY_JAX)
            ok = rc == 1 and UNKNOWN_RAY_JAX in lines[0]
        elif fused:
            ok = rc == 0 and lines[-1] == "Success!"
        else:  # the cut general-solve run: no collision or infeasible step
            ok = "collision/infeasible: False" in lines[0]
        if not ok or (fused and launches == 0):
            raise SystemExit(f"phase 29 failed: examples.unknown_env ({label})")
    print(f"phase 29 [{card}] the first {PLAIN_STEPS} steps of each fused run against B3's "
          f"plain version: max|du| {max(errs) if errs else float('nan'):.3e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if errs and max(errs) > U_TOL:
        raise SystemExit("phase 29 failed: B3 left its plain version's envelope")
    return b2, b3


def visibility_attitude(dev, card, errs):
    """Phase 30: the visibility-violation scenarios, the attitude
    controllers, the gatekeeper attitude with the MPC prediction, ray
    detection and the VTOL oracle.  Returns the B2 launches."""
    import math

    import numpy as np

    from safe_control_tpu_torch.core import spec as spec_mod
    from safe_control_tpu_torch.core.graphs import CapturedStep
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.envs.env import Env
    from safe_control_tpu_torch.perception import grid as grid_mod
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.sim.controller import LocalTrackingController
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    qpk.LAUNCH_COUNT = 0
    DI = spec_mod.DOUBLE_INTEGRATOR_2D
    gs = grid_mod.GridSpec(width=16.0, height=16.0, resolution=0.2)
    known4 = pad_obstacles(np.zeros((0, 7)), 4, device=dev)

    def run(cfg, spec, x0, yaw0, wps, n_steps):
        st = tracking.init_state(cfg, spec, np.asarray(x0), yaw0, first_goal=wps[0],
                                 device=dev)
        w = torch.as_tensor(wps, dtype=torch.float32, device=dev)
        step = CapturedStep(lambda s, w_, k: tracking.step(cfg, spec, s, w_, len(wps), k),
                            dev.type == "cuda")
        rets, xs = [], []
        for _ in range(n_steps):
            out = step(st, w, known4)
            st = out.state
            rets.append(out.ret[0].clone())  # a replay overwrites the graph's outputs
            xs.append(st.x[0].clone())
        return st, torch.stack(rets).cpu().numpy(), torch.stack(xs).cpu().numpy()

    # (a) flying backward into unexplored space: RET_VISIBILITY, and it runs on
    spec = spec_mod.make_spec(DI, v_max=1.0, a_max=1.5, radius=0.25, cam_range=2.0,
                              fov_angle=math.radians(70.0))
    cfg = tracking.TrackerConfig(model_name=DI, pos_controller="cbf_qp", dt=0.05,
                                 use_sensor=True, grid=gs, att_controller="none")
    _, rets, xs = run(cfg, spec, [8.0, 8.0, 0.0, 0.0], math.pi, [[2.0, 8.0], [14.0, 8.0]], 500)
    first = int(np.argmax(rets == tracking.RET_VISIBILITY))
    a_ok = (bool(np.any(rets == tracking.RET_VISIBILITY))
            and bool(np.any(rets[first + 1:] != tracking.RET_INFEASIBLE)) and xs[-1, 0] > 8.0)
    # (b) the turning unicycle's arc tube
    uspec = spec_mod.make_spec(spec_mod.UNICYCLE_2D, radius=0.25, v_max=2.0, w_max=2.0,
                               cam_range=0.5, fov_angle=math.radians(5.0))
    ucfg = tracking.TrackerConfig(model_name=spec_mod.UNICYCLE_2D, pos_controller="cbf_qp",
                                  dt=0.05, use_sensor=True, grid=gs, att_controller="none",
                                  max_decel=1.0, max_ang_decel=1.0)
    cx, cy = grid_mod.cell_centers(gs, device=dev)
    corridor = ((torch.abs(cy - 8.0) <= 0.45) & (cx >= 2.0))[None]

    def one_ret(waypoint):
        st = tracking.init_state(ucfg, uspec, np.array([4.0, 8.0, 0.0]),
                                 first_goal=np.array(waypoint), device=dev)
        st = st._replace(footprint=corridor.clone(),
                         mode=torch.full((1,), tracking.TRACK, dtype=torch.long, device=dev))
        w = torch.as_tensor([waypoint], dtype=torch.float32, device=dev)
        return int(tracking.step(ucfg, uspec, st, w, 1, known4).ret[0])

    b_turn, b_straight = one_ret([8.0, 12.0]), one_ret([14.0, 8.0])
    # (c) the camera leading: few violations, RET_DONE
    spec_c = spec_mod.make_spec(DI, v_max=1.0, a_max=1.5, radius=0.25, cam_range=3.0,
                                fov_angle=math.radians(70.0))
    cfg_c = tracking.TrackerConfig(model_name=DI, pos_controller="cbf_qp", dt=0.05,
                                   use_sensor=True, grid=gs)
    st_c, rets_c, _ = run(cfg_c, spec_c, [2.0, 8.0, 0.0, 0.0], 0.0, [[14.0, 8.0]], 400)
    viol_frac = float((rets_c == tracking.RET_VISIBILITY).mean())
    print(f"phase 30 [{card}] visibility (tests/test_visibility_violation.py): backward flight "
          f"RET_VISIBILITY at step {first}, runs on {a_ok}, final x {xs[-1, 0]:.2f}; turning "
          f"unicycle codes {b_turn} (arc) / {b_straight} (straight); camera leading: violation "
          f"share {viol_frac:.4f}, final code {int(st_c.ret[0])}")
    if not (a_ok and b_turn == tracking.RET_VISIBILITY and b_straight == tracking.RET_OK
            and viol_frac < 0.05 and int(st_c.ret[0]) == tracking.RET_DONE):
        raise SystemExit("phase 30 failed: a visibility scenario missed its predicate")

    def env():
        return Env(width=12.0, height=12.0, known_obs=[[6.0, 5.0, 0.5, 0, 0, 0, 0]],
                   resolution=0.25)

    # (d) the three attitude controllers steer the camera
    spreads = {}
    for att in ("simple", "visibility_area", "visibility_raycast"):
        c = LocalTrackingController([1.0, 1.0, 0.0, 0.0], {"model": DI, "sensor": "rgbd"},
                                    controller_type={"pos": "cbf_qp", "att": att}, dt=0.05,
                                    env=env(), enable_rotation=True, device=dev)
        c.set_waypoints([[9.0, 9.0]])
        yaws = []
        checked_steps(c, PLAIN_STEPS, True, errs)
        for _ in range(120 - PLAIN_STEPS):
            c.control_step()
            yaws.append(float(c.state.yaw[0]))
        spreads[att] = (float(np.ptp(yaws)), bool(c.state.footprint.any()))
    print(f"phase 30 [{card}] attitude dispatch (yaw spread, footprint grown): {spreads}")
    if not all(s > 0.05 and grown for s, grown in spreads.values()):
        raise SystemExit("phase 30 failed: an attitude controller did not steer the camera")
    # (e) the gatekeeper attitude on the MPC prediction, 60 steps
    c = LocalTrackingController([1.0, 1.0, 0.0, 0.0], {"model": DI, "sensor": "rgbd"},
                                controller_type={"pos": "mpc_cbf", "att": "gatekeeper"},
                                dt=0.05, env=env(), enable_rotation=True, device=dev)
    c.set_waypoints([[9.0, 9.0]])
    t0 = time.perf_counter()
    gk_rets = [c.control_step() for _ in range(60)]
    gk_ms = (time.perf_counter() - t0) / 60 * 1e3
    replans, init = int(c.state.att_gk.total_replans[0]), bool(c.state.att_gk.initialized[0])
    capture_s, nodes = graph_report(c)
    print(f"phase 30 [{card}] gatekeeper attitude on the DI MPC-CBF prediction (N=10, the "
          f"general solve), 60 captured steps: infeasible {gk_rets.count(-2)}, replans "
          f"{replans}, initialized {init}; {gk_ms:.1f} ms a step (capture {capture_s:.2f} s "
          f"included), graph nodes {nodes}")
    if tracking.RET_INFEASIBLE in gk_rets or replans <= 0 or not init:
        raise SystemExit("phase 30 failed: the gatekeeper attitude did not run its events")
    del c
    # (f) ray detection through the wrapper
    c = LocalTrackingController([1.0, 4.0, 0.0, 0.0], {"model": DI, "sensor": "rgbd",
                                                        "unknown_obs_detection": "ray"},
                                controller_type={"pos": "cbf_qp"}, dt=0.05, env=env(),
                                enable_rotation=True, device=dev)
    c.set_unknown_obs([[5.0, 3.4, 0.5, 0, 0, 0, 0]])
    c.set_waypoints([[10.0, 4.0]])
    ray_rets = []
    for _ in range(500):
        ray_rets.append(c.control_step())
        if ray_rets[-1] == tracking.RET_DONE:
            break
    mem_used = bool(c.state.mem.valid.any())
    print(f"phase 30 [{card}] ray detection through the wrapper: {len(ray_rets)} steps, last "
          f"code {ray_rets[-1]}, infeasible {ray_rets.count(-2)}, fov memory used {mem_used}")
    if ray_rets[-1] != tracking.RET_DONE or tracking.RET_INFEASIBLE in ray_rets or mem_used:
        raise SystemExit("phase 30 failed: ray detection through the wrapper")
    # (g) the VTOL ground and pitch oracle, three robots in one eager step
    vcfg = tracking.TrackerConfig(model_name=spec_mod.VTOL_2D, pos_controller="mpc_cbf",
                                  att_controller="none", dt=0.05, vtol_pitch_oracle="strict",
                                  # the oracle is the solve's neighbour, not its
                                  # result: a 1x1 budget keeps the eager step short
                                  mpc=mpc_cbf.MPCConfig(horizon=4, num_obs=5, outer_iters=1,
                                                        newton_iters=1))
    vspec = spec_mod.make_spec(spec_mod.VTOL_2D)
    bad_pitch = math.radians(float(vspec.pitch_max)) + 0.2
    x0s = np.array([[5.0, -0.1, 0, 5.0, 0, 0], [5.0, 10.0, bad_pitch, 5.0, 0, 0],
                    [5.0, 10.0, 0.0, 5.0, 0, 0]], dtype=np.float32)
    vst = tracking.init_state(vcfg, vspec, x0s, first_goal=[50.0, 10.0], device=dev)
    far = torch.tensor([[1e3, 1e3, 0, 0, 0, 0, 0]] * 4, dtype=torch.float32, device=dev)
    codes = tracking.step(vcfg, vspec, vst, torch.tensor([[50.0, 10.0]], device=dev), 1,
                          far).ret.tolist()
    print(f"phase 30 [{card}] VTOL oracle (horizon 4, a 1x1 budget): codes below ground / pitch past the "
          f"limit / cruise {codes}; B2 launches {qpk.LAUNCH_COUNT}; the first {PLAIN_STEPS} "
          f"steps of each attitude controller against B2's plain version: max|du| "
          f"{max(errs):.3e}; phase {time.perf_counter() - t_phase:.1f} s")
    if not (codes[0] == -2 and codes[1] == -2 and codes[2] != -2):
        raise SystemExit("phase 30 failed: the VTOL oracle missed the ground or pitch term")
    if qpk.LAUNCH_COUNT == 0 or max(errs) > QP_U_TOL:
        raise SystemExit("phase 30 failed: B2 did not launch or left its plain version's "
                         "envelope")
    return qpk.LAUNCH_COUNT


# Each examples module's cut (the script's own switches), why, and whether
# its path launches B2.
DRIFT_EXAMPLE_TF = 0.1  # seconds of examples.drift's case (the module's TF, 12 s)
EXAMPLE_RUNS = [
    ("tracking", ["--tf", "1"], "--tf 1 (20 of ~1000 steps of the DU N=10 general solve)",
     False),
    ("unknown_env", None, "run in phase 29", False),
    ("vtol", None, "run in phase 28 with --rti; the 8x3 default is about 6x its graph", False),
    ("dynamic_env_main", ["--tf", "15"], "--tf 15 (phase 17 runs the scenario whole)", True),
    ("drift", ["--test", "middle_lane_only"],
     "one case, its TF cut to 0.1 s of 12 (phase 23 runs the simulator)", False),
    ("evade", [], "none (tf 60)", False),
    ("mpcc", ["--tf", "0.5"], "--tf 0.5 of 15", False),
    ("multi_robot", [], "none (64 robots, tf 60)", True),
    ("warehouse", ["--steps", "200"], "--steps 200 of 1200 (phase 24 runs every level)", False),
    ("heterogeneous_fleet", ["--steps", "20"], "--steps 20 of 200 (phase 25 runs 200)", True),
    ("monte_carlo_sweep", ["--steps", "40", "--chunk", "20", "--ckpt", "build/ckpt_sweep"],
     "--steps 40 of 400 (phase 21 runs 400), checkpointed", True),
]


def command_lines(dev, card):
    """Phase 31: every examples module through ``main([...])`` at its
    defaults, cut by its own switches where an earlier phase runs the
    scenario; each gated on its predicate.  Returns (B2, B3) launches."""
    import importlib

    from safe_control_tpu_torch.solvers import mpc_fused as mf
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    t_phase = time.perf_counter()
    b2 = b3 = 0
    for name, argv, why, uses_b2 in EXAMPLE_RUNS:
        if argv is None:
            print(f"phase 31 [{card}] examples.{name}: {why}")
            continue
        module = importlib.import_module(f"safe_control_tpu_torch.examples.{name}")
        qpk.LAUNCH_COUNT = mf.LAUNCH_COUNT = 0
        if name == "drift":  # the script has no time switch: seconds a case
            module.TF = DRIFT_EXAMPLE_TF
        rc, lines, secs = run_example(module, argv + ["--device", dev.type])
        b2, b3 = b2 + qpk.LAUNCH_COUNT, b3 + mf.LAUNCH_COUNT
        tail = " | ".join(lines[-4:])
        print(f"phase 31 [{card}] examples.{name} {' '.join(argv)} (cut: {why}): {tail}; rc "
              f"{rc}; B2 {qpk.LAUNCH_COUNT}, B3 {mf.LAUNCH_COUNT} launches; {secs:.1f} s")
        predicate = {"evade": "Success!" in lines or "Safe (no goal yet)" in lines,
                     "heterogeneous_fleet": "'infeasible_or_collision': 0" in lines[-1],
                     "monte_carlo_sweep": lines[-1].startswith("success"),
                     "drift": rc == 0}.get(name, "Success!" in lines)
        if rc != 0 or not predicate:
            raise SystemExit(f"phase 31 failed: examples.{name} missed its predicate")
        if uses_b2 and qpk.LAUNCH_COUNT == 0:
            raise SystemExit(f"phase 31 failed: examples.{name} did not launch B2")
    print(f"phase 31 [{card}] phase {time.perf_counter() - t_phase:.1f} s")
    return b2, b3


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

    t_start = time.perf_counter()

    def elapsed(label):
        print(f"elapsed before {label}: {time.perf_counter() - t_start:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- phase 1: build (the three kernels and B3's clock, one nvcc each, started together;
    # the QP and fused kernels finish in the background while phases 2-8 run)
    nvcc_pool = concurrent.futures.ThreadPoolExecutor(3)
    builds = {name: nvcc_pool.submit(_build.build_all, [name])
              for name in ("qp_admm_kernel", "qp_finish_kernel", "mpc_fused_kernel",
                           "mpc_fused_clock")}
    nvcc_pool.shutdown(wait=False)
    _build.build_all(["mpc_du_kernel"])
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
    plain_ms = sync_time(run_plain, 1)  # seconds a call
    step_kernel = lambda: step_k(xs, goals, obs, u_prevs, Us)
    step_plain = lambda: step_p(xs, goals, obs, u_prevs, Us)
    step_kernel()
    step_ms_k = sync_time(step_kernel, 10)
    step_plain()
    step_ms_p = sync_time(step_plain, 1)
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

    elapsed("phase 5")
    # ---- phase 5: the QP ADMM kernel's build ---------------------------------
    builds["qp_admm_kernel"].result()
    builds["qp_finish_kernel"].result()
    _build.load_qp_admm_kernel()
    _build.load_qp_finish_kernel()
    info = _build.BUILD_INFO["qp_admm_kernel"]
    qp_shapes = []
    # the CBF-QP path, the DPCBF sweep at 2^19 and the Manipulator2D scale
    qp_at = ((BATCH, 2, 7), (2**19, 2, 10), (BATCH, 3, 153))
    for qb_, qn_, qm_ in qp_at:
        qp_shapes.append(f"B={qb_}, n={qn_}, m={qm_}: {b2_shape(qb_, qn_, qm_)}, "
                         f"{qpk.THREADS // qpk.launch_shape(qb_, qn_, qm_)[0]} problems a block "
                         f"of {qpk.THREADS} threads")
    g7 = qpk.launch_shape(BATCH, 2, 7)[0]
    path_kernels = {"qp_admm_kernel<%d,%d,%d>" % (qn_, *qpk.launch_shape(qb_, qn_, qm_))
                    for qb_, qn_, qm_ in qp_at}
    print(f"phase 5 build: qp_admm_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside mpc_du_kernel and phases 2-4); ptxas at those shapes: "
          f"{ptxas_summary(info['ptxas'], path_kernels)}; launch shape "
          + "; ".join(qp_shapes) + f"; at B={BATCH}, m=7: {-(-BATCH * g7 // qpk.THREADS)} blocks "
          f"on {sms} SMs")
    fin_info = _build.BUILD_INFO["qp_finish_kernel"]
    print(f"phase 5 build: qp_finish_kernel {fin_info['seconds']:.1f} s "
          f"(cached={fin_info['cached']}); ptxas: {ptxas_summary(fin_info['ptxas'])}")

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
        print(f"phase 6a QP kernel vs plain ({label}, n=2, m=7, 1600 iters, "
              f"{b2_shape(data[0].shape[0], 2, 7)}): "
              f"max|dx| {dx:.3e}, "
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
    print(f"phase 6b QP kernel vs plain (B={wb}, n={wn}, m={wm}, 300 iters, "
          f"{b2_shape(wb, wn, wm)}): "
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
    qpk.LAUNCH_COUNT = qpk.FINISH_LAUNCH_COUNT = 0
    x = qxs
    q_inputs, q_us = [], []
    for _ in range(STEPS):
        q_inputs.append(x)
        x, u_c, feas_c, hmin_c = cstep_k(x, qgoals, qobs)
        q_us.append(u_c)
    torch.cuda.synchronize()
    qp_launches, fin_launches = qpk.LAUNCH_COUNT, qpk.FINISH_LAUNCH_COUNT
    outs_ok = all(bool(torch.isfinite(t).all()) for t in (x, u_c, hmin_c))
    shapes_ok = [tuple(t.shape) for t in (x, u_c, feas_c, hmin_c)] == [
        (BATCH, 4), (BATCH, 2), (BATCH,), (BATCH,)]
    print(f"phase 7 CBF-QP path: {STEPS} steps at B={BATCH}, QP kernel launches {qp_launches}, "
          f"finish kernel launches {fin_launches}, "
          f"finite {outs_ok}, shapes {shapes_ok}, feasible {int(feas_c.sum())}/{BATCH}, "
          f"min h_min {hmin_c.min().item():.3e}")
    if qp_launches < STEPS or fin_launches != qp_launches or not outs_ok or not shapes_ok:
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
    print(f"phase 8 [{card}] QP kernel launch (n=2, m=7, 1600 iterations, "
          f"{b2_shape(1, 2, 7)} up to B=16384): B=1 "
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
    fin_ms = sync_time(lambda: qpk._finish_cuda(*qp_data, scaled, x_s, y_s, True), 10)
    general_fin_ms = sync_time(lambda: qp.finish(*qp_data, scaled, x_s, y_s, True), 10)
    run_qp()
    qp_plain_ms = sync_time(run_qp, 1)
    cstep_g, _ = entry.build_cbf_qp_step(BATCH, device=dev, backend="xla")
    cstep_kernel = lambda: cstep_k(qxs, qgoals, qobs)
    cstep_general = lambda: cstep_g(qxs, qgoals, qobs)
    cstep_kernel()
    cstep_ms_k = sync_time(cstep_kernel, 10)
    cstep_general()
    cstep_ms_g = sync_time(cstep_general, 1)
    qn, qm = qp_data[0].shape[-1], qp_data[2].shape[-2]
    b2_ops = b2_flops(BATCH, qn, qm, 1600)
    b2_bound, b2_by = bound(b2_ops, b2_bytes(BATCH, qn, qm))
    print(f"phase 8 [{card}] B={BATCH}: QP kernel {b2_ops:.4e} operations (n={qn}, m={qm}, "
          f"1600 iterations), bound {b2_bound:.4f} ms by {b2_by}, "
          f"{100 * b2_bound / sweep_ms[BATCH]:.2f}% "
          f"of it reached by the launch")
    print(f"phase 8 [{card}] B={BATCH}: QP kernel path {qp_ms:.3f} ms/solve-batch "
          f"(qp.equilibrate {eq_ms:.3f} ms, the launch {sweep_ms[BATCH]:.3f} ms, the finish "
          f"kernel {fin_ms:.3f} ms, each alone; the general path's qp.finish "
          f"{general_fin_ms:.3f} ms) vs plain version {qp_plain_ms:.1f} ms; "
          f"CBF-QP path {1e3 / cstep_ms_k:.1f} steps/s ({BATCH * 1e3 / cstep_ms_k:.1f} "
          f"robot-steps/s, {cstep_ms_k:.3f} ms/step) through the kernel vs "
          f"{1e3 / cstep_ms_g:.1f} steps/s ({cstep_ms_g:.1f} ms/step) through the general "
          f"solve_qp")
    fin_checked, fin_shapes, fin_plain_ms = finish_kernel(dev, card, qp_data)

    elapsed("phase 24")
    # ---- phase 24 (no kernel) runs here, while the fused kernel's build of 26
    # instantiations finishes in the background ------------------------------------
    warehouse(dev, card)

    elapsed("phase 9")
    # ---- phase 9: the fused MPC kernel's build ----------------------------------
    builds["mpc_fused_kernel"].result()
    builds["mpc_fused_clock"].result()
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
    b3_report, b3_wide = b3_build_report(info["ptxas"], shapes)
    print(f"phase 9 build: mpc_fused_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside the other two and phases 2-8); "
          + " | ".join(v for k, v in b3_report.items()
                       if k not in NEW_B3_OPS and k not in DRIFT_B3_OPS))

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
    f_plain_ms = sync_time(run_fp, 1)  # seconds a call: no warm-up
    fstep_g, _ = entry.build_fused_step(BATCH, device=dev, use_fused_kernel=False)
    fstep_kernel = lambda: fstep_k(*fargs)
    fstep_general = lambda: fstep_g(*fargs)
    fstep_kernel()
    fstep_ms_k = sync_time(fstep_kernel, 5)
    fstep_ms_g = sync_time(fstep_general, 1)  # seconds a call: no warm-up
    print(f"phase 12 [{card}] Quad3D N=10: fused kernel at B=1 {f_sizes_ms[1]:.4f} ms, "
          f"B={BATCH} {f_ms:.4f} ms, B=16384 {f_sizes_ms[16384]:.4f} ms")
    print(f"phase 12 [{card}] B={BATCH} Quad3D N=10: fused kernel {f_ms:.3f} ms/solve-batch vs "
          f"plain version {f_plain_ms:.1f} ms; fused path {BATCH / fstep_ms_k * 1e3:.1f} solves/s "
          f"({fstep_ms_k:.3f} ms/step) through the kernel vs {BATCH / fstep_ms_g * 1e3:.1f} "
          f"solves/s ({fstep_ms_g:.1f} ms/step) through the general solve")

    q3 = get_model(QUAD_3D)
    q3_n, q3_m = q3.N_STATES, q3.N_CONTROLS
    b3_ops = b3_flops(BATCH, q3_n, q3_m, 10, 5, q3_nc, QUAD3D_STEP_OPS, b3_active.total())
    b3_bound, b3_by = bound(b3_ops, b3_bytes(BATCH, q3_n, q3_m, 10, 5))
    print(f"phase 12 [{card}] B={BATCH} Quad3D N=10: fused kernel {b3_ops:.4e} operations "
          f"({b3_active.total()} active constraint rows in the Newton steps), bound "
          f"{b3_bound:.4f} ms by {b3_by}, {100 * b3_bound / f_ms:.2f}% of it reached")

    def chain_us(model_name, horizon, fused):
        """Microseconds per solve over a chain of warm-started B=1
        solve_dispatch calls (CHAIN through the kernel, CHAIN_GENERAL not)."""
        one_step, a = entry.build_fused_step(1, model_name=model_name, horizon=horizon,
                                             device=dev, use_fused_kernel=fused)
        if fused:  # warm-up: first use of every launch path (the general solve is seconds)
            one_step(*a)
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

    elapsed("phase 13")
    # ---- phases 13-15: the tracking loop --------------------------------------
    single_robot(dev, card, 13, {"model": DYNAMIC_UNICYCLE_2D, "w_max": 0.5, "a_max": 1.0,
                                 "radius": 0.25, "mpc_horizon": 8, "use_fused_kernel": True},
                 "mpc_cbf", [2.0, 2.0, np.pi / 2, 0.0], 120.0, mf)
    single_robot(dev, card, 14, {"model": DOUBLE_INTEGRATOR_2D, "v_max": 1.0, "a_max": 1.5,
                                 "radius": 0.25}, "cbf_qp", [2.0, 2.0, np.pi / 2], 100.0, qpk)
    qp_fleet = fleet(dev, card, "cbf_qp", FLEET_DI_STEPS)
    du_fleet = fleet(dev, card, "mpc_cbf", FLEET_DU_STEPS)

    elapsed("phase 16")
    # ---- phases 16-19: the later models and MPC variants ------------------------
    b3_shapes, b3_new_err, b3_new_launches = new_b3_models(dev, card, b3_report)
    dyn = dynamic_env(dev, card)
    arm_shape = manipulator_cbf_qp(dev, card)
    mpc_variants(dev, card)

    elapsed("phase 20")
    # ---- phases 20-23: the drift models on B3, the sweep, MPCC, the drift car ------
    drift_shapes, drift_err, drift_bits = drift_b3_models(dev, card, b3_report)
    sweep = monte_carlo_sweep(dev, card)
    sweep_b2 = sweep_scale_b2(dev, card)
    mpcc_alone(dev, card)
    drift_scenario(dev, card)

    elapsed("phase 25")
    # ---- phases 25-27: the fleets, the multi-device path (phase 24 ran before 9) --
    het = heterogeneous_fleet(dev, card)
    shielded_fleet(dev, card)
    multi_device(dev, card)

    elapsed("phase 28")
    # ---- phases 28-31: the examples' scenarios and command lines --------------------
    new_errs = {"qp": [], "fused": []}
    vt = vtol(dev, card)
    elapsed("phase 28b")
    vt_b3 = vtol_b3(dev, card, b3_wide[VTOL_2D], vt["path"])
    ue_b2, ue_b3 = unknown_env(dev, card, new_errs["fused"])
    va_b2 = visibility_attitude(dev, card, new_errs["qp"])
    cl_b2, cl_b3 = command_lines(dev, card)

    elapsed("the JSON lines")
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
        "fleet_launches_per_step": het["launches"] / FLEET_ANCHOR_STEPS,
        "fleet_ms_per_launch": {p["model"]: p["ms"] for p in het["groups"]},
        "scenario_launches": {"unknown_env": ue_b2, "visibility_attitude": va_b2,
                              "command_lines": cl_b2},
        "scenario_max_abs_err": max(new_errs["qp"]),
        "shapes": [arm_shape, {"shape": f"DPCBF sweep n=2 m=10 B={SWEEP_BATCH}",
                               "ms": sweep[2], "bound_ms": sweep[4], "bound_by": sweep[5],
                               "max_abs_err": sweep[3]},
                   {"shape": sweep_b2[5], "ms": sweep_b2[0], "bound_ms": sweep_b2[1],
                    "bound_by": sweep_b2[2], "max_abs_err": max(sweep_b2[3:5])}]
        + [{"shape": f"fleet {p['model']} n={p['n']} m={p['m']} B={p['B']}", "ms": p["ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "max_abs_err": p["max_abs_err"]} for p in het["groups"]],
        "max_abs_err": max(qp_dx, qp_dy, arm_shape["max_abs_err"], dyn[3], sweep[3],
                           *sweep_b2[3:5],
                           *(p["max_abs_err"] for p in het["groups"]), *new_errs["qp"]),
        "ms": qp_ms,
        "plain_ms": qp_plain_ms,
        "bound_ms": b2_bound,
        "bound_by": b2_by,
        "library_ms": None,
    }, {
        "name": "qp_finish_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/qp_finish_kernel.cu",
        "replaces": None,
        "launches": fin_launches,
        "launches_per_step": fin_launches / STEPS,
        "checked_launches": fin_checked + 1,
        "shapes": fin_shapes + [sweep_b2[6]],
        "max_abs_err": max(s["max_abs_err"] for s in fin_shapes + [sweep_b2[6]]),
        "ms": fin_shapes[0]["ms"],
        "plain_ms": fin_plain_ms,
        "general_ms": fin_shapes[0]["general_ms"],
        "bound_ms": fin_shapes[0]["bound_ms"],
        "bound_by": fin_shapes[0]["bound_by"],
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
        "vtol_n30_launches": vt_b3["launches"],
        "vtol_n30_launches_per_step": vt_b3["launches_per_step"],
        "scenario_launches": {"unknown_env": ue_b3, "command_lines": cl_b3},
        "scenario_max_abs_err": max(new_errs["fused"]),
        "shapes": b3_shapes + drift_shapes + [vt_b3],
        "drift_bit_identical": drift_bits,
        "max_abs_err": max(fused_max_err, b3_new_err, drift_err, vt_b3["max_abs_err"],
                           *new_errs["fused"]),
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
