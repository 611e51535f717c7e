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

Every time is printed beside the card's name and power limit.  Prints one
JSON line of per-kernel numbers (with each kernel's bound and launches a
step), then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device and
when any check fails.
"""

from __future__ import annotations

import json
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
CHAIN_GENERAL = 5  # the same through the general solve (host-bound, seconds a solve)


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


def b3_flops(B, n, m, N, K, NC, step_ops, active_rows):
    """Operations of B3's solve for a model of ``step_ops`` operations a
    ``step``, from its code, with circle barriers and relative degree 1.  A
    dual-number operation is counted as two (a value and a tangent: the
    Quad3D step multiplies duals by constants only)."""
    M, NR, steps = N * m, N * (n + m), 24
    tri = M * (M + 1) // 2
    rollout = K * 6 + N * (step_ops + 2 * n + 9 * K + 2 * (NC - N * K) // (2 * N)) + 2 * N * m
    newton = (M * (2 * rollout + NC) + 2 * M * (NR + NC) + 2 * tri * NR + 2 * M + 3 * tri
              + sum(i * (i + 1) for i in range(M)) + tri + 2 * M * M + 2 * M * M
              + 6 * (rollout + 4 * NR + 7 * NC) + 12 * M)
    per_problem = (M * 2 * rollout + NC * 2 * M + steps * newton
                   + 8 * (rollout + 3 * NC) + rollout + NC)
    return B * per_problem + active_rows * 2 * tri


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
    report = []
    for model, regs, frame in fused_ptxas(info["ptxas"]):
        sp, cf = shapes[model]
        smem = mf.shared_memory_bytes(model, sp, entry.DT, cf)
        per_sm = mf.blocks_per_sm(model, sp, entry.DT, cf)
        report.append(f"{model} N={cf.horizon}: {regs}, {frame}, {smem} bytes dynamic shared, "
                      f"{per_sm} blocks an SM")
    threads = _build.load_mpc_fused_kernel().mpc_fused_threads()
    print(f"phase 9 build: mpc_fused_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside the other two), {threads}-thread blocks; " + " | ".join(report))
    if len(report) != len(mf.MODEL_IDS):
        raise SystemExit("phase 9 failed: not every model has a fused kernel instantiation")

    # ---- phase 10: fused kernel vs its plain version -------------------------------
    fused_errs = []

    q3_nc = mpc_cbf._num_constraints(get_model(QUAD_3D), q3_cfg)
    b3_active = ActiveRows(lambda t: t.dim() == 2 and t.shape[-1] == q3_nc)

    def fused_pair(label, model, sp, args, cf, count=False):
        kern = mf.solve_fused_batch(model, sp, *args, entry.DT, cf)
        torch.cuda.synchronize()
        if count:
            with b3_active:
                plain = mf.solve_fused_batch_reference(model, sp, *args, entry.DT, cf)
        else:
            plain = mf.solve_fused_batch_reference(model, sp, *args, entry.DT, cf)
        torch.cuda.synchronize()
        du_ = (kern.U - plain.U).abs().max().item()
        dxs = (kern.xs - plain.xs).abs().max().item()
        dv = (kern.viol - plain.viol).abs().max().item()
        same = torch.equal(kern.U, plain.U) and torch.equal(kern.xs, plain.xs) and \
            torch.equal(kern.viol, plain.viol)
        fused_errs.append(max(du_, dxs, dv))
        print(f"phase 10{label} fused kernel vs plain ({model} N={cf.horizon}, "
              f"B={args[0].shape[0]}): max|du| {du_:.3e}, max|dxs| {dxs:.3e}, "
              f"max|dviol| {dv:.3e}, bit-identical {same}, "
              f"{int((kern.viol > VIOL_TOL).sum())} with viol > {VIOL_TOL}")
        if not (du_ < U_TOL and dxs < U_TOL and dv <= VIOL_TOL):
            raise SystemExit(f"phase 10{label} failed: fused kernel disagrees with its plain version")
        return kern

    fstep_k, fargs = entry.build_fused_step(BATCH, device=dev)
    fused_pair("a", QUAD_3D, q3_spec, fargs, q3_cfg, count=True)
    if b3_active.calls != 24:
        raise SystemExit(f"phase 10a failed: counted {b3_active.calls} activation tests, "
                         f"not one a Newton step")
    fx1, fu1, fU1 = fstep_k(*fargs)
    fused_pair("a", QUAD_3D, q3_spec, (fx1, fargs[1], fargs[2], fu1, fU1), q3_cfg)

    kern = fused_pair("b", DYNAMIC_UNICYCLE_2D, spec, (xs, goals, obs, u_prevs, Us), du_cfg)
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
    fused_pair("c", VTOL_2D, vt_spec, (v_xs, v_goal, v_obs, torch.zeros((vb, 4), device=dev),
                                       torch.zeros((vb, 16, 4), device=dev)), vt_cfg)
    ib = 64
    two_obs = pad_obstacles([[2.5, 0.8, 0.4, 0, 0, 0, 0], [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], 5,
                            device=dev)[None].repeat(ib, 1, 1)
    for model, nx in ((SINGLE_INTEGRATOR_2D, 2), (DOUBLE_INTEGRATOR_2D, 4)):
        i_xs = torch.as_tensor(np.concatenate(
            [rng.uniform(0, 3, (ib, 2)), rng.uniform(-0.5, 0.5, (ib, nx - 2))], axis=1),
            dtype=torch.float32, device=dev)
        i_goal = torch.zeros((ib, nx), device=dev)
        i_goal[:, :2] = torch.tensor([5.0, 1.0], device=dev)
        fused_pair("d", model, make_spec(model), (i_xs, i_goal, two_obs,
                                                  torch.zeros((ib, 2), device=dev),
                                                  torch.zeros((ib, 10, 2), device=dev)), int_cfg)
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
        "max_abs_err": max(qp_dx, qp_dy),
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
        "max_abs_err": fused_max_err,
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
