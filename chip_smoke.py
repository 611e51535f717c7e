"""Smoke test of the PyTorch port on one NVIDIA GPU (the port's main paths).

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds both CUDA kernels from ``csrc/`` (one nvcc each,
   started together); reports the fused DU MPC kernel's build.
2. Holds the DU kernel against its plain PyTorch version on the card at
   B=4096 with the main path's inputs and the full 8x3 budget
   (max |du| < 5e-3, viol atol 1e-3), and 64 problems against the general
   ``mpc_cbf.solve``.
3. Drives the MPC-CBF main path, ``entry.build_step(batch=4096,
   device="cuda")``, for 5 warm-started steps; every output must be finite,
   the kernel's launch count must rise by at least 5, and on each step the
   first 64 robots' controls must agree with the kernel's plain version
   given the same inputs.
4. Times the DU kernel and its plain version, and solves/s of the main path
   through the kernel and through the general solve.
5. Reports the QP ADMM kernel's build (seconds, ptxas registers and stack).
6. Holds the QP kernel against its plain version: (a) the B=4096
   DoubleIntegrator2D CBF-QPs of ``entry.build_cbf_qp_step`` at 1600
   iterations (max |dx| < 1e-3, equal ``feasible`` flags); (b) feasible
   random QPs at n=3, m=153 (the Manipulator2D scale), B=256, 300
   iterations (max |dx| < 2e-3 where both solve, at least 3/4 solved);
   (c) against the general ``qp.solve_qp`` on 64 main-path problems
   (|dx| < 2e-3 where both are feasible, equal ``feasible`` flags).
7. Drives the CBF-QP path, ``entry.build_cbf_qp_step(4096, device="cuda")``,
   for 5 closed-loop steps: finite outputs of the right shapes, at least 5
   QP kernel launches, and each step's first 64 robots within 1e-3 of the
   plain version on the same inputs.
8. Times the QP kernel and its plain version, and CBF-QP steps/s through
   the kernel and through the general path.

Every time is printed beside the card's name and power limit.  Prints one
JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device and
when any check fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    """One entry per compiled kernel: registers, stack frame and spills."""
    out, name, stack = [], "", ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            # the last "<name>_kernel" of the mangled name, and its template n
            found = re.findall(r"([a-z]+(?:_[a-z]+)*_kernel)(?:ILi(\d+)E)?", ln.split("'")[1])
            name = found[-1][0] + (f"<{found[-1][1]}>" if found[-1][1] else "") if found \
                else ln.split("'")[1]
        elif "bytes stack frame" in ln:
            stack = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {stack}")
    return " | ".join(out)


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    import numpy as np

    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.core.spec import (
        DOUBLE_INTEGRATOR_2D,
        DYNAMIC_UNICYCLE_2D,
        make_spec,
    )
    from safe_control_tpu_torch.dynamics import get_model
    from safe_control_tpu_torch.solvers import cbf_qp, mpc_cbf, qp
    from safe_control_tpu_torch.solvers import mpc_du_kernel as duk
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- phase 1: build (both kernels, one nvcc each, in parallel) -----------
    _build.build_all(["mpc_du_kernel", "qp_admm_kernel"])
    _build.load_mpc_du_kernel()
    info = _build.BUILD_INFO["mpc_du_kernel"]
    ptxas = [ln for ln in info["ptxas"].splitlines() if "mpc_du_kernel" in ln or "registers" in ln]
    print(f"phase 1 build: mpc_du_kernel {info['seconds']:.1f} s "
          f"(cached={info['cached']}); ptxas: {' | '.join(ln.strip() for ln in ptxas)}")

    # ---- phase 2: kernel vs its plain version at the main path's shapes --
    step_k, args = entry.build_step(BATCH, device=dev, use_fused_kernel=True)
    xs, goals, obs, u_prevs, Us = args
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    params = (entry.DT, spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2, spec.cbf_beta,
              spec.radius, spec.v_max, spec.a_max, spec.w_max)
    # two input sets: the cold start and the warm start one step later
    x1, u1, U1 = step_k(xs, goals, obs, u_prevs, Us)
    torch.cuda.synchronize()
    max_du = max_dU = max_dviol = 0.0
    for ins in ((xs, goals, obs, u_prevs, Us), (x1, goals, obs, u1, U1)):
        kern = duk.solve_du_batch(*ins, params)
        torch.cuda.synchronize()
        plain = duk.solve_du_batch_reference(*ins, params)
        torch.cuda.synchronize()
        max_du = max(max_du, (kern.u - plain.u).abs().max().item())
        max_dU = max(max_dU, (kern.U - plain.U).abs().max().item())
        max_dviol = max(max_dviol, (kern.viol - plain.viol).abs().max().item())
    max_abs_err = max(max_dU, max_dviol)
    print(f"phase 2 kernel vs plain (B={BATCH}, 2 input sets): max|du| {max_du:.3e}, "
          f"max|dU| {max_dU:.3e}, max|dviol| {max_dviol:.3e}")
    if not (max_du < U_TOL and max_dviol <= VIOL_TOL):
        raise SystemExit("phase 2 failed: kernel disagrees with its plain version")

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

    # ---- phase 5: the QP ADMM kernel's build ---------------------------------
    _build.load_qp_admm_kernel()
    info = _build.BUILD_INFO["qp_admm_kernel"]
    print(f"phase 5 build: qp_admm_kernel {info['seconds']:.1f} s (cached={info['cached']}, "
          f"built beside mpc_du_kernel); ptxas: {ptxas_summary(info['ptxas'])}")

    # ---- phase 6: QP kernel vs its plain version -------------------------------
    cstep_k, (qxs, qgoals, qobs) = entry.build_cbf_qp_step(BATCH, device=dev)
    di_spec = make_spec(DOUBLE_INTEGRATOR_2D)
    di = get_model(DOUBLE_INTEGRATOR_2D)

    def cbf_qp_data(x, gl, ob):
        """The CBF-QPs (P, q, A, l, u) that one step of the CBF-QP path solves."""
        u_ref = di.nominal_input(x, gl, di_spec)
        return cbf_qp._assemble(di, DOUBLE_INTEGRATOR_2D, di_spec, x, u_ref, ob,
                                entry.DT, "cbf")[:5]

    qp_data = cbf_qp_data(qxs, qgoals, qobs)
    kern = qpk.solve_qp_batch(*qp_data)
    torch.cuda.synchronize()
    plain = qpk.solve_qp_batch_reference(*qp_data)
    torch.cuda.synchronize()
    qp_dx = (kern.x - plain.x).abs().max().item()
    qp_dy = (kern.y - plain.y).abs().max().item()
    feas_k, feas_p = kern.prim_res < 1e-3, plain.prim_res < 1e-3
    feas_same = torch.equal(feas_k, feas_p)
    print(f"phase 6a QP kernel vs plain (B={BATCH}, n=2, m=7, 1600 iters): max|dx| {qp_dx:.3e}, "
          f"max|dy| {qp_dy:.3e}, bit-identical x {torch.equal(kern.x, plain.x)}, "
          f"feasible flags equal {feas_same} ({int(feas_k.sum())} feasible)")
    if not (qp_dx < QP_X_TOL and feas_same):
        raise SystemExit("phase 6a failed: QP kernel disagrees with its plain version")

    # Feasible-by-construction random QPs at the Manipulator2D scale: bounds
    # bracket A x_star, and 100 of the 153 rows are one-sided (CBF-style).
    rng = np.random.default_rng(7)
    wb, wn, wm = 256, 3, 153
    M = rng.normal(size=(wb, wn, wn))
    x_star = rng.normal(size=(wb, wn))
    A_w = rng.normal(size=(wb, wm, wn))
    Ax_w = np.einsum("bmn,bn->bm", A_w, x_star)
    l_w = Ax_w - rng.uniform(0.05, 1.5, size=(wb, wm))
    u_w = Ax_w + rng.uniform(0.05, 1.5, size=(wb, wm))
    u_w[:, :100] = np.inf
    wide = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in
            (M @ M.transpose(0, 2, 1) + np.eye(wn), rng.normal(size=(wb, wn)), A_w, l_w, u_w)]
    kern_w = qpk.solve_qp_batch(*wide, iters=300)
    torch.cuda.synchronize()
    plain_w = qpk.solve_qp_batch_reference(*wide, iters=300)
    both = (kern_w.prim_res < 1e-4) & (plain_w.prim_res < 1e-4)
    wide_dx = max_where((kern_w.x - plain_w.x).abs().amax(-1), both)
    print(f"phase 6b QP kernel vs plain (B={wb}, n={wn}, m={wm}, 300 iters): "
          f"{int(both.sum())}/{wb} solved by both, max|dx| {wide_dx:.3e}")
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
    scaled = qp.equilibrate(*qp_data)
    run_sweep = lambda: qpk._sweep_cuda(*scaled[:5], 1600, 1.0, 1e-6, 1.6)
    run_sweep()
    sweep_ms = sync_time(run_sweep, 10)
    run_qk = lambda: qpk.solve_qp_batch(*qp_data)
    run_qp = lambda: qpk.solve_qp_batch_reference(*qp_data)
    run_qk()
    qp_ms = sync_time(run_qk, 10)
    run_qp()
    qp_plain_ms = sync_time(run_qp, 2)
    cstep_g, _ = entry.build_cbf_qp_step(BATCH, device=dev, backend="xla")
    cstep_kernel = lambda: cstep_k(qxs, qgoals, qobs)
    cstep_general = lambda: cstep_g(qxs, qgoals, qobs)
    cstep_kernel()
    cstep_ms_k = sync_time(cstep_kernel, 10)
    cstep_general()
    cstep_ms_g = sync_time(cstep_general, 2)
    print(f"phase 8 [{card}] B={BATCH}: QP kernel path {qp_ms:.3f} ms/solve-batch "
          f"(the launch alone {sweep_ms:.3f} ms) vs plain version {qp_plain_ms:.1f} ms; "
          f"CBF-QP path {1e3 / cstep_ms_k:.1f} steps/s ({BATCH * 1e3 / cstep_ms_k:.1f} "
          f"robot-steps/s, {cstep_ms_k:.3f} ms/step) through the kernel vs "
          f"{1e3 / cstep_ms_g:.1f} steps/s ({cstep_ms_g:.1f} ms/step) through the general "
          f"solve_qp")

    print(json.dumps({"kernels": [{
        "name": "mpc_du_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/mpc_du_kernel.cu",
        "replaces": "safe_control_tpu/solvers/mpc_du_kernel.py:105",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "qp_admm_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/qp_admm_kernel.cu",
        "replaces": "safe_control_tpu/solvers/qp_kernel.py:101",
        "launches": qp_launches,
        "max_abs_err": max(qp_dx, qp_dy),
        "ms": qp_ms,
        "plain_ms": qp_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
