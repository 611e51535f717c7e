"""Smoke test of the PyTorch port on one NVIDIA GPU (the port's main path).

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the fused DU MPC kernel from ``csrc/`` (nvcc).
2. Holds the kernel against its plain PyTorch version on the card at
   B=4096 with the main path's inputs and the full 8x3 budget
   (max |du| < 5e-3, viol atol 1e-3), and 64 problems against the general
   ``mpc_cbf.solve``.
3. Drives the main path, ``entry.build_step(batch=4096, device="cuda")``,
   for 5 warm-started steps; every output must be finite, the kernel's
   launch count must rise by at least 5, and on each step the first 64
   robots' controls must agree with the kernel's plain version given the
   same inputs.
4. Times the kernel and its plain version, and solves/s of the main path
   through the kernel and through the general solve, beside the card's name
   and power limit.

Prints one JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device and
when any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

DEVICE = "cuda"
BATCH = 4096
STEPS = 5
U_TOL = 5e-3  # kernel-class envelope: same algorithm, other op order
VIOL_TOL = 1e-3
N_GENERAL = 64  # problems checked against the general solve


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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

    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- phase 1: build ----------------------------------------------------
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

    print(json.dumps({"kernels": [{
        "name": "mpc_du_kernel",
        "route": "cuda",
        "source": "safe_control_tpu_torch/csrc/mpc_du_kernel.cu",
        "replaces": "safe_control_tpu/solvers/mpc_du_kernel.py:105",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
