"""Hold two builds of the QP ADMM kernel against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 qp_kernel_ab.py OTHER_DIR

``OTHER_DIR`` holds another ``qp_admm_kernel.cu`` with the same C entry
point (``qp_admm_launch``), for example an earlier commit's
``safe_control_tpu_torch/csrc`` unpacked with ``git archive`` into the
ignored ``build/`` directory.  A build without ``qp_admm_shape`` is taken to
be the first port's, which reads and writes a (rows, B) layout: its inputs
are transposed for it, outside the timed launch, and its outputs back.  The
script builds the package's kernel (``csrc/qp_admm_kernel.cu``) and the
other one with the same nvcc flags and prints their ptxas reports at n=2
and n=3.  On the CBF-QP path's problems (``entry.build_cbf_qp_step``,
DoubleIntegrator2D, n=2, m=7, 1600 iterations), equilibrated as
``solve_qp_batch`` does, it checks at B = 1, 17, 4096 and 4097, and on
feasible random QPs at n=3, m=153 (B=256, 300 iterations), that the two
builds give the same bits and that the package's kernel gives the plain
sweep's bits, or else agrees within the envelope (max |dx| < 1e-3 at m=7,
2e-3 at m=153).  Then it times both launches with CUDA events at B = 1,
4096 and 16384, in turns (other, this, this, other), beside the card's
name and power limit.  Exits non-zero when a check fails or there is no
card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ITERS, RHO, SIGMA, ALPHA = 1600, 1.0, 1e-6, 1.6
REPS = {1: 20, 4096: 10, 16384: 10}
X_TOL = {7: 1e-3, 153: 2e-3}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qp_kernel_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    from chip_smoke import card_line, cbf_qp_data, ptxas_summary, sync_time, wide_qps
    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.solvers import qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    dev = torch.device("cuda")
    card = card_line()
    print(card)

    # ---- build both ----------------------------------------------------------
    this = _build.load_qp_admm_kernel()
    keep = {"qp_admm_kernel<2,%d,%d>" % qpk.launch_shape(7),
            "qp_admm_kernel<3,%d,%d>" % qpk.launch_shape(153), "qp_admm_kernel<2>",
            "qp_admm_kernel<3>"}
    print(f"this build: {_build.BUILD_INFO['qp_admm_kernel']['seconds']:.1f} s; ptxas: "
          f"{ptxas_summary(_build.BUILD_INFO['qp_admm_kernel']['ptxas'], keep)}")
    other_dir = Path(sys.argv[1]).resolve()
    out = _build.BUILD_DIR / "ab" / "libqp_admm_kernel_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(other_dir), "-o",
                           str(out), str(other_dir / "qp_admm_kernel.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {other_dir}:\n{proc.stdout}\n{proc.stderr}")
    print(f"other build ({other_dir}): ptxas: {ptxas_summary(proc.stdout + proc.stderr, keep)}")
    other = ctypes.CDLL(str(out))
    other.qp_admm_launch.argtypes = this.qp_admm_launch.argtypes
    other.qp_admm_launch.restype = ctypes.c_int
    rows_layout = not hasattr(other, "qp_admm_shape")
    print(f"other build's layout: {'(rows, B)' if rows_layout else '(B, ...)'}")

    def launcher(lib, scaled, iters, transpose):
        """A launch of ``lib`` on the equilibrated problems ``scaled`` as
        ``_sweep_cuda`` makes it; ``transpose``: in the (rows, B) layout.
        ``run()`` launches; ``result()`` gives x (B, n), y (B, m)."""
        P, q, A, lo, hi = scaled[:5]
        B, m, n = A.shape
        if transpose:
            ins = [t.reshape(B, -1).t().contiguous() for t in (P, q, A, lo, hi)]
            outs = [torch.empty((r, B), device=dev) for r in (n, m, m)]
        else:
            ins = [t.contiguous() for t in (P, q, A, lo, hi)]
            outs = [torch.empty((B, r), device=dev) for r in (n, m, m)]
        ptrs = [t.data_ptr() for t in ins + outs]
        stream = torch.cuda.current_stream().cuda_stream
        args = (B, n, m, max(iters // qpk.N_STAGES, 1), qpk._f32(RHO), qpk._f32(SIGMA),
                qpk._f32(ALPHA), stream)

        def run():
            err = lib.qp_admm_launch(*ptrs, *args)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")

        def result():
            x, _, y = outs
            return (x.t(), y.t()) if transpose else (x, y)
        run.tensors = ins + outs  # alive as long as the launch that reads and writes them
        return run, result

    # ---- bits and the envelope -----------------------------------------------
    _, path = entry.build_cbf_qp_step(4096, device=dev)
    data = cbf_qp_data(*path)
    cases = [("B=1", [t[:1] for t in data], ITERS), ("B=17", [t[:17] for t in data], ITERS),
             ("B=4096", data, ITERS),
             ("B=4097", cbf_qp_data(*entry.build_cbf_qp_step(4097, device=dev)[1]), ITERS),
             ("n=3 m=153 B=256", wide_qps(dev), 300)]
    failed = False
    for label, qps, iters in cases:
        scaled = qp.equilibrate(*qps)
        m = scaled.A.shape[1]
        run_o, res_o = launcher(other, scaled, iters, rows_layout)
        run_t, res_t = launcher(this, scaled, iters, False)
        run_o()
        run_t()
        x_p, y_p = qpk._sweep_plain(*scaled[:5], iters, RHO, SIGMA, ALPHA)
        torch.cuda.synchronize()
        (x_o, y_o), (x_t, y_t) = res_o(), res_t()
        same = torch.equal(x_o, x_t) and torch.equal(y_o, y_t)
        plain_same = torch.equal(x_t, x_p) and torch.equal(y_t, y_p)
        dx = (x_t - x_p).abs().max().item()
        print(f"{label}: this vs other bit-identical {same} (max|dx| "
              f"{(x_o - x_t).abs().max().item():.3e}); this vs plain sweep max|dx| {dx:.3e}, "
              f"max|dy| {(y_t - y_p).abs().max().item():.3e}, bit-identical {plain_same}")
        failed |= not dx < X_TOL[m]

    # ---- times, in turns -----------------------------------------------------
    for B, reps in REPS.items():
        qps = [t[:1] for t in data] if B == 1 else data if B == 4096 else \
            cbf_qp_data(*entry.build_cbf_qp_step(B, device=dev)[1])
        scaled = qp.equilibrate(*qps)
        runs = {"other": launcher(other, scaled, ITERS, rows_layout)[0],
                "this": launcher(this, scaled, ITERS, False)[0]}
        for run in runs.values():
            run()
        ms = [(name, sync_time(runs[name], reps)) for name in ("other", "this", "this", "other")]
        print(f"[{card}] B={B}, n=2, m=7, {ITERS} iterations: "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms))
    if failed:
        raise SystemExit("qp_kernel_ab: this kernel disagrees with the plain sweep")


if __name__ == "__main__":
    main()
