"""Hold two builds of the fused DU MPC kernel against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 du_kernel_ab.py OTHER_DIR

``OTHER_DIR`` holds another ``mpc_du_kernel.cu`` with the same C entry
point (``mpc_du_launch``) and its ``mpc_du_kernel.h``, for example an earlier
commit's ``safe_control_tpu_torch/csrc`` unpacked with ``git archive`` into
the ignored ``build/`` directory.  The script builds the package's kernel
(``csrc/mpc_du_kernel.cu``) and the other one through ``_build`` (each
library named by its tree's sources) and prints each one's library and
ptxas report.  On the main path's inputs
(``entry.build_step``, cold start and the warm start one step later) it
checks, at B = 1, 17, 4096 and 4097, that the two builds give the same bits
and that the package's kernel agrees with its plain PyTorch version within
the kernel-class envelope (max |du| < 5e-3, viol atol 1e-3).  Then it times
both with CUDA events at B = 1, 4096 and 16384, in turns (other, this, this,
other), beside the card's name and power limit.  Exits non-zero when a
check fails or there is no card.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

U_TOL = 5e-3
VIOL_TOL = 1e-3
REPS = {1: 20, 4096: 10, 16384: 5}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("du_kernel_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    from chip_smoke import card_line, ptxas_summary, sync_time
    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

    dev = torch.device("cuda")
    card = card_line()
    print(card)

    # ---- build both ----------------------------------------------------------
    this = _build.load_mpc_du_kernel()
    info = _build.BUILD_INFO["mpc_du_kernel"]
    print(f"this build ({info['path']}): {info['seconds']:.1f} s; "
          f"ptxas: {ptxas_summary(info['ptxas'])}")
    other_src = Path(sys.argv[1]).resolve() / "mpc_du_kernel.cu"
    info = _build.build_sources([other_src])[other_src]
    print(f"other build ({info['path']}): {info['seconds']:.1f} s; "
          f"ptxas: {ptxas_summary(info['ptxas'])}")
    other = ctypes.CDLL(info["path"])
    other.mpc_du_launch.argtypes = this.mpc_du_launch.argtypes
    other.mpc_du_launch.restype = ctypes.c_int

    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    params = [float(p) for p in (entry.DT, spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2,
                                 spec.cbf_beta, spec.radius, spec.v_max, spec.a_max, spec.w_max)]

    def launcher(lib, ins):
        """A launch of ``lib`` on ``ins`` as ``solve_du_batch`` makes it."""
        xs, goals, obs, ups, Uw = ins
        B = xs.shape[0]
        U0 = duk._warm_start(Uw, params[6], params[7])
        U = torch.empty((B, duk.M), device=dev)
        viol = torch.empty((B,), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.mpc_du_launch(xs.data_ptr(), goals.data_ptr(), obs.data_ptr(),
                                    ups.data_ptr(), U0.data_ptr(), U.data_ptr(),
                                    viol.data_ptr(), B, *params, stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")
            return U, viol
        return run

    # ---- bits and the envelope -----------------------------------------------
    step, cold = entry.build_step(4096, device=dev)
    x1, u1, U1 = step(*cold)
    warm = (x1, cold[1], cold[2], u1, U1)
    cases = [("B=1 warm", [t[:1] for t in warm]), ("B=17 warm", [t[:17] for t in warm]),
             ("B=4096 cold", cold), ("B=4096 warm", warm),
             ("B=4097 cold", entry.build_step(4097, device=dev)[1])]
    failed = False
    for label, ins in cases:
        U_o, v_o = (t.clone() for t in launcher(other, ins)())
        U_t, v_t = (t.clone() for t in launcher(this, ins)())
        plain = duk.solve_du_batch_reference(*ins, params)
        torch.cuda.synchronize()
        same = torch.equal(U_o, U_t) and torch.equal(v_o, v_t)
        du = (U_t.reshape(-1, duk.N, 2)[:, 0] - plain.u).abs().max().item()
        dv = (v_t - plain.viol).abs().max().item()
        plain_same = torch.equal(U_t, plain.U.reshape(-1, duk.M)) and torch.equal(v_t, plain.viol)
        print(f"{label}: this vs other bit-identical {same} (max|dU| "
              f"{(U_o - U_t).abs().max().item():.3e}); this vs plain max|du| {du:.3e}, "
              f"max|dviol| {dv:.3e}, bit-identical {plain_same}")
        failed |= not (du < U_TOL and dv <= VIOL_TOL)

    # ---- times, in turns -----------------------------------------------------
    for B, reps in REPS.items():
        ins = cold if B == 4096 else entry.build_step(B, device=dev)[1]
        runs = {"other": launcher(other, ins), "this": launcher(this, ins)}
        for run in runs.values():
            run()
        ms = [(name, sync_time(runs[name], reps)) for name in ("other", "this", "this", "other")]
        print(f"[{card}] B={B}: " + ", ".join(f"{name} {t:.4f} ms" for name, t in ms))
    if failed:
        raise SystemExit("du_kernel_ab: this kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
