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
other one through ``_build`` (each library named by its tree's sources)
and prints their libraries and their ptxas reports for the
instantiations the shapes below launch, and for the group shape of each
(the only shape of a build before the one-lane one).

The shapes (``SHAPES``): the DPCBF sweep's QPs at B = 2^19 (n=2, m=10, 400
iterations), the DoubleIntegrator2D fleet's (B=4096, m=12, 1600), anchor 5's
groups (B=1365, m=10, 400), the CBF-QP path's (``entry.build_cbf_qp_step``,
DoubleIntegrator2D, n=2, m=7, 1600 iterations) at B = 1, 4096, 4097 and
16384, and n=3 at the widest m of one lane (B = 4096 and 16384, 1600) and
at m=8 from the batch that takes one lane (B = 32768, 1600); the m=10 and
m=12 problems at n=2 are CBF-QP-shaped (``cbf_shaped_qps``).  On each, equilibrated
as ``solve_qp_batch`` does, it checks that the two builds give the same bits
and that the package's kernel gives the plain sweep's bits (on a seeded
sample of 4,096 problems, the first and last 128 among them, past that
size), or else agrees within the envelope (max |dx| < 1e-3); and on
feasible random QPs at n=3, m=153 (B=256, 300 iterations; 2e-3).  Then it
times both launches with CUDA events on each shape, in turns (other, this,
this, other), beside the card's name and power limit and the package's
launch shape.  Exits non-zero when a check fails or there is no card.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

RHO, SIGMA, ALPHA = 1.0, 1e-6, 1.6
# label -> (n, m, B, iterations); the timed and checked shapes.
SHAPES = {
    "2^19 sweep": (2, 10, 2**19, 400),
    "DI fleet": (2, 12, 4096, 1600),
    "anchor 5": (2, 10, 1365, 400),
    "CBF-QP B=1": (2, 7, 1, 1600),
    "CBF-QP B=4096": (2, 7, 4096, 1600),
    "CBF-QP B=4097": (2, 7, 4097, 1600),
    "CBF-QP B=16384": (2, 7, 16384, 1600),
    "n=3 m=10 B=4096": (3, 10, 4096, 1600),
    "n=3 m=10 B=16384": (3, 10, 16384, 1600),
    "n=3 m=8 B=32768": (3, 8, 32768, 1600),
}
SAMPLE = 4096  # problems held to the plain sweep past this batch


def cbf_shaped_qps(B, k, seed, dev):
    """CBF-QP-shaped problems at n=2: ``k`` CBF rows, about a quarter of them
    inert (0 u + 1 >= 0, the padded obstacles), and the input box."""
    g = torch.Generator().manual_seed(seed)
    a_rows = torch.randn((B, k, 2), generator=g)
    b = 0.5 * torch.randn((B, k), generator=g)
    inert = torch.rand((B, k), generator=g) < 0.25
    a_rows[inert] = 0.0
    b[inert] = 1.0
    A = torch.cat([a_rows, torch.eye(2).expand(B, 2, 2)], dim=1)
    l = torch.cat([-b, torch.full((B, 2), -1.0)], dim=1)
    u = torch.cat([torch.full((B, k), float("inf")), torch.ones((B, 2))], dim=1)
    P = (2.0 * torch.eye(2)).expand(B, 2, 2).contiguous()
    q = -2.0 * (3.0 * torch.rand((B, 2), generator=g) - 1.5)
    return [t.to(dev) for t in (P, q, A, l, u)]


def shape_qps(n, m, B, dev):
    """The problems of a shape: the CBF-QP path's at m=7, random feasible
    QPs at n=3, CBF-QP-shaped ones otherwise."""
    from chip_smoke import cbf_qp_data, wide_qps
    from safe_control_tpu_torch import entry

    if m == 7:
        return cbf_qp_data(*entry.build_cbf_qp_step(B, device=dev)[1])
    if n == 3:
        return wide_qps(dev, B, 3, m)
    return cbf_shaped_qps(B, m - 2, seed=B + m, dev=dev)


def kernel_names(shapes) -> set:
    """The instantiations the ``(B, n, m)`` of ``shapes`` launch, and the
    group shape of each (the shape at B=1)."""
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    names = {"qp_admm_kernel<2>", "qp_admm_kernel<3>"}
    for B, n, m in shapes:
        for b in (B, 1):
            names.add("qp_admm_kernel<%d,%d,%d>" % (n, *qpk.launch_shape(b, n, m)))
    return names


def launcher(lib, scaled, iters, transpose):
    """A launch of ``lib`` on the equilibrated problems ``scaled`` as
    ``_sweep_cuda`` makes it; ``transpose``: in the (rows, B) layout.
    ``run()`` launches; ``result()`` gives x (B, n), y (B, m)."""
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    P, q, A, lo, hi = scaled[:5]
    B, m, n = A.shape
    dev = A.device
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


def sample(B, seed=2**31 + 29):
    """The problems held to the plain sweep: all up to SAMPLE, else a seeded
    sample with the first and the last 128."""
    if B <= SAMPLE:
        return None
    rows = set(np.random.default_rng(seed).choice(B, SAMPLE, replace=False).tolist())
    return sorted(rows | set(range(128)) | set(range(B - 128, B)))


def check(label, other, this, scaled, iters, rows_layout, tol) -> bool:
    """Run both builds on ``scaled`` and print their bits against each other
    and the package's against the plain sweep; whether it is in ``tol``."""
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    run_o, res_o = launcher(other, scaled, iters, rows_layout)
    run_t, res_t = launcher(this, scaled, iters, False)
    run_o()
    run_t()
    torch.cuda.synchronize()
    (x_o, y_o), (x_t, y_t) = res_o(), res_t()
    same = torch.equal(x_o, x_t) and torch.equal(y_o, y_t)
    idx = sample(x_t.shape[0])
    if idx is None:
        x_p, y_p = qpk._sweep_plain(*scaled[:5], iters, RHO, SIGMA, ALPHA)
    else:
        idx = torch.tensor(idx, device=x_t.device)
        x_t, y_t = x_t[idx], y_t[idx]
        x_p, y_p = qpk._sweep_plain(*(t[idx] for t in scaled[:5]), iters, RHO, SIGMA, ALPHA)
    plain_same = torch.equal(x_t, x_p) and torch.equal(y_t, y_p)
    dx = (x_t - x_p).abs().max().item()
    print(f"{label}: this vs other bit-identical {same} (max|dx| "
          f"{(x_o - x_t if idx is None else x_o[idx] - x_t).abs().max().item():.3e}); this "
          f"vs plain sweep{'' if idx is None else f' on {len(idx)} problems'} max|dx| "
          f"{dx:.3e}, max|dy| {(y_t - y_p).abs().max().item():.3e}, bit-identical {plain_same}",
          flush=True)
    return dx < tol


def time_pair(other, this, scaled, iters, rows_layout) -> list:
    """Milliseconds a launch of each build, in turns: other, this, this, other."""
    from chip_smoke import sync_time

    runs = {"other": launcher(other, scaled, iters, rows_layout)[0],
            "this": launcher(this, scaled, iters, False)[0]}
    for run in runs.values():
        run()
    first = sync_time(runs["this"], 1)
    reps = max(3, min(50, int(200.0 / max(first, 1e-3))))  # about 0.2 s a timing
    return [(name, sync_time(runs[name], reps)) for name in ("other", "this", "this", "other")]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qp_kernel_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    from chip_smoke import card_line, ptxas_summary, wide_qps
    from safe_control_tpu_torch import _build
    from safe_control_tpu_torch.solvers import qp
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    dev = torch.device("cuda")
    card = card_line()
    print(card)

    # ---- build both ----------------------------------------------------------
    this = _build.load_qp_admm_kernel()
    keep = kernel_names({(B, n, m) for n, m, B, _ in SHAPES.values()} | {(256, 3, 153)})
    info = _build.BUILD_INFO["qp_admm_kernel"]
    print(f"this build ({info['path']}): {info['seconds']:.1f} s; ptxas: "
          f"{ptxas_summary(info['ptxas'], keep)}")
    other_src = Path(sys.argv[1]).resolve() / "qp_admm_kernel.cu"
    info = _build.build_sources([other_src])[other_src]
    print(f"other build ({info['path']}): {info['seconds']:.1f} s; ptxas: "
          f"{ptxas_summary(info['ptxas'], keep)}")
    other = ctypes.CDLL(info["path"])
    other.qp_admm_launch.argtypes = this.qp_admm_launch.argtypes
    other.qp_admm_launch.restype = ctypes.c_int
    rows_layout = not hasattr(other, "qp_admm_shape")
    print(f"other build's layout: {'(rows, B)' if rows_layout else '(B, ...)'}", flush=True)

    # ---- bits and the envelope, then times in turns ----------------------------
    failed = False
    times = []
    for label, (n, m, B, iters) in SHAPES.items():
        scaled = qp.equilibrate(*shape_qps(n, m, B, dev))
        failed |= not check(label, other, this, scaled, iters, rows_layout, 1e-3)
        times.append((label, n, m, B, iters, time_pair(other, this, scaled, iters, rows_layout)))
        del scaled
    failed |= not check("n=3 m=153 B=256", other, this, qp.equilibrate(*wide_qps(dev)), 300,
                        rows_layout, 2e-3)
    for label, n, m, B, iters, ms in times:
        G, R = qpk.launch_shape(B, n, m)
        print(f"[{card}] {label}: B={B}, n={n}, m={m}, {iters} iterations, this build {G} "
              f"lane{'s' if G > 1 else ''} a problem, {R} register rows a lane: "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms)
              + f"; this / other {(ms[1][1] + ms[2][1]) / (ms[0][1] + ms[3][1]):.3f}")
    if failed:
        raise SystemExit("qp_kernel_ab: this kernel disagrees with the plain sweep")


if __name__ == "__main__":
    main()
