"""Batched dense QP solve with the staged ADMM sweep in one CUDA kernel.

Port of ``safe_control_tpu/solvers/qp_kernel.py``: the hot op behind every
CBF-QP, optimal-decay and BackupCBF control step.  The row and column
equilibration (``qp.equilibrate``), the one-shot active-set polish, the
unscaling and the residuals (``qp.finish``) run as PyTorch ops around one
kernel launch, which runs the whole ADMM iteration: A'A once, then 8 stages
that each refactor K = P + sigma I + rho A'A (n x n Cholesky) and run
``iters // 8`` over-relaxed x/z/y sweeps with a clip projection, with a
per-problem adaptive rho between stages (``csrc/qp_admm_kernel.cu``).

The launch shape adapts the one kernel body to the batch.  A group of 8
to 32 lanes solves a problem, each lane holding its own rows in registers
and the sums over rows gathered by shuffle.  Where a problem of n = 2 or 3
variables and m >= 7 rows (the shapes measured against the groups) fits in
one thread's registers (m <= 12 at n=2, m <= 10 at n=3) and the batch is
large enough that the groups would run 2^18 lanes or more (B >= 16384 at
m = 9-12, B >= 32768 at m = 7-8), one lane solves it alone: every sum over
rows is a loop in that thread, with no shuffle, and a warp holds 32
problems.  Below that batch the groups win (one thread's sweep is a longer
chain than a group's).  The rule is the kernel's (``qp_admm_shape``), and
``launch_shape`` asks the built library.  ``LAUNCH_COUNT`` counts the
launches, ``LANE_LAUNCH_COUNT`` those of one lane a problem.

``solve_qp_batch_reference`` is the plain PyTorch version of that sweep:
the same operations, every sum taken in the kernel's order (A'A over rows
left to right, the right-hand side over rows, Ax over columns), so that on
the card the two agree to rounding.  Only the elementwise steps over the m
rows are vectorized.  ``solve_qp_batch`` takes it for CPU tensors; for CUDA
tensors it launches the kernel, or raises.

The adaptive-rho rule is the kernel's own, ``rho * clip(sqrt(ratio), 0.1,
10)``, the same rule as ``qp.solve_qp`` up to rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from safe_control_tpu_torch.core import graphs
from safe_control_tpu_torch.solvers import qp
from safe_control_tpu_torch.solvers.chol import chol_factor, chol_solve_factored
from safe_control_tpu_torch.utils.profiling import span

N_STAGES = qp.N_STAGES
MAX_N = 8  # variables per problem the kernel is instantiated for (1..8)
# Threads a block of the launch (csrc/qp_admm_kernel.cu): THREADS / G problems.
THREADS = 128
# Problems a launch takes: the kernel's B and its block and problem indices
# are 32-bit ints (per-problem offsets are size_t), and the block count
# rounds B up to whole blocks.
MAX_BATCH = 2**31 - THREADS

# Kernel launches made by ``solve_qp_batch`` (CPU calls do not count), and
# those of them in the one-lane shape.
LAUNCH_COUNT = 0
LANE_LAUNCH_COUNT = 0
graphs.count_launches(__name__, also=("LANE_LAUNCH_COUNT",))


def _f32(v) -> float:
    """``v`` rounded to float32, as the kernel receives it."""
    return float(np.float32(v))


def launch_shape(B: int, n: int, m: int) -> tuple[int, int]:
    """``(G, R)`` for ``B`` problems of ``n`` variables and ``m`` rows: G
    lanes per problem (1, or a group of 8 to 32) and R row slots a lane
    holds in registers (0: the rows stay in global memory).  Asks the
    built library (the kernel's ``qp_admm_shape``)."""
    from safe_control_tpu_torch import _build

    g, r = ctypes.c_int(), ctypes.c_int()
    _build.load_qp_admm_kernel().qp_admm_shape(B, n, m, ctypes.byref(g), ctypes.byref(r))
    return g.value, r.value


def _check_inputs(P, q, A, l, u) -> None:
    if A.ndim != 3:
        raise ValueError(f"A: expected shape (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    if not 1 <= n <= MAX_N or m < 1:
        raise ValueError(f"the QP kernel takes 1 <= n <= {MAX_N} variables and m >= 1 rows, "
                         f"got n={n}, m={m}")
    shapes = dict(P=(B, n, n), q=(B, n), A=(B, m, n), l=(B, m), u=(B, m))
    for name, t in dict(P=P, q=q, A=A, l=l, u=u).items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.device}")
    if A.device.type == "cuda" and q.dtype != torch.float32:
        raise NotImplementedError(f"the CUDA QP kernel is float32 only, got {q.dtype}")


def solve_qp_batch(P, q, A, l, u, iters: int = 1600, rho: float = 1.0,
                   sigma: float = 1e-6, alpha: float = 1.6, polish: bool = True
                   ) -> qp.QPSolution:
    """Batched QP solve: ``P (B,n,n)``, ``q (B,n)``, ``A (B,m,n)``,
    ``l``/``u (B,m)`` (infinite bounds allowed), n <= 8.

    CPU tensors go to ``solve_qp_batch_reference``; CUDA float32 tensors
    launch the CUDA kernel on the current stream, traced as the span
    ``qp.kernel`` (between ``qp.equilibrate`` and ``qp.finish``).  Returns
    a batched ``QPSolution`` in the original variables.
    """
    _check_inputs(P, q, A, l, u)
    if A.device.type == "cpu":
        return solve_qp_batch_reference(P, q, A, l, u, iters, rho, sigma, alpha, polish)
    s = qp.equilibrate(P, q, A, l, u)
    with span("qp.kernel", device=True):
        x, y = _sweep_cuda(s.P, s.q, s.A, s.l, s.u, iters, rho, sigma, alpha)
    return qp.finish(P, q, A, l, u, s, x, y, polish)


def _sweep_cuda(P, q, A, lo, hi, iters, rho0, sigma, alpha):
    """One kernel launch for the whole ADMM sweep: returns x (B,n), y (B,m).

    The kernel reads the (B, ...) tensors in place; ``qp.equilibrate``'s
    are contiguous, so nothing is copied.
    """
    from safe_control_tpu_torch import _build

    B, m, n = A.shape
    if B > MAX_BATCH:
        raise ValueError(f"the QP kernel takes at most {MAX_BATCH} problems a launch, got {B}")
    lib = _build.load_qp_admm_kernel()
    P, q, A, lo, hi = (t.contiguous() for t in (P, q, A, lo, hi))
    x = torch.empty((B, n), dtype=torch.float32, device=A.device)
    y = torch.empty((B, m), dtype=torch.float32, device=A.device)
    z = torch.empty((B, m), dtype=torch.float32, device=A.device)  # scratch past 256 rows
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.qp_admm_launch(
            P.data_ptr(), q.data_ptr(), A.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            x.data_ptr(), z.data_ptr(), y.data_ptr(), B, n, m,
            max(iters // N_STAGES, 1), _f32(rho0), _f32(sigma), _f32(alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"qp_admm_kernel launch failed: CUDA error {err}")
    _count_launch(B, n, m)
    return x, y


def _count_launch(B: int, n: int, m: int) -> None:
    """Count a launch of ``B`` problems of ``n`` variables and ``m`` rows: in
    ``LAUNCH_COUNT``, and in ``LANE_LAUNCH_COUNT`` where it runs one lane a
    problem."""
    global LAUNCH_COUNT, LANE_LAUNCH_COUNT
    LAUNCH_COUNT += 1
    if launch_shape(B, n, m)[0] == 1:
        LANE_LAUNCH_COUNT += 1


def solve_qp_batch_reference(P, q, A, l, u, iters: int = 1600, rho: float = 1.0,
                             sigma: float = 1e-6, alpha: float = 1.6, polish: bool = True
                             ) -> qp.QPSolution:
    """Plain PyTorch version of ``solve_qp_batch`` (same inputs and result)."""
    s = qp.equilibrate(P, q, A, l, u)
    x, y = _sweep_plain(s.P, s.q, s.A, s.l, s.u, iters, rho, sigma, alpha)
    return qp.finish(P, q, A, l, u, s, x, y, polish)


def _sweep_plain(P, q, A, lo, hi, iters, rho0, sigma, alpha):
    """The kernel body on ``(B, ...)`` tensors: returns x (B,n), y (B,m).

    Scalars are rounded to float32 first, as the kernel receives them.
    """
    rho0, sigma, alpha = _f32(rho0), _f32(sigma), _f32(alpha)
    oma = _f32(np.float32(1.0) - np.float32(alpha))
    B, m, n = A.shape
    dtype, device = q.dtype, q.device
    per_stage = max(iters // N_STAGES, 1)
    eye = torch.eye(n, dtype=dtype, device=device)

    AtA = A[:, 0, :, None] * A[:, 0, None, :]
    for k in range(1, m):
        AtA = AtA + A[:, k, :, None] * A[:, k, None, :]

    def a_times(v):
        """A v (B, m), summed over columns left to right."""
        s = A[:, :, 0] * v[:, 0:1]
        for i in range(1, n):
            s = s + A[:, :, i] * v[:, i:i + 1]
        return s

    x = torch.zeros((B, n), dtype=dtype, device=device)
    z = torch.zeros((B, m), dtype=dtype, device=device)
    y = torch.zeros((B, m), dtype=dtype, device=device)
    rho = torch.full((B,), rho0, dtype=dtype, device=device)
    for _ in range(N_STAGES):
        L = chol_factor(P + rho[:, None, None] * AtA + sigma * eye)
        rb = rho[:, None]
        for _ in range(per_stage):
            w = rb * z - y
            rhs = sigma * x - q
            for j in range(m):
                rhs = rhs + A[:, j, :] * w[:, j:j + 1]
            xt = chol_solve_factored(L, rhs)
            z_hat = alpha * a_times(xt) + oma * z
            z_new = torch.clamp(z_hat + y / rb, lo, hi)
            y = y + rb * (z_hat - z_new)
            x = alpha * xt + oma * x
            z = z_new
        r_prim = (a_times(x) - z).abs().amax(-1)
        dual = q
        for j in range(n):
            dual = dual + P[:, :, j] * x[:, j:j + 1]
        for j in range(m):
            dual = dual + A[:, j, :] * y[:, j:j + 1]
        r_dual = dual.abs().amax(-1)
        ratio = torch.sqrt(torch.clamp_min(r_prim, 1e-12) / torch.clamp_min(r_dual, 1e-12))
        rho = torch.clamp(rho * torch.clamp(ratio, 0.1, 10.0), 1e-4, 1e5)
    return x, y
