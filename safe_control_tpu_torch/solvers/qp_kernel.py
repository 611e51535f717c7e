"""Batched dense QP solve with the staged ADMM sweep and its finish in two
CUDA kernels.

Port of ``safe_control_tpu/solvers/qp_kernel.py``: the hot op behind every
CBF-QP, optimal-decay and BackupCBF control step.  The row and column
equilibration (``qp.equilibrate``) runs as PyTorch ops before one kernel
launch, which runs the whole ADMM iteration: A'A once, then 8 stages that
each refactor K = P + sigma I + rho A'A (n x n Cholesky) and run
``iters // 8`` over-relaxed x/z/y sweeps with a clip projection, with a
per-problem adaptive rho between stages (``csrc/qp_admm_kernel.cu``).  A
second launch finishes the solve (``csrc/qp_finish_kernel.cu``, traced as
the span ``qp.finish``): the one-shot active-set polish, the unscaling and
the residuals of ``qp.finish``, the KKT system over the active rows only:
one thread a problem where a block's 32 fit in 48 KB of shared memory (n=2
up to m=12, n=3 up to m=10), else one block of 128 threads a problem, its
system in shared memory up to 63 unknowns and in a workspace past that.

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
sweep's launches, ``LANE_LAUNCH_COUNT`` those of one lane a problem, and
``FINISH_LAUNCH_COUNT`` the finish's.

``solve_qp_batch_reference`` is the plain PyTorch version of both: the
same operations, every sum taken in the kernels' order (A'A over rows
left to right, the right-hand side over rows, Ax over columns; the
finish's LU as ``_finish_plain`` says), so that on the card the two agree
to rounding.  Only the elementwise steps over the m rows are vectorized.
``solve_qp_batch`` takes it for CPU tensors; for CUDA tensors it launches
the kernels, or raises.

The adaptive-rho rule is the kernel's own, ``rho * clip(sqrt(ratio), 0.1,
10)``, the same rule as ``qp.solve_qp`` up to rounding.
"""

from __future__ import annotations

import contextlib
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

# Sweep launches made by ``solve_qp_batch`` (CPU calls do not count), those
# of them in the one-lane shape, and the finish's launches (one a sweep).
LAUNCH_COUNT = 0
LANE_LAUNCH_COUNT = 0
FINISH_LAUNCH_COUNT = 0
graphs.count_launches(__name__, also=("LANE_LAUNCH_COUNT", "FINISH_LAUNCH_COUNT"))


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
    launch the two CUDA kernels on the current stream, traced as the spans
    ``qp.kernel`` and ``qp.finish`` (after ``qp.equilibrate``).  Returns a
    batched ``QPSolution`` in the original variables.
    """
    _check_inputs(P, q, A, l, u)
    if A.device.type == "cpu":
        return solve_qp_batch_reference(P, q, A, l, u, iters, rho, sigma, alpha, polish)
    return _solve_cuda(P, q, A, l, u, iters, rho, sigma, alpha, polish)


def _solve_cuda(P, q, A, l, u, iters, rho, sigma, alpha, polish) -> qp.QPSolution:
    s = qp.equilibrate(P, q, A, l, u)
    with span("qp.kernel", device=True):
        x, y = _sweep_cuda(s.P, s.q, s.A, s.l, s.u, iters, rho, sigma, alpha)
    with span("qp.finish", device=True):
        return _finish_cuda(P, q, A, l, u, s, x, y, polish)


@contextlib.contextmanager
def _current_stream(device):
    """With ``device`` current, its current stream's handle, as the kernels'
    C entry points take it."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


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
    with _current_stream(A.device) as stream:
        err = lib.qp_admm_launch(
            P.data_ptr(), q.data_ptr(), A.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            x.data_ptr(), z.data_ptr(), y.data_ptr(), B, n, m,
            max(iters // N_STAGES, 1), _f32(rho0), _f32(sigma), _f32(alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"qp_admm_kernel launch failed: CUDA error {err}")
    _count_launch(B, n, m)
    return x, y


def _finish_cuda(P, q, A, l, u, s: qp.Scaled, x, y, polish: bool, polish_reg=1e-8,
                 act_tol=1e-4) -> qp.QPSolution:
    """One kernel launch for ``qp.finish``'s work: the polish, the
    unscaling and the residuals of the problems ``(P, q, A, l, u)``, their
    scaling ``s`` and the ADMM iterate ``x``, ``y`` in scaled variables.
    A workspace, where the library asks for one (systems that can pass
    63 unknowns), is allocated here."""
    from safe_control_tpu_torch import _build

    B, m, n = A.shape
    lib = _build.load_qp_finish_kernel()
    ins = [t.contiguous() for t in (P, q, A, l, u, *s, x, y)]
    out = qp.QPSolution(*(torch.empty(shape, dtype=torch.float32, device=A.device)
                          for shape in ((B, n), (B, m), (B,), (B,))))
    floats = lib.qp_finish_workspace(B, n, m)
    work = torch.empty(floats, dtype=torch.float32, device=A.device) if floats else None
    with _current_stream(A.device) as stream:
        err = lib.qp_finish_launch(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out),
            None if work is None else work.data_ptr(), B, n, m, int(polish),
            _f32(polish_reg), _f32(act_tol), stream,
        )
    if err != 0:
        raise RuntimeError(f"qp_finish_kernel launch failed: CUDA error {err}")
    global FINISH_LAUNCH_COUNT
    FINISH_LAUNCH_COUNT += 1
    return out


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
    with span("qp.finish", device=True):
        return _finish_plain(P, q, A, l, u, s, x, y, polish)


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
            z_hat = alpha * _a_times(A, xt) + oma * z
            z_new = torch.clamp(z_hat + y / rb, lo, hi)
            y = y + rb * (z_hat - z_new)
            x = alpha * xt + oma * x
            z = z_new
        r_prim = (_a_times(A, x) - z).abs().amax(-1)
        dual = q
        for j in range(n):
            dual = dual + P[:, :, j] * x[:, j:j + 1]
        for j in range(m):
            dual = dual + A[:, j, :] * y[:, j:j + 1]
        r_dual = dual.abs().amax(-1)
        ratio = torch.sqrt(torch.clamp_min(r_prim, 1e-12) / torch.clamp_min(r_dual, 1e-12))
        rho = torch.clamp(rho * torch.clamp(ratio, 0.1, 10.0), 1e-4, 1e5)
    return x, y


def _a_times(A, v):
    """``A (B, r, n)`` times ``v (B, n)``: (B, r), summed over columns left
    to right."""
    s = A[:, :, 0] * v[:, 0:1]
    for i in range(1, A.shape[-1]):
        s = s + A[:, :, i] * v[:, i:i + 1]
    return s


def _fma(a, b, c):
    """``a * b + c`` rounded once, as ``fmaf`` rounds it.  In float64 the
    product of two float32 values is exact; their sum with ``c``, rounded
    to odd there and then to float32, is the correctly rounded result
    (Boldo and Melquiond, "Emulation of FMA and correctly rounded sums:
    proved algorithms using rounding to odd", 2008).  Rounding to odd: where
    the float64 sum is inexact (TwoSum's error is not 0) and its last bit
    even, take its neighbour toward the exact sum.  Other types: two
    roundings (the kernel is float32 only)."""
    if c.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    inf = torch.tensor(float("inf"), dtype=s.dtype, device=s.device)
    s = torch.where(fix, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def _max_violation(A, l, u, v):
    """max(0, l - A v, A v - u) over the finite bounds of each problem's
    rows; NaN propagates."""
    av = _a_times(A, v)
    neg_inf = torch.full_like(av, float("-inf"))
    worst = torch.maximum(torch.where(torch.isfinite(l), l - av, neg_inf).amax(-1),
                          torch.where(torch.isfinite(u), av - u, neg_inf).amax(-1))
    return torch.clamp_min(worst, 0.0)


def _finish_plain(P, q, A, l, u, s: qp.Scaled, x, y, polish: bool, polish_reg=1e-8,
                  act_tol=1e-4) -> qp.QPSolution:
    """The finish kernel's body on ``(B, ...)`` tensors: ``qp.finish``'s
    polish, unscaling and residuals, in the kernel's operations and order.

    Ax and Px sum over columns left to right, A'y over rows in index order;
    the polish solves the KKT system over each problem's active rows
    (``_polish_plain``).  ``qp.finish`` computes the same function by
    ``torch.linalg.solve_ex`` on the full masked system and ``torch.sum``:
    on an H100 at n = 2 (a sum of two terms has one order) its x, y and
    primal residual are these bit for bit, its dual residual sums A'y in
    another order; on the CPU, LAPACK's getrf may order its sums otherwise.
    """
    if polish:
        x_p, y_p, ok = _polish_plain(s.P, s.q, s.A, s.l, s.u, x, y, polish_reg, act_tol)
        x = torch.where(ok[:, None], x_p, x)
        y = torch.where(ok[:, None], y_p, y)
    x = s.e * x
    y = y * s.d
    Ax = _a_times(A, x)
    neg_inf = torch.full_like(Ax, float("-inf"))
    prim = torch.maximum(
        torch.where(torch.isfinite(l), (l - Ax) * s.d, neg_inf).amax(-1),
        torch.where(torch.isfinite(u), (Ax - u) * s.d, neg_inf).amax(-1),
    )
    prim = torch.clamp_min(prim, 0.0)
    aty = A[:, 0, :] * y[:, 0:1]
    for j in range(1, A.shape[1]):
        aty = aty + A[:, j, :] * y[:, j:j + 1]
    dual = ((_a_times(P, x) + q) + aty).abs().amax(-1)
    return qp.QPSolution(x=x, y=y, prim_res=prim, dual_res=dual)


def _polish_plain(P, q, A, l, u, x, y, reg, act_tol):
    """The finish kernel's polish on ``(B, ...)`` tensors: ``(x_p, y_p, ok)``.

    Each problem's KKT system ``[P + reg I, Aa'; Aa, -reg I]`` over its k
    active rows Aa, in index order, with the right-hand side
    ``[-q; bound]`` as its last column, padded to the batch's largest k
    by rows and columns of the equation -nu = 0 (the full masked system's
    inactive rows: an exact zero in every other row and column, never a
    pivot, so the padding changes no other value).  LU with partial
    pivoting, the pivot the first row of the largest |a| from the diagonal
    down (a NaN is never taken), the multipliers a times the pivot's
    reciprocal, every update one fused multiply-add (``_fma``), the
    right-hand side eliminated alongside; then back substitution column by
    column from the last, in fused multiply-adds, dividing by the diagonal:
    the rounding of ``torch.linalg.solve_ex`` on an H100.  ``ok``: the
    system is not singular (no zero pivot), x_p is finite, and its
    violation exceeds x's by 1e-7 at most.
    """
    B, m, n = A.shape
    dtype, device = q.dtype, q.device
    Ax = _a_times(A, x)
    fl, fu = torch.isfinite(l), torch.isfinite(u)
    lower = fl & ((Ax - l < act_tol) | (y < -act_tol))
    upper = fu & ((u - Ax < act_tol) | (y > act_tol))
    act = lower | upper
    k = act.sum(-1)
    kmax = int(k.max()) if B else 0
    order = torch.argsort((~act).to(torch.uint8), dim=-1, stable=True)[:, :kmax]
    live = torch.arange(kmax, device=device) < k[:, None]  # compact row t holds an active row
    Aa = torch.where(live[..., None], torch.gather(A, 1, order[..., None].expand(B, kmax, n)),
                     torch.zeros((), dtype=dtype, device=device))
    bound = torch.gather(torch.where(upper, u, l), 1, order)
    N = n + kmax
    M = torch.zeros((B, N, N + 1), dtype=dtype, device=device)
    M[:, :n, :n] = P + reg * torch.eye(n, dtype=dtype, device=device)
    M[:, :n, n:N] = Aa.transpose(-1, -2)
    M[:, n:N, :n] = Aa
    M[:, n:N, n:N] = torch.diag_embed(torch.where(
        live, torch.tensor(-reg, dtype=dtype, device=device),
        torch.tensor(-1.0, dtype=dtype, device=device)))
    M[:, :n, N] = -q
    M[:, n:N, N] = torch.where(live, bound, torch.zeros((), dtype=dtype, device=device))

    rows = torch.arange(B, device=device)
    singular = torch.zeros(B, dtype=torch.bool, device=device)
    for c in range(N):
        v = M[:, c:N, c].abs()
        first = torch.where(torch.isnan(v), torch.full_like(v, -1.0), v).argmax(-1)
        p = c + torch.where(torch.isnan(v[:, 0]), torch.zeros_like(first), first)
        singular |= M[rows, p, c].abs() == 0
        row_c, row_p = M[rows, c].clone(), M[rows, p].clone()
        M[rows, p] = row_c
        M[rows, c] = row_p
        lmul = M[:, c + 1:N, c] * torch.reciprocal(M[:, c, c])[:, None]
        M[:, c + 1:N, c + 1:] = _fma(-lmul[..., None], M[:, c, None, c + 1:],
                                     M[:, c + 1:N, c + 1:])
    for c in range(N - 1, -1, -1):
        sol = M[:, c, N] / M[:, c, c]
        M[:, c, N] = sol
        M[:, :c, N] = _fma(-M[:, :c, c], sol[:, None], M[:, :c, N])

    x_p = M[:, :n, N]
    nu = torch.where(live, M[:, n:N, N], torch.zeros((), dtype=dtype, device=device))
    y_p = torch.zeros_like(y).scatter(1, order, nu)
    ok = (~singular & torch.isfinite(x_p).all(-1)
          & (_max_violation(A, l, u, x_p) <= _max_violation(A, l, u, x) + 1e-7))
    return x_p, y_p, ok
