"""Batched dense QP solver: OSQP-style ADMM plus an active-set polish.

Port of ``safe_control_tpu/solvers/qp.py``.  Problem form (OSQP
convention), one problem per row of a leading batch axis B:

    minimize    0.5 x' P x + q' x
    subject to  l <= A x <= u

``solve_qp`` equilibrates rows and columns (one Ruiz-like pass), runs 8
stages of ADMM with a per-problem adaptive rho (refactoring
K = P + sigma I + rho A'A once per stage), polishes on the detected active
set, unscales, and reports the residuals in row-scaled units.  Every shape
and iteration count is fixed; infeasibility shows in the residuals.

Small products are written as elementwise products and sums, so that no
matrix product on this path can run in TF32 on a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from safe_control_tpu_torch.solvers.chol import chol_factor, chol_solve_factored
from safe_control_tpu_torch.utils.profiling import span

N_STAGES = 8  # adaptive-rho refactorization points


class QPSolution(NamedTuple):
    x: torch.Tensor  # (B, n) primal solution
    y: torch.Tensor  # (B, m) dual solution
    prim_res: torch.Tensor  # (B,) max constraint violation, row-scaled units
    dual_res: torch.Tensor  # (B,) ||P x + q + A'y||_inf


def matvec(A, x):
    """``A (B, m, n) @ x (B, n)`` as an elementwise product and sum."""
    return (A * x[..., None, :]).sum(-1)


def rmatvec(A, y):
    """``A' (B, n, m) @ y (B, m)`` as an elementwise product and sum."""
    return (A * y[..., :, None]).sum(-2)


class Scaled(NamedTuple):
    """An equilibrated problem and its scalings: x = e x', y = d y'."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    d: torch.Tensor  # (B, m) row scaling
    e: torch.Tensor  # (B, n) column scaling


def equilibrate(P, q, A, l, u) -> Scaled:
    """One pass of row then column scaling.

    Rows are scaled to unit norm (zero rows, the padded constraints, get
    d = 1e6 and stay inert; infinite bounds stay infinite), then columns by
    ``1 / sqrt(column norm)``.  Traced as the span ``qp.equilibrate``, timed
    on the device too.
    """
    with span("qp.equilibrate", device=True):
        return _equilibrate(P, q, A, l, u)


def _equilibrate(P, q, A, l, u) -> Scaled:
    row_norm = torch.linalg.vector_norm(A, dim=-1)
    d = 1.0 / torch.clamp_min(row_norm, 1e-6)
    As = A * d[..., None]
    ls = torch.where(torch.isfinite(l), l * d, l)
    us = torch.where(torch.isfinite(u), u * d, u)
    col_norm = torch.linalg.vector_norm(As, dim=-2)
    e = 1.0 / torch.sqrt(torch.clamp_min(col_norm, 1e-6))
    As = As * e[..., None, :]
    Ps = e[..., :, None] * P * e[..., None, :]
    return Scaled(P=Ps, q=q * e, A=As, l=ls, u=us, d=d, e=e)


def finish(P, q, A, l, u, s: Scaled, x, y, polish: bool, polish_reg=1e-8,
           act_tol=1e-4) -> QPSolution:
    """Polish (optional), unscale, and compute the residuals.

    ``x``, ``y`` are the ADMM iterate in the scaled variables of ``s``.
    Residuals are in ROW-SCALED units: a row of norm 1e6 solved to float32
    precision has a raw residual near 1e-1 while being numerically exact.
    Traced as the span ``qp.finish``, timed on the device too.
    """
    with span("qp.finish", device=True):
        return _finish(P, q, A, l, u, s, x, y, polish, polish_reg, act_tol)


def _finish(P, q, A, l, u, s, x, y, polish, polish_reg, act_tol) -> QPSolution:
    if polish:
        x, y = _polish(s.P, s.q, s.A, s.l, s.u, x, y, polish_reg, act_tol)
    x = s.e * x
    y = y * s.d
    Ax = matvec(A, x)
    neg_inf = torch.full_like(Ax, float("-inf"))
    prim = torch.maximum(
        torch.where(torch.isfinite(l), (l - Ax) * s.d, neg_inf).amax(-1),
        torch.where(torch.isfinite(u), (Ax - u) * s.d, neg_inf).amax(-1),
    )
    prim = torch.clamp_min(prim, 0.0)
    dual = (matvec(P, x) + q + rmatvec(A, y)).abs().amax(-1)
    return QPSolution(x=x, y=y, prim_res=prim, dual_res=dual)


def solve_qp(P, q, A, l, u, iters: int = 400, rho: float = 1.0, sigma: float = 1e-6,
             alpha: float = 1.6, polish: bool = True, polish_reg: float = 1e-8,
             act_tol: float = 1e-4) -> QPSolution:
    """Solve a batch of dense QPs: ``P (B,n,n)``, ``q (B,n)``, ``A (B,m,n)``,
    ``l``/``u (B,m)`` (infinite bounds allowed)."""
    s = equilibrate(P, q, A, l, u)
    Ps, qs, As, ls, us = s.P, s.q, s.A, s.l, s.u
    B, m, n = As.shape
    dtype, device = qs.dtype, qs.device
    per_stage = max(iters // N_STAGES, 1)
    AtA = (As[..., :, :, None] * As[..., :, None, :]).sum(-3)
    eye = torch.eye(n, dtype=dtype, device=device)

    x = torch.zeros((B, n), dtype=dtype, device=device)
    z = torch.zeros((B, m), dtype=dtype, device=device)
    y = torch.zeros((B, m), dtype=dtype, device=device)
    rho_c = torch.full((B,), rho, dtype=dtype, device=device)
    for _ in range(N_STAGES):
        L = chol_factor(Ps + sigma * eye + rho_c[:, None, None] * AtA)
        rb = rho_c[:, None]
        for _ in range(per_stage):
            rhs = sigma * x - qs + rmatvec(As, rb * z - y)
            x_t = chol_solve_factored(L, rhs)
            z_t = matvec(As, x_t)
            x_new = alpha * x_t + (1.0 - alpha) * x
            z_hat = alpha * z_t + (1.0 - alpha) * z
            z_new = torch.clamp(z_hat + y / rb, ls, us)
            y = y + rb * (z_hat - z_new)
            x, z = x_new, z_new
        r_prim = (matvec(As, x) - z).abs().amax(-1)
        r_dual = (matvec(Ps, x) + qs + rmatvec(As, y)).abs().amax(-1)
        ratio = torch.sqrt(torch.clamp_min(r_prim, 1e-12) / torch.clamp_min(r_dual, 1e-12))
        rho_new = torch.clamp(rho_c * ratio, rho_c * 0.1, rho_c * 10.0)
        rho_c = torch.clamp(rho_new, 1e-4, 1e5)
    return finish(P, q, A, l, u, s, x, y, polish, polish_reg, act_tol)


def _polish(P, q, A, l, u, x, y, reg, act_tol):
    """Masked-KKT refinement on the detected active set (batched).

    Builds the full (n+m) square KKT system in which inactive rows are
    replaced by the identity equation y_i = 0 (static shapes, no gather),
    and keeps the ADMM iterate where the polished point is not finite, the
    solve reports a singular matrix, or the point is less feasible.
    ``torch.linalg.solve_ex`` reports a singular matrix in ``info`` instead
    of raising (and does not synchronize a card), which is where
    ``jnp.linalg.solve`` returns non-finite values.
    """
    B, m, n = A.shape
    dtype, device = q.dtype, q.device
    fl, fu = torch.isfinite(l), torch.isfinite(u)
    Ax = matvec(A, x)
    lower_act = fl & ((Ax - l < act_tol) | (y < -act_tol))
    upper_act = fu & ((u - Ax < act_tol) | (y > act_tol))
    act = lower_act | upper_act
    zero = torch.zeros_like(l)
    bound = torch.where(upper_act, torch.where(fu, u, zero), torch.where(fl, l, zero))
    mask = act.to(dtype)

    mA = mask[..., None] * A
    top = torch.cat([P + reg * torch.eye(n, dtype=dtype, device=device), mA.transpose(-1, -2)],
                    dim=-1)
    bot = torch.cat([mA, torch.diag_embed(-reg + (mask - 1.0))], dim=-1)
    M = torch.cat([top, bot], dim=-2)
    rhs = torch.cat([-q, mask * bound], dim=-1)
    sol, info = torch.linalg.solve_ex(M, rhs[..., None])
    sol = sol[..., 0]
    x_p, nu = sol[..., :n], sol[..., n:]
    y_p = nu * mask

    def viol(xx):
        axx = matvec(A, xx)
        neg_inf = torch.full_like(axx, float("-inf"))
        v = torch.maximum(torch.where(fl, l - axx, neg_inf).amax(-1),
                          torch.where(fu, axx - u, neg_inf).amax(-1))
        return torch.clamp_min(v, 0.0)

    ok = (info == 0) & torch.isfinite(x_p).all(-1) & (viol(x_p) <= viol(x) + 1e-7)
    return (torch.where(ok[:, None], x_p, x), torch.where(ok[:, None], y_p, y))


def solve_box_qp_batch(P, q, A, l, u, **kwargs) -> QPSolution:
    """Batched convenience wrapper (``solve_qp`` is batched already)."""
    return solve_qp(P, q, A, l, u, **kwargs)
