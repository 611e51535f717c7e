"""The continuous-time CBF-QP filter and its solver, as the QP kernel's
path runs it: rows from the barrier's gradient, one row-then-column
equilibration, the staged ADMM sweep (8 stages, each refactoring P + rho
A'A + sigma I, with a per-problem adaptive rho), the active-set polish on
the masked KKT system, unscaling and the residuals.

    min ||u - u_ref||^2   s.t.  A1 u + b1 >= 0,  u in [u_lb, u_ub]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.geometry import is_dummy
from portbench.reference.mpc import chol_factor, chol_solve_factored

N_STAGES = 8


class QPResult(NamedTuple):
    u: torch.Tensor  # (B, m)
    feasible: torch.Tensor  # (B,)
    prim_res: torch.Tensor  # (B,)


def _f32(v) -> float:
    return float(np.float32(v))


def cbf_rows(model, x, obs, mode="cbf"):
    """Relative-degree-1 rows ``(A_row (B, K, m), b (B, K))``, A u + b >= 0."""
    spec = model.spec
    xb = x[:, None, :]
    lead = torch.broadcast_shapes(xb.shape[:-1], obs.shape[:-1])
    n = x.shape[-1]
    xf = xb.expand(lead + (n,)).reshape(-1, n)
    of = obs.expand(lead + (obs.shape[-1],)).reshape(-1, obs.shape[-1])

    def one(xx, oo):
        dh, h = torch.func.grad_and_value(lambda z: model.ct_h(z, oo))(xx)
        return h, dh

    h, grad = torch.func.vmap(one)(xf, of)
    h, grad = h.reshape(lead), grad.reshape(lead + (n,))
    a_row = (grad[..., :, None] * model.g(xb)).sum(-2)
    b_f = (grad * model.f(xb)).sum(-1)
    if mode == "hard":
        raise ValueError("the benchmarked configurations use the 'cbf' rows")
    return a_row, b_f + spec.cbf_alpha * h


def assemble(model, x, u_ref, obs):
    """The batched QP data (P, q, A, l, u)."""
    B, m = u_ref.shape
    dtype, dev = x.dtype, x.device
    a_rows, b_vals = cbf_rows(model, x, obs)
    dummy = is_dummy(obs)
    a_rows = torch.where(dummy[..., None], torch.zeros_like(a_rows), a_rows)
    b_vals = torch.where(dummy, torch.ones_like(b_vals), b_vals)
    K = a_rows.shape[1]
    eye = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)
    lbu, ubu = model.u_box()
    lb = torch.tensor(lbu, dtype=dtype, device=dev).expand(B, m)
    ub = torch.tensor(ubu, dtype=dtype, device=dev).expand(B, m)
    P = 2.0 * eye
    q = -2.0 * u_ref
    A = torch.cat([a_rows, eye], dim=1)
    lo = torch.cat([-b_vals, lb], dim=1)
    hi = torch.cat([torch.full((B, K), float("inf"), dtype=dtype, device=dev), ub], dim=1)
    return P, q, A, lo, hi


def equilibrate(P, q, A, l, u):
    row_norm = torch.linalg.vector_norm(A, dim=-1)
    d = 1.0 / torch.clamp_min(row_norm, 1e-6)
    As = A * d[..., None]
    ls = torch.where(torch.isfinite(l), l * d, l)
    us = torch.where(torch.isfinite(u), u * d, u)
    col_norm = torch.linalg.vector_norm(As, dim=-2)
    e = 1.0 / torch.sqrt(torch.clamp_min(col_norm, 1e-6))
    As = As * e[..., None, :]
    Ps = e[..., :, None] * P * e[..., None, :]
    return Ps, q * e, As, ls, us, d, e


def admm(P, q, A, lo, hi, iters, rho0=1.0, sigma=1e-6, alpha=1.6):
    """The staged ADMM sweep on equilibrated data: returns x (B,n), y (B,m)."""
    rho0, sigma, alpha = _f32(rho0), _f32(sigma), _f32(alpha)
    oma = _f32(np.float32(1.0) - np.float32(alpha))
    B, m, n = A.shape
    dtype, dev = q.dtype, q.device
    per_stage = max(iters // N_STAGES, 1)
    eye = torch.eye(n, dtype=dtype, device=dev)
    AtA = A[:, 0, :, None] * A[:, 0, None, :]
    for k in range(1, m):
        AtA = AtA + A[:, k, :, None] * A[:, k, None, :]

    def a_times(v):
        s = A[:, :, 0] * v[:, 0:1]
        for i in range(1, n):
            s = s + A[:, :, i] * v[:, i:i + 1]
        return s

    x = torch.zeros((B, n), dtype=dtype, device=dev)
    z = torch.zeros((B, m), dtype=dtype, device=dev)
    y = torch.zeros((B, m), dtype=dtype, device=dev)
    rho = torch.full((B,), rho0, dtype=dtype, device=dev)
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


def _matvec(A, x):
    return (A * x[..., None, :]).sum(-1)


def _solve_ex(M, rhs):
    """``torch.linalg.solve_ex``; a type without an LU (bfloat16, float16)
    solves in float32 and rounds back."""
    if M.dtype in (torch.bfloat16, torch.float16):
        sol, info = torch.linalg.solve_ex(M.float(), rhs.float())
        return sol.to(M.dtype), info
    return torch.linalg.solve_ex(M, rhs)


def polish(P, q, A, l, u, x, y, reg=1e-8, act_tol=1e-4):
    """Masked-KKT refinement on the detected active set; the ADMM iterate
    stays where the polished point is not finite, singular or less
    feasible."""
    B, m, n = A.shape
    dtype, dev = q.dtype, q.device
    fl, fu = torch.isfinite(l), torch.isfinite(u)
    Ax = _matvec(A, x)
    lower_act = fl & ((Ax - l < act_tol) | (y < -act_tol))
    upper_act = fu & ((u - Ax < act_tol) | (y > act_tol))
    act = lower_act | upper_act
    zero = torch.zeros_like(l)
    bound = torch.where(upper_act, torch.where(fu, u, zero), torch.where(fl, l, zero))
    mask = act.to(dtype)
    mA = mask[..., None] * A
    top = torch.cat([P + reg * torch.eye(n, dtype=dtype, device=dev), mA.transpose(-1, -2)],
                    dim=-1)
    bot = torch.cat([mA, torch.diag_embed(-reg + (mask - 1.0))], dim=-1)
    M = torch.cat([top, bot], dim=-2)
    rhs = torch.cat([-q, mask * bound], dim=-1)
    sol, info = _solve_ex(M, rhs[..., None])
    sol = sol[..., 0]
    x_p, nu = sol[..., :n], sol[..., n:]
    y_p = nu * mask

    def viol(xx):
        axx = _matvec(A, xx)
        neg_inf = torch.full_like(axx, float("-inf"))
        v = torch.maximum(torch.where(fl, l - axx, neg_inf).amax(-1),
                          torch.where(fu, axx - u, neg_inf).amax(-1))
        return torch.clamp_min(v, 0.0)

    ok = (info == 0) & torch.isfinite(x_p).all(-1) & (viol(x_p) <= viol(x) + 1e-7)
    return torch.where(ok[:, None], x_p, x), torch.where(ok[:, None], y_p, y)


def solve(P, q, A, l, u, iters):
    """Equilibrate, sweep, polish, unscale: the filtered input and the
    row-scaled primal residual."""
    Ps, qs, As, ls, us, d, e = equilibrate(P, q, A, l, u)
    x, y = admm(Ps, qs, As, ls, us, iters)
    x, y = polish(Ps, qs, As, ls, us, x, y)
    x = e * x
    Ax = _matvec(A, x)
    neg_inf = torch.full_like(Ax, float("-inf"))
    prim = torch.maximum(torch.where(torch.isfinite(l), (l - Ax) * d, neg_inf).amax(-1),
                         torch.where(torch.isfinite(u), (Ax - u) * d, neg_inf).amax(-1))
    prim = torch.clamp_min(prim, 0.0)
    return QPResult(u=x, feasible=prim < 1e-3, prim_res=prim)


def cbf_qp(model, x, u_ref, obs, iters):
    return solve(*assemble(model, x, u_ref, obs), iters)
