"""The augmented-Lagrangian Gauss-Newton MPC-CBF solve that the fused
kernel runs: shift-by-one warm start, constraint rows scaled by their
Jacobian norms at the clipped warm start, forward-mode Jacobians, H = 2
Jr'Jr + rho Jca'Jca, the pivot-clamped Cholesky, the six-step noise-aware
line search on merit differences and the multiplier update, every sum left
to right.  Infinite state bounds are clamped to +-1e6."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)
BOUND_CLAMP = 1e6


class MPCSettings(NamedTuple):
    horizon: int
    num_obs: int
    outer_iters: int
    newton_iters: int
    rho0: float
    rho_growth: float
    rho_max: float
    reg: float
    viol_tol: float
    Q: tuple
    R: tuple


class Solution(NamedTuple):
    u: torch.Tensor  # (B, m)
    U: torch.Tensor  # (B, N, m)
    xs: torch.Tensor  # (B, N+1, n)
    viol: torch.Tensor  # (B,)
    active_rows: torch.Tensor  # () rows with a positive activation, summed over Newton steps


def settings_from(cfg: dict) -> MPCSettings:
    return MPCSettings(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()})


def jvp_jacobian(fn, Uf):
    """Values and forward-mode Jacobians ``(B, D, R_i)`` of a batched map."""
    B, D = Uf.shape
    basis = torch.eye(D, dtype=Uf.dtype, device=Uf.device)[:, None, :].expand(D, B, D)
    primal, tangents = torch.func.vmap(
        lambda t: torch.func.jvp(fn, (Uf,), (t,)), out_dims=(None, 0))(basis)
    return primal, tuple(t.transpose(0, 1) for t in tangents)


def chol_factor(H):
    """Lower Cholesky factor with the pivot clamped at 1e-20."""
    D = H.shape[-1]
    cols = []
    for j in range(D):
        s = H[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k : j - k + 1]
        d = torch.sqrt(torch.clamp_min(s[..., :1], 1e-20))
        cols.append(torch.cat([d, s[..., 1:] / d], dim=-1))
    zeros = H.new_zeros(H.shape[:-2] + (D,))
    return torch.stack([torch.cat([zeros[..., :k], c], dim=-1) for k, c in enumerate(cols)],
                       dim=-1)


def chol_solve_factored(L, g):
    """``L L' x = g`` by forward and back substitution, row by row."""
    D = L.shape[-1]
    w = []
    for i in range(D):
        s = g[..., i]
        for k in range(i):
            s = s - L[..., i, k] * w[k]
        w.append(s / L[..., i, i])
    x = [None] * D
    for i in reversed(range(D)):
        s = w[i]
        for k in range(i + 1, D):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def _seqsum(terms):
    total = None
    for t in terms:
        total = t if total is None else total + t
    return total


class Problem:
    """One configuration's rows: residuals, raw constraint rows and rollout
    at a batch of decision vectors."""

    def __init__(self, model, st: MPCSettings, dt, xs, goals, obs, u_prevs):
        self.model, self.st, self.dt = model, st, dt
        self.xs, self.goals, self.obs_b, self.u_prevs = xs, goals, obs[:, None, :, :], u_prevs
        self.N, self.m, self.n = st.horizon, model.m, model.n
        self.M = self.N * self.m
        dtype, dev = xs.dtype, xs.device
        tensor = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        self.Qs, self.Rs = torch.sqrt(tensor(st.Q)), torch.sqrt(tensor(st.R))
        lbu, ubu = model.u_box()
        self.lb, self.ub = tensor(lbu * self.N), tensor(ubu * self.N)
        self.bounded = tuple((i, max(lo, -BOUND_CLAMP), min(hi, BOUND_CLAMP))
                             for i, lo, hi in model.bounded_states())

    def rows(self, Uf):
        model, N, m, n = self.model, self.N, self.m, self.n
        spec = model.spec
        lead = Uf.shape[:-1]
        U = Uf.reshape(lead + (N, m))
        x = self.xs.expand(lead + (n,))
        states = [x]
        for k in range(N):
            x = model.step(x, U[..., k, :], self.dt)
            states.append(x)
        XS = torch.stack(states, dim=-2)
        state_res = (XS[..., 1:, :] - self.goals[:, None, :]) * self.Qs
        prev = torch.cat([self.u_prevs.expand(lead + (m,))[..., None, :], U[..., :-1, :]], dim=-2)
        input_res = (U - prev) * self.Rs
        r = torch.cat([state_res.reshape(lead + (N * n,)), input_res.reshape(lead + (self.M,))],
                      -1)
        Hh = model.dt_h(XS[..., :, None, :], self.obs_b)
        h_k, h_k1 = Hh[..., :N, :], Hh[..., 1:, :]
        if model.rel_deg == 1:
            cbf = (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k
        else:
            a12s = spec.mpc_cbf_alpha1 + spec.mpc_cbf_alpha2
            a12p = spec.mpc_cbf_alpha1 * spec.mpc_cbf_alpha2
            x2 = model.step(XS[..., 1:, :], U, self.dt)
            H2 = model.dt_h(x2[..., :, None, :], self.obs_b)
            cbf = ((H2 - 2.0 * h_k1) + h_k) + a12s * (h_k1 - h_k) + a12p * h_k
        cons = [cbf.reshape(lead + (N * self.st.num_obs,))]
        for i, lo, hi in self.bounded:
            col = XS[..., 1:, i]
            cons += [hi - col, col - lo]
        return r, torch.cat(cons, dim=-1), XS

    def warm(self, U_warm):
        """The clipped shift-by-one warm start and the row scales there."""
        B = U_warm.shape[0]
        U0 = torch.cat([U_warm[:, 1:], U_warm[:, -1:]], dim=1)
        Uf = torch.clamp(U0.reshape(B, self.M), self.lb, self.ub)
        _, (Jc0,) = jvp_jacobian(lambda u: (self.rows(u)[1],), Uf)
        ssq = _seqsum(Jc0[:, d] * Jc0[:, d] for d in range(self.M))
        return Uf, 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-2)

    def objective(self, Uf, cs):
        """(cost ||r||^2, scaled violation) at ``Uf (B, M)``."""
        r, c, _ = self.rows(Uf)
        return (r * r).sum(-1), torch.clamp_min(-(c * cs).min(dim=-1).values, 0.0)


def solve(model, st: MPCSettings, dt, xs, goals, obs, u_prevs, U_warm) -> Solution:
    """The solve for ``xs (B, n)``, ``goals (B, n)``, ``obs (B, K, 7)``,
    ``u_prevs (B, m)`` and the previous solution ``U_warm (B, N, m)``."""
    pb = Problem(model, st, dt, xs, goals, obs, u_prevs)
    M, B = pb.M, xs.shape[0]
    dtype, dev = xs.dtype, xs.device
    Uf, cs = pb.warm(U_warm)
    NC = cs.shape[-1]
    lb, ub = pb.lb, pb.ub
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
    noise_eps = 4.0 * torch.finfo(dtype).eps
    M_t = torch.full((B,), float(M), dtype=dtype, device=dev)
    active = torch.zeros((), dtype=torch.float64, device=dev)

    def solve_chol(L, g):
        s, w = g.clone(), []
        for j in range(M):
            w.append(s[:, j] / L[:, j, j])
            s[:, j + 1:] = s[:, j + 1:] - L[:, j + 1:, j] * w[j][:, None]
        t, x = torch.stack(w, dim=-1), [None] * M
        for j in reversed(range(M)):
            x[j] = t[:, j] / L[:, j, j]
            t[:, :j] = t[:, :j] - L[:, j, :j] * x[j][:, None]
        return torch.stack(x, dim=-1)

    def newton_step(Uf, lam, rho):
        nonlocal active

        def rc(u):
            r, c, _ = pb.rows(u)
            return r, c * cs

        (r0, c0), (Jr, Jc) = jvp_jacobian(rc, Uf)
        act0 = torch.clamp_min(lam - rho[:, None] * c0, 0.0)
        NR = r0.shape[-1]
        g1 = _seqsum(Jr[:, :, i] * r0[:, i, None] for i in range(NR))
        g2 = _seqsum(Jc[:, :, i] * act0[:, i, None] for i in range(NC))
        grad = 2.0 * g1 - g2
        on = act0 > 0.0
        active = active + on.sum().to(torch.float64)
        Jca = Jc * on.to(dtype)[:, None, :]
        S1 = _seqsum(Jr[:, :, i, None] * Jr[:, None, :, i] for i in range(NR))
        S2 = _seqsum(Jca[:, :, i, None] * Jca[:, None, :, i] for i in range(NC))
        H = 2.0 * S1 + rho[:, None, None] * S2
        tr = _seqsum(H[:, i, i] for i in range(M))
        damp = st.reg * (1.0 + tr / M_t)
        H = H + torch.diag_embed(damp[:, None].expand(B, M))
        at_lb = (Uf <= lb + 1e-7) & (grad > 0.0)
        at_ub = (Uf >= ub - 1e-7) & (grad < 0.0)
        free = torch.logical_not(at_lb | at_ub)
        eye = torch.eye(M, dtype=dtype, device=dev).expand(B, M, M)
        Hf = torch.where(free[:, :, None] & free[:, None, :], H, eye)
        gf = torch.where(free, grad, torch.zeros_like(grad))
        step = -solve_chol(chol_factor(Hf), gf)
        cand = torch.clamp(Uf + alphas[:, None, None] * step, lb, ub)
        r_a, c_a, _ = pb.rows(cand)
        act_a = torch.clamp_min(lam - rho[:, None] * (c_a * cs), 0.0)
        d_cost = _seqsum((r_a[..., i] - r0[:, i]) * (r_a[..., i] + r0[:, i]) for i in range(NR))
        d_pen = _seqsum((act_a[..., i] - act0[:, i]) * (act_a[..., i] + act0[:, i])
                        for i in range(NC))
        deltas = d_cost + d_pen / (2.0 * rho)
        deltas = torch.where(torch.isfinite(deltas), deltas, torch.full_like(deltas, math.inf))
        best = torch.argmin(deltas, dim=0)
        rr = _seqsum(r0[:, i] * r0[:, i] for i in range(NR))
        aa = _seqsum(act0[:, i] * act0[:, i] for i in range(NC))
        noise_floor = noise_eps * (rr + aa / (2.0 * rho))
        Hs = _seqsum(Hf[:, :, j] * step[:, j, None] for j in range(M))
        pred = _seqsum(gf[:, i] * step[:, i] for i in range(M)) + 0.5 * _seqsum(
            step[:, i] * Hs[:, i] for i in range(M))
        best = torch.where(pred >= -noise_floor, torch.zeros_like(best), best)
        return torch.clamp(Uf + alphas[best][:, None] * step, lb, ub)

    lam = torch.zeros((B, NC), dtype=dtype, device=dev)
    rho = torch.full((B,), st.rho0, dtype=dtype, device=dev)
    for _ in range(st.outer_iters):
        for _ in range(st.newton_iters):
            Uf = newton_step(Uf, lam, rho)
        lam = torch.clamp_min(lam - rho[:, None] * (pb.rows(Uf)[1] * cs), 0.0)
        rho = torch.clamp_max(rho * st.rho_growth, st.rho_max)
    _, c, XS = pb.rows(Uf)
    viol = torch.clamp_min(-(c * cs).min(dim=-1).values, 0.0)
    U = Uf.reshape(B, pb.N, pb.m)
    return Solution(u=U[:, 0].contiguous(), U=U, xs=XS, viol=viol, active_rows=active)
