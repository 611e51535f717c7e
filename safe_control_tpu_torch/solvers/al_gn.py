"""Shared augmented-Lagrangian Gauss-Newton trajectory optimizer core.

Port of ``safe_control_tpu/solvers/al_gn.py``, the engine behind MPCC
(``solvers/mpcc.py``): minimize ||residual(U)||^2 subject to
constraints(U) >= 0 and a box on the flat decision vector, batched over a
leading axis B.  The algorithm is the JAX package's, step for step:

- constraint rows scaled by the norms of their Jacobian rows at the warm
  start (before it is clipped to the box);
- forward-mode Jacobians only: one ``torch.func.jvp`` under ``vmap`` of the
  combined residual / constraint function; grad = 2 Jr'r - Jc'act and
  H = 2 Jr'Jr + rho Jca'Jca;
- the trace-scaled damping reg (1 + tr(H) / D) I and the projected Newton
  step, with the free set masked at active box bounds (eps_b = 1e-7);
- the six-step merit-difference line search (a non-finite merit counts as
  +inf) with the noise-floor acceptance of the damped Newton step;
- the capped-rho outer loop with the multiplier update.

The projected system is solved by ``chol.chol_factor_steps`` and
``chol.chol_solve_steps``: D column steps of the pivot-clamped factor and D
row steps of each substitution (the JAX package's scalar and 8x8-blocked
Cholesky tiers are XLA devices and are not ported).  Every shape and
iteration count is fixed, and nothing is read back to the host, so a solve
can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from safe_control_tpu_torch.core.types import device_constant
from safe_control_tpu_torch.solvers.chol import chol_factor_steps, chol_solve_steps
from safe_control_tpu_torch.solvers.mpc_cbf import _jvp_jacobian

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)


class ALGNConfig(NamedTuple):
    outer_iters: int = 12
    newton_iters: int = 4
    rho0: float = 50.0
    rho_growth: float = 1.6
    rho_max: float = 2000.0
    reg: float = 1e-6


def solve(residual: Callable, constraints: Callable, U0_flat, lb_flat, ub_flat,
          cfg: ALGNConfig = ALGNConfig(), *, joint: Optional[Callable] = None,
          jacobian: Optional[Callable] = None):
    """Returns ``(U_flat (B, D), scaled constraint values (B, C))``.

    ``residual`` and ``constraints`` map ``U (..., B, D)`` to ``(..., B, R)``
    and ``(..., B, C)``, each problem depending on its own row only (the
    line search calls them with a leading axis of six step lengths).
    ``joint``, when given, returns both from one evaluation (one rollout
    instead of two where they share it) and is used wherever both are
    needed; it may return a third element, ``aux`` (its rollout, say, with
    the leading axes of U), which is handed to ``jacobian``.
    ``jacobian``, when given, maps ``U (B, D)`` and the ``aux`` of a
    ``joint`` evaluation at the same U (or None) to ``((r, c), (Jr, Jc))``
    with the Jacobians as ``_jvp_jacobian`` lays them out (``(B, D, rows)``,
    row d = d out / d U_d) and the constraints unscaled; it stands in for
    the ``vmap(jvp)`` of ``joint`` (a model with a recursive rollout can
    chain its per-stage Jacobians in far fewer operations).  The values at
    each accepted step are those the line search computed for it: the
    multiplier update and the next Newton step reuse them.
    ``lb_flat`` / ``ub_flat`` are ``(D,)`` or ``(B, D)``.
    """
    dtype, device = U0_flat.dtype, U0_flat.device
    D = U0_flat.shape[-1]

    B = U0_flat.shape[0]
    rows = torch.arange(B, device=device)
    if jacobian is not None:
        _, (_, Jc0) = jacobian(U0_flat, None)
    else:
        _, (Jc0,) = _jvp_jacobian(lambda u: (constraints(u),), U0_flat)  # (B, D, C)
    c_scale = 1.0 / torch.clamp_min(torch.linalg.vector_norm(Jc0, dim=1), 1e-2)

    def rc(u):
        """(r, scaled c, aux or None) at ``u``."""
        if joint is not None:
            r, c, *aux = joint(u)
            return r, c * c_scale, (aux[0] if aux else None)
        return residual(u), constraints(u) * c_scale, None

    def rc_jacobian(u, aux):
        if jacobian is None:
            return _jvp_jacobian(lambda v: rc(v)[:2], u)
        (r, c), (Jr, Jc) = jacobian(u, aux)
        return (r, c * c_scale), (Jr, Jc * c_scale[:, None, :])

    alphas = device_constant(ALPHAS, dtype=dtype, device=device)
    noise_eps = 4.0 * torch.finfo(dtype).eps
    eye = torch.eye(D, dtype=dtype, device=device)

    def newton_step(Uf, lam, rho, aux):
        """One projected Gauss-Newton step from ``Uf``; returns the new
        point, its scaled constraint values and its ``aux``."""
        (r0, c0), (Jr, Jc) = rc_jacobian(Uf, aux)  # Jr (B, D, R), Jc (B, D, C)
        act0 = torch.clamp_min(lam - rho * c0, 0.0)
        grad = 2.0 * (Jr @ r0[..., None])[..., 0] - (Jc @ act0[..., None])[..., 0]
        Jca = Jc * (act0 > 0.0).to(dtype)[:, None, :]
        H = 2.0 * (Jr @ Jr.transpose(1, 2)) + rho * (Jca @ Jca.transpose(1, 2))
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + cfg.reg * eye * (1.0 + tr / D)[:, None, None]
        at_lb = (Uf <= lb_flat + 1e-7) & (grad > 0.0)
        at_ub = (Uf >= ub_flat - 1e-7) & (grad < 0.0)
        free = torch.logical_not(at_lb | at_ub).to(dtype)
        Hf = free[:, :, None] * H * free[:, None, :] + torch.diag_embed(1.0 - free)
        gf = free * grad
        step = -chol_solve_steps(chol_factor_steps(Hf), gf)

        # Merit differences, cancellation-free, all six step lengths at once:
        # L(a) - L(0) = (r_a - r_0).(r_a + r_0) + (act_a - act_0).(act_a + act_0) / (2 rho).
        cand = torch.clamp(Uf + alphas[:, None, None] * step, lb_flat, ub_flat)
        r_a, c_a, aux_a = rc(cand)
        act_a = torch.clamp_min(lam - rho * c_a, 0.0)
        vals = ((r_a - r0) * (r_a + r0)).sum(-1) + ((act_a - act0) * (act_a + act0)).sum(
            -1) / (2.0 * rho)
        vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, float("inf")))
        # Noise-phase acceptance: a predicted decrease below the merit's
        # rounding floor takes the damped Newton step.
        noise_floor = noise_eps * ((r0 * r0).sum(-1) + (act0 * act0).sum(-1) / (2.0 * rho))
        pred = (gf * step).sum(-1) + 0.5 * (step * (Hf @ step[..., None])[..., 0]).sum(-1)
        best = torch.where(pred >= -noise_floor, torch.zeros_like(pred, dtype=torch.long),
                           torch.argmin(vals, dim=0))
        # the accepted point is candidate ``best``: the same operations
        return (torch.clamp(Uf + alphas[best][:, None] * step, lb_flat, ub_flat),
                c_a[best, rows], None if aux_a is None else aux_a[best, rows])

    Uf = torch.clamp(U0_flat, lb_flat, ub_flat)
    lam = torch.zeros_like(Jc0[:, 0, :])
    rho = torch.full((), cfg.rho0, dtype=dtype, device=device)
    c, aux = None, None
    for _ in range(cfg.outer_iters):
        for _ in range(cfg.newton_iters):
            Uf, c, aux = newton_step(Uf, lam, rho, aux)
        if c is None:
            c = rc(Uf)[1]
        lam = torch.clamp_min(lam - rho * c, 0.0)
        rho = torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max)
    return Uf, rc(Uf)[1] if c is None else c
