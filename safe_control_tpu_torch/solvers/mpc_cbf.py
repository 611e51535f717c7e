"""Discrete-time MPC-CBF as a batched augmented-Lagrangian Gauss-Newton solve.

Port of ``safe_control_tpu/solvers/mpc_cbf.py``.  The decision variable is
the control trajectory U (N, m); states come from a rollout of the model's
``step``; the discrete-time CBF rows and the state-bound rows are handled by
an augmented Lagrangian whose outer iterations each run projected
Gauss-Newton steps with a parallel line search over six step lengths.
Every shape and iteration count is fixed.

``solve`` is natively batched: every input carries a leading batch axis B.
The algorithm is the JAX package's, step for step: shift-by-one warm start
with cold multipliers, constraint rows scaled by their Jacobian norms at the
warm start, forward-mode Jacobians (``torch.func.jvp`` under
``torch.func.vmap``; no reverse mode), the damped projected Newton
direction, the cancellation-free merit-difference line search with
noise-aware acceptance, and the multiplier update.

``solve_batch`` routes the DynamicUnicycle2D N=8, K=5 configuration to the
fused kernel (``solvers/mpc_du_kernel.py``) when ``cfg.use_fused_kernel`` is
set and the inputs are float32, as the JAX package does.  ``solve_dispatch``
routes any configuration that ``mpc_fused.fused_available`` admits to the
generic fused kernel (``solvers/mpc_fused.py``), and logs every fallback.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.barriers.hocbf import dt_h as hocbf_dt_h
from safe_control_tpu_torch.barriers.hocbf import tensor_fields
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.dynamics.base import MODEL_REGISTRY
from safe_control_tpu_torch.solvers.chol import chol_solve

# Per-model cost weights (state Q diagonal, input-move R diagonal).
_WEIGHTS = {
    spec_mod.SINGLE_INTEGRATOR_2D: ([50.0, 50.0], [5.0, 5.0]),
    spec_mod.UNICYCLE_2D: ([50.0, 50.0, 0.01], [0.5, 0.5]),
    spec_mod.DYNAMIC_UNICYCLE_2D: ([50.0, 50.0, 0.01, 30.0], [0.5, 0.5]),
    spec_mod.DOUBLE_INTEGRATOR_2D: ([50.0, 50.0, 20.0, 20.0], [0.5, 0.5]),
    spec_mod.KINEMATIC_BICYCLE_2D: ([50.0, 50.0, 1.0, 1.0], [0.5, 5000.0]),
    spec_mod.KINEMATIC_BICYCLE_2D_C3BF: ([50.0, 50.0, 1.0, 1.0], [0.5, 5000.0]),
    spec_mod.KINEMATIC_BICYCLE_2D_DPCBF: ([50.0, 50.0, 1.0, 1.0], [0.5, 5000.0]),
    spec_mod.QUAD_2D: ([25.0, 25.0, 50.0, 10.0, 10.0, 50.0], [0.5, 0.5]),
    spec_mod.QUAD_3D: (
        [30.0, 30.0, 5.0, 20.0, 20.0, 1.0, 10.0, 10.0, 10.0, 20.0, 20.0, 1.0],
        [1.0, 1.0, 1.0, 1.0],
    ),
    spec_mod.VTOL_2D: ([10.0, 10.0, 250.0, 10.0, 10.0, 50.0], [0.5, 0.5, 0.5, 50000.0]),
}


def mpc_weights(model_name: str, *, device=None, dtype=torch.float32):
    q, r = _WEIGHTS[model_name]
    return (
        torch.tensor(q, device=device, dtype=dtype),
        torch.tensor(r, device=device, dtype=dtype),
    )


class MPCConfig(NamedTuple):
    """Solver configuration; the fields and defaults of the JAX package.

    ``optimal_decay``, ``polish_iters > 0`` and ``newton_f64`` are not ported
    yet: ``solve`` raises ``NotImplementedError`` when one is set.
    ``scan_unroll`` and ``loop_unroll`` are XLA dispatch levers; they are
    accepted and have no effect here.
    """

    horizon: int = 10
    num_obs: int = 5
    optimal_decay: bool = False
    p_sb: float = 10.0
    omega_ref: float = 1.0
    outer_iters: int = 8  # augmented-Lagrangian multiplier updates
    newton_iters: int = 3  # Gauss-Newton steps per outer iteration
    rho0: float = 50.0  # initial AL penalty
    rho_growth: float = 1.6
    rho_max: float = 2000.0
    reg: float = 1e-6  # Levenberg damping
    viol_tol: float = 0.05  # feasibility threshold, scaled units
    polish_iters: int = 0
    polish_ctol: float = 1e-2
    newton_f64: bool = False
    use_fused_kernel: bool = False
    scan_unroll: int = 1
    loop_unroll: bool = False


class MPCState(NamedTuple):
    """Warm-start state carried across control steps."""

    U: torch.Tensor  # (B, N, m) control trajectory
    lam: torch.Tensor  # (B, n_con) AL multipliers


class MPCResult(NamedTuple):
    u: torch.Tensor  # (B, m) first control
    state: MPCState  # solution, the warm start for the next step
    xs: torch.Tensor  # (B, N+1, n) predicted states incl. x0
    feasible: torch.Tensor  # (B,) bool
    viol: torch.Tensor  # (B,) max scaled constraint violation


def _check_supported(cfg: MPCConfig) -> None:
    for name, on in (
        ("optimal_decay", cfg.optimal_decay),
        ("polish_iters > 0", cfg.polish_iters > 0),
        ("newton_f64", cfg.newton_f64),
    ):
        if on:
            raise NotImplementedError(
                f"MPCConfig option {name} is not yet ported to safe_control_tpu_torch"
            )


def _model_name_of(model) -> str:
    for name, mod in MODEL_REGISTRY.items():
        if mod is model:
            return name
    raise ValueError("unregistered model module")


def _bounded_mask(model) -> np.ndarray:
    """Which state components carry finite bounds (a static structure query)."""
    lb, ub = model.state_bounds(
        spec_mod.make_spec(_model_name_of(model)), device="cpu", dtype=torch.float64
    )
    return np.isfinite(lb.numpy()) | np.isfinite(ub.numpy())


def _num_constraints(model, cfg: MPCConfig) -> int:
    n_bounded = int(_bounded_mask(model).sum())
    return cfg.horizon * cfg.num_obs + 2 * cfg.horizon * n_bounded


def init_state(model_name: str, cfg: MPCConfig, batch: int, *, device=None,
               dtype=torch.float32) -> MPCState:
    """Zero warm start for ``batch`` problems."""
    _check_supported(cfg)
    model = get_model(model_name)
    n_con = _num_constraints(model, cfg)
    return MPCState(
        U=torch.zeros((batch, cfg.horizon, model.N_CONTROLS), device=device, dtype=dtype),
        lam=torch.zeros((batch, n_con), device=device, dtype=dtype),
    )


def fused_kernel_available(model_name: str, cfg: MPCConfig) -> bool:
    """True iff ``solve_batch`` can dispatch to the fused DU kernel.

    The kernel is specialized to DynamicUnicycle2D, horizon N=8, K=5 obstacle
    slots, the default AL/GN iteration budget, no optimal-decay, no polish.
    """
    from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

    return (
        model_name == spec_mod.DYNAMIC_UNICYCLE_2D
        and cfg.horizon == duk.N
        and cfg.num_obs == duk.K
        and not cfg.optimal_decay
        and not cfg.newton_f64
        and cfg.outer_iters == duk.OUTER
        and cfg.newton_iters == duk.NEWTON
        and cfg.polish_iters == 0
        and float(cfg.rho0) == duk.RHO0
        and float(cfg.rho_growth) == duk.RHO_GROWTH
        and float(cfg.rho_max) == duk.RHO_MAX
        and float(cfg.reg) == duk.REG
    )


def solve_batch(model_name: str, spec, xs, goals, obs, u_prevs,
                mpc_state: MPCState, dt: float, cfg: MPCConfig = MPCConfig()
                ) -> MPCResult:
    """Batched MPC-CBF solve: (B, ...) leading axis on every tensor input.

    With ``cfg.use_fused_kernel``, a configuration that passes
    ``fused_kernel_available`` and float32 inputs, the whole solve runs in
    the fused DU kernel (its plain PyTorch version for CPU tensors) and the
    predicted states are rolled out with ``model.step``; the kernel path
    reports zero multipliers, which is equivalent because ``solve``
    cold-starts them anyway.  Otherwise it is ``solve``.
    """
    if (
        cfg.use_fused_kernel
        and fused_kernel_available(model_name, cfg)
        and xs.dtype == torch.float32
    ):
        from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

        model = get_model(model_name)
        params = (
            float(dt), float(spec.mpc_cbf_alpha1), float(spec.mpc_cbf_alpha2),
            float(spec.cbf_beta), float(spec.radius), float(spec.v_max),
            float(spec.a_max), float(spec.w_max),
        )
        res = duk.solve_du_batch(xs, goals, obs, u_prevs, mpc_state.U, params)
        x = xs
        pred = [xs]
        for k in range(cfg.horizon):
            x = model.step(x, res.U[:, k], spec, dt)
            pred.append(x)
        return MPCResult(
            u=res.u,
            state=MPCState(U=res.U, lam=torch.zeros_like(mpc_state.lam)),
            xs=torch.stack(pred, dim=1),
            feasible=res.viol <= cfg.viol_tol,
            viol=res.viol,
        )
    return solve(model_name, spec, xs, goals, obs, u_prevs, mpc_state, dt, cfg)


def solve_dispatch(model_name: str, spec, x0, goal, obs, u_prev, mpc_state: MPCState,
                   dt: float, cfg: MPCConfig = MPCConfig()) -> MPCResult:
    """``solve`` with opt-in routing to the generic fused kernel.

    With ``cfg.use_fused_kernel``, float32 inputs, a configuration that
    ``mpc_fused.fused_available`` admits and a spec of plain floats (the
    kernel takes the spec's values as scalars), the whole batch runs in
    ``mpc_fused.solve_fused_batch``: on CUDA tensors one kernel launch.  The
    kernel path reports zero multipliers, which is equivalent because
    ``solve`` cold-starts them.  Otherwise this is ``solve``, and each
    distinct reason for falling back is logged once.  Nothing here catches
    an error of the kernel's build or launch.
    """
    if cfg.use_fused_kernel and x0.dtype == torch.float32:
        from safe_control_tpu_torch.solvers import mpc_fused

        if cfg.newton_f64:
            _log_fused_fallback(
                "newton_f64 requested: the float32 fused kernel would drop the "
                "explicit float64 Newton refinement; using the general solve")
        elif not mpc_fused.fused_available(model_name, cfg):
            _log_fused_fallback(
                f"configuration unsupported by the fused kernel (model={model_name}, "
                f"M={cfg.horizon}*m, optimal_decay={cfg.optimal_decay}, "
                f"polish_iters={cfg.polish_iters})")
        elif tensor_fields(spec):
            _log_fused_fallback(
                "robot spec holds per-robot tensors (the kernel takes the spec's "
                "values as scalars); using the general solve")
        else:
            res = mpc_fused.solve_fused_batch(model_name, spec, x0, goal, obs, u_prev,
                                              mpc_state.U, dt, cfg)
            return MPCResult(
                u=res.u,
                state=MPCState(U=res.U, lam=torch.zeros_like(mpc_state.lam)),
                xs=res.xs,
                feasible=res.viol <= cfg.viol_tol,
                viol=res.viol,
            )
    return solve(model_name, spec, x0, goal, obs, u_prev, mpc_state, dt, cfg)


_FUSED_FALLBACK_SEEN: set = set()


def _log_fused_fallback(reason: str) -> None:
    """Log each distinct fallback reason once per process, so that a hot
    control loop does not repeat it every period."""
    if reason in _FUSED_FALLBACK_SEEN:
        return
    _FUSED_FALLBACK_SEEN.add(reason)
    logging.getLogger("safe_control_tpu_torch.solvers").warning(
        "fused-kernel dispatch fell back to the general solve: %s", reason)


def _jvp_jacobian(fn, Uf):
    """Primal value and forward-mode Jacobian of a batched map.

    ``fn`` maps ``Uf (B, D)`` to a tuple of ``(B, R_i)`` tensors, each
    problem depending only on its own row.  One ``jvp`` per unit tangent
    e_i (broadcast over the batch), vmapped over the D tangents, gives
    ``J_i (B, D, R_i)`` with row d = d out / d U_d.
    """
    B, D = Uf.shape
    basis = torch.eye(D, dtype=Uf.dtype, device=Uf.device)[:, None, :].expand(D, B, D)
    primal, tangents = torch.func.vmap(
        lambda t: torch.func.jvp(fn, (Uf,), (t,)), out_dims=(None, 0)
    )(basis)
    return primal, tuple(t.transpose(0, 1) for t in tangents)


def solve(model_name: str, spec, x0, goal, obs, u_prev, mpc_state: MPCState,
          dt: float, cfg: MPCConfig = MPCConfig()) -> MPCResult:
    """MPC-CBF solve for a batch of robots.

    ``x0 (B, n)``, ``goal (B, n)``, ``obs (B, K, 7)`` (padded obstacles),
    ``u_prev (B, m)`` and ``mpc_state`` with ``U (B, N, m)`` and
    ``lam (B, n_con)``.
    """
    _check_supported(cfg)
    model = get_model(model_name)
    N, n, m = cfg.horizon, model.N_STATES, model.N_CONTROLS
    B, D = x0.shape[0], cfg.horizon * model.N_CONTROLS
    dtype, device = x0.dtype, x0.device
    Qd, Rd = mpc_weights(model_name, device=device, dtype=dtype)
    Qs, Rs = torch.sqrt(Qd), torch.sqrt(Rd)
    lb_u = model.u_lb(spec, device=device, dtype=dtype)
    ub_u = model.u_ub(spec, device=device, dtype=dtype)
    lb_x, ub_x = model.state_bounds(spec, device=device, dtype=dtype)
    bounded_idx = tuple(int(i) for i in np.nonzero(_bounded_mask(model))[0])
    a1, a2 = spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2
    obs_b = obs[..., None, :, :]  # (B, 1, K, 7): broadcasts over the states axis

    # The closures below take U with any extra leading axes in front of the
    # batch axis (the line search evaluates all step lengths at once).
    def rollout(U):
        x = x0
        xs = []
        for k in range(N):
            x = model.step(x, U[..., k, :], spec, dt)
            xs.append(x)
        return torch.stack(xs, dim=-2)  # (..., B, N, n): x_1..x_N

    def residual(U):
        xs = rollout(U)
        state_res = (xs - goal[..., None, :]) * Qs
        up = u_prev.expand(U.shape[:-2] + (m,))[..., None, :]
        du = torch.diff(torch.cat([up, U], dim=-2), dim=-2)
        input_res = du * Rs
        lead = U.shape[:-2]
        return torch.cat(
            [state_res.reshape(lead + (N * n,)), input_res.reshape(lead + (N * m,))],
            dim=-1,
        )

    def h_all(states):
        """Barrier values for a stack of states: (..., S, n) -> (..., S, K)."""
        return hocbf_dt_h(model, model_name, states[..., :, None, :], obs_b, spec)

    def constraints(U):
        """All inequality constraints c(U) >= 0, fixed shape.

        Relative degree 1: the CBF row of stage k is dh + alpha h_k.
        Relative degree 2: ddh + (a1+a2) dh + a1 a2 h_k over h(x_k),
        h(x_{k+1}) and h(x2_k) with x2_k = step(x_{k+1}, u_k) (the same
        u_k, not x_{k+2}).  h of the rollout is shared between stages.
        """
        xs = rollout(U)
        x0_b = x0.expand(xs.shape[:-2] + (n,))[..., None, :]
        xs_full = torch.cat([x0_b, xs], dim=-2)  # (..., N+1, n)
        H = h_all(xs_full)  # (..., N+1, K)
        h_k, h_k1 = H[..., :N, :], H[..., 1:, :]
        if model.REL_DEG == 1:
            cbf = (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k
        else:
            x2 = model.step(xs_full[..., 1:, :], U, spec, dt)  # (..., N, n)
            H2 = h_all(x2)
            d_h = h_k1 - h_k
            dd_h = H2 - 2.0 * h_k1 + h_k
            cbf = dd_h + (a1 + a2) * d_h + a1 * a2 * h_k
        cons = [cbf.reshape(U.shape[:-2] + (N * cfg.num_obs,))]
        for i in bounded_idx:
            cons.append(ub_x[i] - xs[..., i])  # upper
            cons.append(xs[..., i] - lb_x[i])  # lower
        return torch.cat(cons, dim=-1)

    lb_flat = lb_u.repeat(N)
    ub_flat = ub_u.repeat(N)

    # Shift the previous solution by one stage; multipliers start cold.
    U0 = torch.cat([mpc_state.U[:, 1:], mpc_state.U[:, -1:]], dim=1)
    U0 = torch.clamp(U0, lb_u, ub_u)
    Uf = U0.reshape(B, D)
    lam = torch.zeros_like(mpc_state.lam)

    # Constraint rows scaled by their gradient norm at the warm start, so
    # that the AL tolerances are control-relevant.
    _, (Jc0,) = _jvp_jacobian(lambda u: (constraints(u.reshape(B, N, m)),), Uf)
    c_scale = 1.0 / torch.clamp_min(torch.linalg.vector_norm(Jc0, dim=1), 1e-2)

    def al_terms(U_flat, lam, rho):
        """Residual vector and AL activation act = max(0, lam - rho c)."""
        U = U_flat.reshape(U_flat.shape[:-1] + (N, m))
        r = residual(U)
        c = constraints(U) * c_scale
        return r, torch.clamp_min(lam - rho * c, 0.0)

    def al_grad_hess(U_flat, lam, rho):
        """grad = 2 Jr'r - Jc'act and H = 2 Jr'Jr + rho Jca'Jca."""

        def rc(Uf_):
            U_ = Uf_.reshape(B, N, m)
            return residual(U_), constraints(U_) * c_scale

        (r, c), (Jr, Jc) = _jvp_jacobian(rc, U_flat)  # Jr (B, D, n_r)
        act = torch.clamp_min(lam - rho * c, 0.0)
        grad = 2.0 * (Jr @ r[..., None])[..., 0] - (Jc @ act[..., None])[..., 0]
        active = (act > 0.0).to(dtype)
        Jca = Jc * active[:, None, :]
        H = 2.0 * (Jr @ Jr.transpose(1, 2)) + rho * (Jca @ Jca.transpose(1, 2))
        return grad, H, r, act

    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.03, 0.0], dtype=dtype, device=device)
    eye = torch.eye(D, dtype=dtype, device=device)
    noise_eps = 4.0 * torch.finfo(dtype).eps

    def newton_direction(Uf, grad, H):
        """Damped projected-Newton direction."""
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + cfg.reg * eye * (1.0 + tr / D)[:, None, None]
        # Freeze variables at an active box bound whose gradient points
        # outward; otherwise the clipped step bends into an ascent direction.
        eps_b = 1e-7
        at_lb = (Uf <= lb_flat + eps_b) & (grad > 0.0)
        at_ub = (Uf >= ub_flat - eps_b) & (grad < 0.0)
        free = torch.logical_not(at_lb | at_ub).to(dtype)
        Hf = free[:, :, None] * H * free[:, None, :] + torch.diag_embed(1.0 - free)
        gf = free * grad
        return -chol_solve(Hf, gf), Hf, gf

    def newton_step(Uf, lam, rho):
        grad, H, r0, act0 = al_grad_hess(Uf, lam, rho)
        step, Hf, gf = newton_direction(Uf, grad, H)
        # Line search on the difference of merits, cancellation-free:
        # L(a) - L(0) = (r_a - r_0).(r_a + r_0) + (act_a - act_0).(act_a + act_0) / (2 rho),
        # all six step lengths at once on a leading axis.
        cand = torch.clamp(Uf + alphas[:, None, None] * step, lb_flat, ub_flat)
        r_a, act_a = al_terms(cand, lam, rho)
        d_cost = ((r_a - r0) * (r_a + r0)).sum(-1)
        d_pen = ((act_a - act0) * (act_a + act0)).sum(-1) / (2.0 * rho)
        vals = d_cost + d_pen  # (6, B)
        vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, float("inf")))
        # Noise-aware acceptance: when the quadratic model's predicted
        # decrease is below the merit's rounding floor, the line search cannot
        # tell the candidates apart, so take the full damped Newton step.
        noise_floor = noise_eps * ((r0 * r0).sum(-1) + (act0 * act0).sum(-1) / (2.0 * rho))
        pred = (gf * step).sum(-1) + 0.5 * (step * (Hf @ step[..., None])[..., 0]).sum(-1)
        noise_phase = pred >= -noise_floor
        best = torch.where(noise_phase, torch.zeros_like(noise_phase, dtype=torch.long),
                           torch.argmin(vals, dim=0))
        return torch.clamp(Uf + alphas[best][:, None] * step, lb_flat, ub_flat)

    rho = torch.tensor(cfg.rho0, dtype=dtype, device=device)
    for _ in range(cfg.outer_iters):
        for _ in range(cfg.newton_iters):
            Uf = newton_step(Uf, lam, rho)
        c = constraints(Uf.reshape(B, N, m)) * c_scale
        lam = torch.clamp_min(lam - rho * c, 0.0)
        rho = torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max)

    U = Uf.reshape(B, N, m)
    # Violation in scaled (control-relevant) units.
    c = constraints(U) * c_scale
    viol = torch.clamp_min(-c.min(dim=-1).values, 0.0)
    xs = torch.cat([x0[:, None, :], rollout(U)], dim=1)
    return MPCResult(
        u=U[:, 0, :m],
        state=MPCState(U=U, lam=lam),
        xs=xs,
        feasible=viol <= cfg.viol_tol,
        viol=viol,
    )
