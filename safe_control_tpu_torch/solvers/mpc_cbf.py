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
noise-aware acceptance, and the multiplier update.  The variants of the
JAX package run too: ``optimal_decay`` (two decay multipliers a stage
appended to the decision, softly pinned to ``omega_ref``), ``newton_f64``
(the Gauss-Newton system and its solve in float64 inside a float32 solve)
and ``polish_iters`` (the terminal active-set KKT polish); ``MPCConfig.rti``
is the real-time-iteration budget.

The Newton systems and the polish's systems are solved by the pivot-clamped
Cholesky of ``solvers/chol.py``: the column loop up to a width of 40
(``UNROLL_CHOL_MAX``), and above it the same factor in D column steps with
D-step substitutions (``spd_solve``), so that a wide horizon (VTOL2D N=30,
D=120) costs a few thousand operations a solve instead of D^2/2 per half.
Every constant is a ``device_constant``, so that a step can be captured as
a CUDA graph.

``solve_batch`` routes the DynamicUnicycle2D N=8, K=5 configuration to the
fused kernel (``solvers/mpc_du_kernel.py``) when ``cfg.use_fused_kernel`` is
set and the inputs are float32, as the JAX package does.  ``solve_dispatch``
routes any configuration that ``mpc_fused.fused_available`` admits to the
generic fused kernel (``solvers/mpc_fused.py``), and logs every fallback.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.barriers.hocbf import dt_h as hocbf_dt_h
from safe_control_tpu_torch.barriers.hocbf import tensor_fields
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.dynamics.base import MODEL_REGISTRY
from safe_control_tpu_torch.core.types import device_constant
from safe_control_tpu_torch.solvers.chol import (
    chol_factor,
    chol_factor_steps,
    chol_solve_columns,
    chol_solve_factored,
)
from safe_control_tpu_torch.utils import profiling

# Widest system factored by the column loop of ``chol_factor`` (D^2/2 small
# steps); a wider one is factored by ``chol_factor_steps`` and substituted by
# ``chol_solve_columns``, 3 D steps.  The JAX package's ``_UNROLL_CHOL_MAX``
# likewise leaves its sequential order above 40.
UNROLL_CHOL_MAX = 40

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
    """The (Q, R) diagonals as shared device constants: do not write to them."""
    q, r = _WEIGHTS[model_name]
    return (
        device_constant(tuple(q), device=device, dtype=dtype),
        device_constant(tuple(r), device=device, dtype=dtype),
    )


def spd_factor(H: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of ``H (..., D, D)``: ``chol_factor`` up to
    ``UNROLL_CHOL_MAX``, ``chol_factor_steps`` (the same bits) above."""
    return chol_factor_steps(H) if H.shape[-1] > UNROLL_CHOL_MAX else chol_factor(H)


def spd_solve_factored(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``L L' x = g``: ``chol_solve_factored`` up to ``UNROLL_CHOL_MAX``;
    above it ``chol_solve_columns``, whose forward substitution keeps the
    bits and whose back substitution sums each entry in the reverse order
    (equal to rounding)."""
    if L.shape[-1] > UNROLL_CHOL_MAX:
        return chol_solve_columns(L, g)
    return chol_solve_factored(L, g)


def spd_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``H x = g`` for an SPD ``H``, by width as ``spd_factor`` and
    ``spd_solve_factored``; at D <= 40 it is ``chol_solve``."""
    return spd_solve_factored(spd_factor(H), g)


class MPCConfig(NamedTuple):
    """Solver configuration; the fields and defaults of the JAX package.

    ``optimal_decay`` appends two decay multipliers (omega1, omega2) to each
    stage's input, boxed to [0, 10] and pulled toward ``omega_ref`` by the
    residual rows sqrt(p_sb) (omega - omega_ref); the CBF row becomes
    dh + alpha w1 h (r=1) or ddh + (a1 w1 + a2 w2) dh + a1 a2 w1 w2 h (r=2).
    ``newton_f64`` forms grad and H and solves the Newton step in float64
    inside a float32 solve.  ``polish_iters`` runs that many terminal
    active-set KKT steps after the augmented-Lagrangian loop, each kept only
    if it is small and does not make the violation worse.
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
    polish_ctol: float = 1e-2  # scaled-units activity threshold of the polish
    newton_f64: bool = False
    use_fused_kernel: bool = False
    scan_unroll: int = 1
    loop_unroll: bool = False

    @classmethod
    def rti(cls, **kw) -> "MPCConfig":
        """The real-time-iteration budget for latency-bound single-robot
        control: 2 outer x 2 Newton iterations unless given, since a
        warm-started MPC moves little in one period."""
        kw.setdefault("outer_iters", 2)
        kw.setdefault("newton_iters", 2)
        return cls(**kw)


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


def decision_width(model, cfg: MPCConfig) -> int:
    """Entries of U a stage: the model's inputs, plus the two decay
    multipliers with ``optimal_decay``."""
    return model.N_CONTROLS + (2 if cfg.optimal_decay else 0)


def init_state(model_name: str, cfg: MPCConfig, batch: int, *, device=None,
               dtype=torch.float32) -> MPCState:
    """Zero warm start for ``batch`` problems (decay multipliers at
    ``omega_ref``)."""
    model = get_model(model_name)
    n_con = _num_constraints(model, cfg)
    U = torch.zeros((batch, cfg.horizon, decision_width(model, cfg)), device=device, dtype=dtype)
    if cfg.optimal_decay:
        U[..., model.N_CONTROLS:] = cfg.omega_ref
    return MPCState(U=U, lam=torch.zeros((batch, n_con), device=device, dtype=dtype))


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
profiling.counter(f"{__name__}._FUSED_FALLBACK_SEEN", lambda: len(_FUSED_FALLBACK_SEEN))


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
    ``u_prev (B, m)`` and ``mpc_state`` with ``U (B, N, m')`` (m' = m + 2
    with ``optimal_decay``) and ``lam (B, n_con)``.
    """
    model = get_model(model_name)
    N, n, m_ctrl = cfg.horizon, model.N_STATES, model.N_CONTROLS
    m = decision_width(model, cfg)
    B, D = x0.shape[0], N * m
    dtype, device = x0.dtype, x0.device
    Qd, Rd = mpc_weights(model_name, device=device, dtype=dtype)
    Qs, Rs = torch.sqrt(Qd), torch.sqrt(Rd)
    lb_u = model.u_lb(spec, device=device, dtype=dtype)
    ub_u = model.u_ub(spec, device=device, dtype=dtype)
    if cfg.optimal_decay:  # the omegas' box keeps them sane
        lb_u = torch.cat([lb_u, lb_u.new_zeros(lb_u.shape[:-1] + (2,))], dim=-1)
        ub_u = torch.cat([ub_u, ub_u.new_full(ub_u.shape[:-1] + (2,), 10.0)], dim=-1)
    lb_x, ub_x = model.state_bounds(spec, device=device, dtype=dtype)
    bounded_idx = tuple(int(i) for i in np.nonzero(_bounded_mask(model))[0])
    a1, a2 = spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2
    obs_b = obs[..., None, :, :]  # (B, 1, K, 7): broadcasts over the states axis
    sqrt_psb = math.sqrt(cfg.p_sb)

    # The closures below take U with any extra leading axes in front of the
    # batch axis (the line search evaluates all step lengths at once).
    def rollout(U):
        x = x0
        xs = []
        for k in range(N):
            x = model.step(x, U[..., k, :m_ctrl], spec, dt)
            xs.append(x)
        return torch.stack(xs, dim=-2)  # (..., B, N, n): x_1..x_N

    def residual(U):
        xs = rollout(U)
        state_res = (xs - goal[..., None, :]) * Qs
        up = u_prev.expand(U.shape[:-2] + (m_ctrl,))[..., None, :]
        du = torch.diff(torch.cat([up, U[..., :m_ctrl]], dim=-2), dim=-2)
        input_res = du * Rs
        lead = U.shape[:-2]
        parts = [state_res.reshape(lead + (N * n,)), input_res.reshape(lead + (N * m_ctrl,))]
        if cfg.optimal_decay:
            parts.append(((U[..., m_ctrl:] - cfg.omega_ref) * sqrt_psb).reshape(lead + (N * 2,)))
        return torch.cat(parts, dim=-1)

    def h_all(states):
        """Barrier values for a stack of states: (..., S, n) -> (..., S, K)."""
        return hocbf_dt_h(model, model_name, states[..., :, None, :], obs_b, spec)

    def constraints(U):
        """All inequality constraints c(U) >= 0, fixed shape.

        Relative degree 1: the CBF row of stage k is dh + alpha h_k.
        Relative degree 2: ddh + (a1+a2) dh + a1 a2 h_k over h(x_k),
        h(x_{k+1}) and h(x2_k) with x2_k = step(x_{k+1}, u_k) (the same
        u_k, not x_{k+2}).  h of the rollout is shared between stages.
        With optimal decay the gains carry the stage's omegas.
        """
        xs = rollout(U)
        x0_b = x0.expand(xs.shape[:-2] + (n,))[..., None, :]
        xs_full = torch.cat([x0_b, xs], dim=-2)  # (..., N+1, n)
        H = h_all(xs_full)  # (..., N+1, K)
        h_k, h_k1 = H[..., :N, :], H[..., 1:, :]
        if model.REL_DEG == 1:
            if cfg.optimal_decay:
                cbf = (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k * U[..., m_ctrl, None]
            else:
                cbf = (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k
        else:
            x2 = model.step(xs_full[..., 1:, :], U[..., :m_ctrl], spec, dt)  # (..., N, n)
            H2 = h_all(x2)
            d_h = h_k1 - h_k
            dd_h = H2 - 2.0 * h_k1 + h_k
            if cfg.optimal_decay:
                w1, w2 = U[..., m_ctrl, None], U[..., m_ctrl + 1, None]
                cbf = dd_h + (a1 * w1 + a2 * w2) * d_h + (a1 * a2 * w1 * w2) * h_k
            else:
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

    def rc(Uf_):
        U_ = Uf_.reshape(B, N, m)
        return residual(U_), constraints(U_) * c_scale

    def al_terms(U_flat, lam, rho):
        """Residual vector and AL activation act = max(0, lam - rho c)."""
        U = U_flat.reshape(U_flat.shape[:-1] + (N, m))
        r = residual(U)
        c = constraints(U) * c_scale
        return r, torch.clamp_min(lam - rho * c, 0.0)

    use_f64 = cfg.newton_f64 and dtype == torch.float32
    hdtype = torch.float64 if use_f64 else dtype

    def al_grad_hess(U_flat, lam, rho):
        """grad = 2 Jr'r - Jc'act and H = 2 Jr'Jr + rho Jca'Jca, formed in
        float64 with ``newton_f64`` on a float32 solve."""
        (r, c), (Jr, Jc) = _jvp_jacobian(rc, U_flat)  # Jr (B, D, n_r)
        act = torch.clamp_min(lam - rho * c, 0.0)
        Jr_h, Jc_h, r_h, act_h = (t.to(hdtype) for t in (Jr, Jc, r, act))
        grad = 2.0 * (Jr_h @ r_h[..., None])[..., 0] - (Jc_h @ act_h[..., None])[..., 0]
        Jca = Jc_h * (act_h > 0.0).to(hdtype)[:, None, :]
        H = 2.0 * (Jr_h @ Jr_h.transpose(1, 2)) + rho.to(hdtype) * (Jca @ Jca.transpose(1, 2))
        return grad, H, r, act

    alphas = device_constant((1.0, 0.5, 0.25, 0.1, 0.03, 0.0), dtype=dtype, device=device)
    noise_eps = 4.0 * torch.finfo(dtype).eps

    def free_set(Uf, grad):
        """Variables not frozen at an active box bound whose gradient points
        outward (otherwise the clipped step bends into an ascent direction)."""
        eps_b = 1e-7
        at_lb = (Uf <= lb_flat + eps_b) & (grad > 0.0)
        at_ub = (Uf >= ub_flat - eps_b) & (grad < 0.0)
        return torch.logical_not(at_lb | at_ub).to(grad.dtype)

    def damped(H):
        """H + reg (1 + tr(H) / D) I."""
        eye = torch.eye(D, dtype=H.dtype, device=device)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        return H + cfg.reg * eye * (1.0 + tr / D)[:, None, None]

    def newton_direction(Uf, grad, H):
        """Damped projected-Newton direction, at H's precision."""
        H = damped(H)
        free = free_set(Uf.to(H.dtype), grad)
        Hf = free[:, :, None] * H * free[:, None, :] + torch.diag_embed(1.0 - free)
        gf = free * grad
        return (-spd_solve(Hf, gf)).to(dtype), Hf.to(dtype), gf.to(dtype)

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

    rho = torch.full((), cfg.rho0, dtype=dtype, device=device)
    for _ in range(cfg.outer_iters):
        for _ in range(cfg.newton_iters):
            Uf = newton_step(Uf, lam, rho)
        c = constraints(Uf.reshape(B, N, m)) * c_scale
        lam = torch.clamp_min(lam - rho * c, 0.0)
        rho = torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max)

    def polish_once(Uf, lam):
        """One terminal active-set KKT step.

        The AL multipliers estimate the active set; an equality-constrained
        Gauss-Newton step on it (the Schur complement S = C' H^-1 C on the
        free variables) pushes the active rows to their boundary.  Three
        working-set refinements drop the rows whose multiplier comes out
        negative.  The step is kept only if max |dU| < 0.2 and the scaled
        violation does not grow past max(1.5 viol0, 2e-3).
        """
        (r, c), (Jr, Jc) = _jvp_jacobian(rc, Uf)  # Jr (B, D, n_r), Jc (B, D, n_c)
        g = 2.0 * (Jr @ r[..., None])[..., 0]
        grad_al = g - (Jc @ lam[..., None])[..., 0]
        free = free_set(Uf, grad_al)
        H = damped(2.0 * (Jr @ Jr.transpose(1, 2)))
        Hf = free[:, :, None] * H * free[:, None, :] + torch.diag_embed(1.0 - free)
        Cfree = free[:, :, None] * Jc  # (B, D, n_c)
        L = spd_factor(Hf)
        gfree = free * g
        Hg = spd_solve_factored(L, gfree)
        Y = spd_solve_factored(L[:, None], Cfree.transpose(1, 2))  # (B, n_c, D): H^-1 C
        S0 = Cfree.transpose(1, 2) @ Y.transpose(1, 2)
        q0 = (Cfree.transpose(1, 2) @ Hg[..., None])[..., 0] - c
        n_c = S0.shape[-1]
        eyec = torch.eye(n_c, dtype=dtype, device=device)

        def solve_mu(a):
            S = a[:, :, None] * S0 * a[:, None, :] + torch.diag_embed(1.0 - a)
            tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
            S = S + 1e-7 * tr[:, None, None] / n_c * eyec
            return spd_solve(S, a * q0)

        a = ((lam > 0.0) | (c < cfg.polish_ctol)).to(dtype)
        for _ in range(3):
            a = a * (solve_mu(a) > 0.0).to(dtype)
        mu = torch.clamp_min(solve_mu(a), 0.0) * a
        dU = spd_solve_factored(L, (Cfree @ mu[..., None])[..., 0] - gfree) * free
        cand = torch.clamp(Uf + dU, lb_flat, ub_flat)
        c_new = constraints(cand.reshape(B, N, m)) * c_scale
        viol0 = torch.clamp_min(-c.min(dim=-1).values, 0.0)
        viol1 = torch.clamp_min(-c_new.min(dim=-1).values, 0.0)
        ok = (dU.abs().amax(-1) < 0.2) & (viol1 <= torch.clamp_min(1.5 * viol0, 2e-3))
        return (torch.where(ok[:, None], cand, Uf),
                torch.where(ok[:, None], torch.clamp_min(mu, 0.0), lam))

    for _ in range(cfg.polish_iters):
        Uf, lam = polish_once(Uf, lam)

    U = Uf.reshape(B, N, m)
    # Violation in scaled (control-relevant) units.
    c = constraints(U) * c_scale
    viol = torch.clamp_min(-c.min(dim=-1).values, 0.0)
    xs = torch.cat([x0[:, None, :], rollout(U)], dim=1)
    return MPCResult(
        u=U[:, 0, :m_ctrl],
        state=MPCState(U=U, lam=lam),
        xs=xs,
        feasible=viol <= cfg.viol_tol,
        viol=viol,
    )
