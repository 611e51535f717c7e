"""MPCC: model-predictive contouring control for the drift car.

Port of ``safe_control_tpu/solvers/mpcc.py``, batched over a leading axis
B.  The augmented 9-state model [x, y, theta, r, beta, V, delta, tau, psi]
takes the path-progress input v_psi; the stage costs are the contouring,
lag, heading, velocity and yaw-rate errors against path references sampled
at psi_k = psi_now + k v_psi_ref dt, plus the input moves; the body states'
bounds are constraints.  The path is an arc-length polyline with linear
interpolation, and the closest-point search is global on the first call and
windowed after it, so that it cannot jump across a fold of the track.  The
solve is the shared augmented-Lagrangian Gauss-Newton engine
(``solvers/al_gn.py``) at the JAX package's fixed budget; the full predicted
states and inputs are returned for the gatekeeper.

The path and the configuration's constants live on the device, and
``solve`` reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.core.types import angle_normalize, device_constant
from safe_control_tpu_torch.dynamics import dynamic_bicycle2d as dyn
from safe_control_tpu_torch.solvers import al_gn
from safe_control_tpu_torch.solvers.mpc_cbf import _jvp_jacobian

N_CONTROLS = 3  # [delta_dot, tau_dot, v_psi]


@dataclasses.dataclass(frozen=True)
class MPCCConfig:
    """The JAX package's fields and defaults.  ``scan_unroll`` is an XLA
    dispatch lever; it is accepted and has no effect here."""

    horizon: int = 30
    q_c: float = 100.0
    q_l: float = 5.0
    q_theta: float = 30.0
    q_v: float = 20.0
    q_r: float = 10.0
    v_ref: float = 5.0
    r_delta_dot: float = 50.0
    r_tau_dot: float = 0.01
    r_v_psi: float = 0.1
    v_psi_ref: float = 2.0
    v_psi_min: float = 0.1
    v_psi_max: float = 15.0
    search_window: float = 40.0
    search_back: float = 10.0
    al: al_gn.ALGNConfig = al_gn.ALGNConfig()
    scan_unroll: int = 1


class Path(NamedTuple):
    """Arc-length parametrized polyline, each field ``(P,)``."""

    s: torch.Tensor  # cumulative arc length
    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor


def make_path(path_x, path_y, path_theta=None, *, device=None, dtype=torch.float32) -> Path:
    """A :class:`Path` through the points; the arc length and the headings
    (of each segment, the last repeated) are formed in float64."""
    px = np.asarray(path_x, dtype=np.float32).astype(np.float64)
    py = np.asarray(path_y, dtype=np.float32).astype(np.float64)
    dx, dy = np.diff(px), np.diff(py)
    s = np.concatenate([[0.0], np.cumsum(np.sqrt(dx * dx + dy * dy))])
    if path_theta is None:
        th = np.arctan2(dy, dx)
        path_theta = np.concatenate([th, th[-1:]])
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return Path(s=as_t(s), x=as_t(px), y=as_t(py), theta=as_t(path_theta))


def _interp(v, xp, fp):
    """``jnp.interp(v, xp, fp)`` for ``v`` inside [xp[0], xp[-1]], with the
    same formula: fp[i-1] + ((v - xp[i-1]) / dx) df, fp[i-1] where
    |dx| <= spacing(eps)."""
    i = torch.clamp(torch.searchsorted(xp, v.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = f0 + ((v - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0)
    return torch.where(dx0, f0, f)


def path_reference(path: Path, psi):
    """Interpolated (x_ref, y_ref, theta_ref) at arc length ``psi`` (any
    shape); the heading through its sine and cosine, without wrap jumps."""
    psi = torch.minimum(torch.maximum(psi, path.s[0]), path.s[-1])
    xr = _interp(psi, path.s, path.x)
    yr = _interp(psi, path.s, path.y)
    cr = _interp(psi, path.s, torch.cos(path.theta))
    sr = _interp(psi, path.s, torch.sin(path.theta))
    return xr, yr, torch.atan2(sr, cr)


def closest_path_psi(path: Path, pos, psi_now, cfg: MPCCConfig, global_search=False):
    """Arc length of the path point closest to ``pos (B, 2)``: among the
    points with s in [psi_now - back, psi_now + window] only, unless
    ``global_search`` (a bool or ``(B,)``) or no point lies in the window."""
    dx = path.x - pos[:, 0, None]
    dy = path.y - pos[:, 1, None]
    d2 = dx * dx + dy * dy  # (B, P)
    psi_now = psi_now[:, None]
    in_win = (path.s >= psi_now - cfg.search_back) & (path.s <= psi_now + cfg.search_window)
    use_global = ~torch.any(in_win, dim=-1)
    if isinstance(global_search, torch.Tensor):
        use_global = use_global | global_search
    elif global_search:
        use_global = torch.ones_like(use_global)
    score = torch.where(use_global[:, None] | in_win, d2, torch.full_like(d2, math.inf))
    return path.s[torch.argmin(score, dim=-1)]


class MPCCState(NamedTuple):
    U: torch.Tensor  # (B, N, 3) warm start
    psi: torch.Tensor  # (B,) path progress
    initialized: torch.Tensor  # (B,) bool


class MPCCResult(NamedTuple):
    u: torch.Tensor  # (B, 2) [delta_dot, tau_dot] applied to the car
    state: MPCCState
    xs: torch.Tensor  # (B, N+1, 9) predicted augmented states
    us: torch.Tensor  # (B, N, 3) predicted inputs
    viol: torch.Tensor  # (B,)


def init_state(cfg: MPCCConfig, batch: int = 1, *, device=None,
               dtype=torch.float32) -> MPCCState:
    """Zero warm start with v_psi at its reference; not yet initialized."""
    U = torch.zeros((batch, cfg.horizon, N_CONTROLS), dtype=dtype, device=device)
    U[..., 2] = cfg.v_psi_ref
    return MPCCState(U=U, psi=torch.zeros((batch,), dtype=dtype, device=device),
                     initialized=torch.zeros((batch,), dtype=torch.bool, device=device))


def _aug_step(x9, u3, spec, dt):
    """Unclamped augmented dynamics: the body's raw Euler x + (f + g u) dt
    (its bounds are constraints, not clamps; g u reaches delta and tau
    only), the pose's kinematic coupling, psi' = v_psi."""
    r, beta, V = x9[..., 3], x9[..., 4], x9[..., 5]
    r_dot, beta_dot, V_dot = dyn._rates(x9[..., 3:8], spec)
    heading = x9[..., 2] + beta
    return torch.stack([
        x9[..., 0] + V * torch.cos(heading) * dt,
        x9[..., 1] + V * torch.sin(heading) * dt,
        x9[..., 2] + r * dt,
        r + r_dot * dt,
        beta + beta_dot * dt,
        V + V_dot * dt,
        x9[..., 6] + u3[..., 0] * dt,
        x9[..., 7] + u3[..., 1] * dt,
        x9[..., 8] + u3[..., 2] * dt,
    ], dim=-1)


def solve(spec, x8, path: Path, mpcc_state: MPCCState, u_prev, dt: float,
          cfg: MPCCConfig = MPCCConfig()) -> MPCCResult:
    """One MPCC solve for each of B cars: ``x8 (B, 8)`` DriftingCar states,
    ``u_prev (B, 2)`` the last applied [delta_dot, tau_dot]."""
    N = cfg.horizon
    B = x8.shape[0]
    dtype, dev = x8.dtype, x8.device
    const = lambda v: device_constant(v, dtype=dtype, device=dev)

    psi0 = closest_path_psi(path, x8[:, :2], mpcc_state.psi, cfg,
                            global_search=~mpcc_state.initialized)
    steps = torch.arange(N + 1, dtype=dtype, device=dev) * cfg.v_psi_ref * dt
    xr, yr, thr = path_reference(path, psi0[:, None] + steps)  # (B, N+1)
    xr, yr, thr = xr[:, 1:], yr[:, 1:], thr[:, 1:]
    s_th, c_th = torch.sin(thr), torch.cos(thr)
    x0 = torch.cat([x8, psi0[:, None]], dim=-1)

    def rollout(U):  # U (..., B, N, 3) -> x_1..x_N (..., B, N, 9)
        x = x0.expand(U.shape[:-2] + (9,))
        xs = []
        for k in range(N):
            x = _aug_step(x, U[..., k, :], spec, dt)
            xs.append(x)
        return torch.stack(xs, dim=-2)

    sq = math.sqrt
    sqRw = torch.sqrt(const((cfg.r_delta_dot, cfg.r_tau_dot, cfg.r_v_psi)))
    uprev3 = torch.cat([u_prev, torch.full_like(u_prev[:, :1], cfg.v_psi_ref)], dim=-1)

    lbs = const((-spec.r_max, -spec.beta_max, spec.v_min, -spec.delta_max, -spec.tau_max))
    ubs = const((spec.r_max, spec.beta_max, spec.v_max, spec.delta_max, spec.tau_max))

    sq_r = [sq(cfg.q_c), sq(cfg.q_l), sq(cfg.q_theta), sq(cfg.q_v), sq(cfg.q_r)]

    def rows(U, xs):
        """The residual rows and the state-bound rows of inputs ``U`` and
        their rollout ``xs`` (x_1..x_N)."""
        lead = U.shape[:-2]
        dx = xs[..., 0] - xr
        dy = xs[..., 1] - yr
        e_c = s_th * dx - c_th * dy
        e_l = -c_th * dx - s_th * dy
        e_th = angle_normalize(xs[..., 2] - thr)
        e_v = xs[..., 5] - cfg.v_ref
        prev = torch.cat([uprev3.expand(lead[:-1] + uprev3.shape)[..., None, :], U[..., :-1, :]],
                         dim=-2)
        r = torch.cat([
            sq_r[0] * e_c, sq_r[1] * e_l, sq_r[2] * e_th, sq_r[3] * e_v, sq_r[4] * xs[..., 3],
            ((U - prev) * sqRw).reshape(lead + (N * N_CONTROLS,)),
        ], dim=-1)
        body = xs[..., 3:8]
        c = torch.cat([(ubs - body).reshape(lead + (N * 5,)),
                       (body - lbs).reshape(lead + (N * 5,))], dim=-1)
        return r, c

    def residual_constraints(Uf):
        """(r, c, rollout) at ``Uf (..., B, D)``."""
        U = Uf.reshape(Uf.shape[:-1] + (N, N_CONTROLS))
        xs = rollout(U)
        return (*rows(U, xs), xs)

    # d(U_k - U_{k-1}) sqrt(R) / dU, a constant (D, D): row d, column (k, j).
    D = N * N_CONTROLS
    eye = torch.eye(D, dtype=dtype, device=dev)
    du_jac = (eye - torch.roll(eye, N_CONTROLS, dims=1) * (torch.arange(D, device=dev)
                                                           >= N_CONTROLS)) * sqRw.repeat(N)

    def stage(z):  # z (S, 9 + 3): a state and the stage's input
        return (_aug_step(z[:, :9], z[:, 9:], spec, dt),)

    def jacobian(Uf, xs=None):
        """The rows and their forward-mode Jacobians: the rollout, every
        stage's (A_k, B_k) = d x_{k+1} / d(x_k, u_k) in one batched
        ``vmap(jvp)`` over the 12 unit tangents, the sensitivities
        S_{k+1} = A_k S_k (with B_k in the columns of u_k), then each row's
        tangent from S as the rows' own operations make it.  ``xs``: the
        rollout at ``Uf`` when the line search has made it."""
        U = Uf.reshape(B, N, N_CONTROLS)
        if xs is None:
            xs = rollout(U)
        x_prev = torch.cat([x0[:, None], xs[:, :-1]], dim=1)
        z = torch.cat([x_prev, U], dim=-1).reshape(B * N, 9 + N_CONTROLS)
        _, (J,) = _jvp_jacobian(stage, z)  # (B N, 12, 9): row d = d x_{k+1} / d z_d
        J = J.transpose(1, 2).reshape(B, N, 9, 9 + N_CONTROLS)
        A, Bk = J[..., :9], J[..., 9:]
        S = Uf.new_zeros((B, 9, D))
        Ss = []
        for k in range(N):
            S = torch.matmul(A[:, k], S) if k else S
            S = torch.cat([S[..., :N_CONTROLS * k], Bk[:, k],
                           S[..., N_CONTROLS * (k + 1):]], dim=-1)
            Ss.append(S)
        S = torch.stack(Ss, dim=1)  # (B, N, 9, D): d x_{k+1} / dU
        s_, c_ = s_th[..., None], c_th[..., None]
        J_r = torch.cat([
            sq_r[0] * (s_ * S[:, :, 0] - c_ * S[:, :, 1]),
            sq_r[1] * (-c_ * S[:, :, 0] - s_ * S[:, :, 1]),
            sq_r[2] * S[:, :, 2], sq_r[3] * S[:, :, 5], sq_r[4] * S[:, :, 3],
            du_jac.T.expand(B, D, D),
        ], dim=1)  # (B, rows, D)
        body = S[:, :, 3:8].reshape(B, N * 5, D)
        J_c = torch.cat([-body, body], dim=1)
        return rows(U, xs), (J_r.transpose(1, 2), J_c.transpose(1, 2))

    lb_u = const((-spec.delta_dot_max, -spec.tau_dot_max, cfg.v_psi_min) * N)
    ub_u = const((spec.delta_dot_max, spec.tau_dot_max, cfg.v_psi_max) * N)

    U0 = torch.cat([mpcc_state.U[:, 1:], mpcc_state.U[:, -1:]], dim=1)
    Uf, c = al_gn.solve(lambda u: residual_constraints(u)[0],
                        lambda u: residual_constraints(u)[1], U0.reshape(B, N * N_CONTROLS),
                        lb_u, ub_u, cfg.al, joint=residual_constraints, jacobian=jacobian)
    U = Uf.reshape(B, N, N_CONTROLS)
    xs = torch.cat([x0[:, None], rollout(U)], dim=1)
    viol = torch.clamp_min(-c.min(dim=-1).values, 0.0)
    return MPCCResult(
        u=U[:, 0, :2],
        state=MPCCState(U=U, psi=psi0, initialized=torch.ones_like(mpcc_state.initialized)),
        xs=xs,
        us=U,
        viol=viol,
    )
