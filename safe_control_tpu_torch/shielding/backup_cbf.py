"""BackupCBF: the backup-policy CBF-QP with exact sensitivity propagation.

Port of ``safe_control_tpu/shielding/backup_cbf.py``, batched over a leading
robot axis B.  The backup policy is rolled out for N steps; the closed-loop
step's Jacobian at each step comes from one ``vmap(jvp)`` and chains the
sensitivities S_k = d phi_k / d x0.  QP rows, for each backup step i:

    grad_h(phi_i)' S_i g(x0) u >= -grad_h' S_i f(x0) + grad_h' f_pi_i
                                   - dh/dt - alpha h(phi_i)

(a moving obstacle's dh/dt by a one-dt difference in t, the backup drift
f_pi by trajectory differencing), plus the terminal invariant-set row
without the drift term; rows with a vanishing left side are inert.  Inputs
are scaled by the actuator limits with the weights Q_u, and the QP is the
general ``qp.solve_qp`` at ``qp_iters`` (as in the JAX package, which does
not send this QP to its kernel).  The fallback ladder: QP failed and safe
-> the reference input, QP failed and unsafe -> the raw backup.

``h_safety(x, t)`` and ``h_terminal(x)`` are caller-supplied functions of
states ``(..., n)`` (and times broadcasting against them); their gradients
come from ``torch.func.grad``.  Nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from safe_control_tpu_torch.core.types import device_constant
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers.mpc_cbf import _jvp_jacobian
from safe_control_tpu_torch.solvers.qp import solve_qp


@dataclasses.dataclass(frozen=True)
class BackupCBFConfig:
    model_name: str
    dt: float = 0.05
    backup_steps: int = 40
    alpha: float = 1.0
    alpha_terminal: float = 2.0
    intervention_tol: float = 0.1
    qp_iters: int = 800


class BackupCBFResult(NamedTuple):
    u: torch.Tensor  # (B, m)
    using_backup: torch.Tensor  # (B,) bool
    h_min: torch.Tensor  # (B,) min safety / terminal h along the backup rollout
    qp_ok: torch.Tensor  # (B,) bool
    phi: torch.Tensor  # (B, N, n) backup rollout


def _q_u(model_name: str, m: int) -> list:
    # DriftingCar weighs the torque rate by 10; other models all ones.
    if model_name == "DriftingCar":
        return [1.0, 10.0]
    return [1.0] * m


def _vecmat(v, M):
    """``v (..., n) @ M (..., n, k)`` as an elementwise product and sum."""
    return (v[..., :, None] * M).sum(-2)


def _grad(h, X, *args):
    """dh/dx at each state of ``X (..., n)``: the gradient of the sum of the
    values, each of which depends on its own state only."""
    return torch.func.grad(lambda Z: h(Z, *args).sum())(X)


def solve(cfg: BackupCBFConfig, spec, x0, u_ref, backup_policy: Callable, h_safety: Callable,
          h_terminal: Callable, has_moving_obstacles: bool = True) -> BackupCBFResult:
    """The backup CBF-QP for B robots at ``x0 (B, n)`` with reference
    inputs ``u_ref (B, m)``."""
    model = get_model(cfg.model_name)
    n, m = model.N_STATES, model.N_CONTROLS
    dt, N = cfg.dt, cfg.backup_steps
    B = x0.shape[0]
    dtype, dev = x0.dtype, x0.device

    def closed_loop(x):
        return model.step(x, backup_policy(x), spec, dt)

    # Backup rollout with exact sensitivities S_k = A_k ... A_1; each A_k
    # from one vmap(jvp) over the n unit tangents.
    x = x0
    S = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    phis, Ss = [x0], [S]
    for _ in range(N - 1):
        (x,), (At,) = _jvp_jacobian(lambda z: (closed_loop(z),), x)  # At[b, d, i] = A[b, i, d]
        A = At.transpose(1, 2)
        S = (A[..., :, :, None] * S[..., None, :, :]).sum(-2)
        phis.append(x)
        Ss.append(S)
    phi = torch.stack(phis, dim=1)  # (B, N, n)
    S = torch.stack(Ss, dim=1)  # (B, N, n, n)

    ts = torch.arange(N, dtype=dtype, device=dev) * dt
    h_vals = h_safety(phi, ts)  # (B, N)
    h_term = h_terminal(phi[:, -1])
    h_min = torch.minimum(h_vals.amin(-1), h_term)

    f0 = model.f(x0, spec)  # (B, n)
    g0 = model.g(x0, spec)  # (B, n, m)

    # Safety rows i = 1..N-1: f_pi by forward differences, backward at the end.
    f_pi = torch.cat([(phi[:, 2:] - phi[:, 1:-1]) / dt, ((phi[:, -1] - phi[:, -2]) / dt)[:, None]],
                     dim=1)  # (B, N-1, n)
    x_i, S_i, t_i = phi[:, 1:], S[:, 1:], ts[1:]
    h_val = h_vals[:, 1:]
    grad_h = _grad(h_safety, x_i, t_i)  # (B, N-1, n)
    if has_moving_obstacles:
        dh_dt = (h_safety(x_i, t_i + dt) - h_val) / dt
    else:
        dh_dt = torch.zeros_like(h_val)
    gS = _vecmat(grad_h, S_i)  # (B, N-1, n)
    lhs = _vecmat(gS, g0[:, None])
    rhs = (-(gS * f0[:, None]).sum(-1) + (grad_h * f_pi).sum(-1)) - dh_dt - cfg.alpha * h_val

    # Terminal row.
    grad_ht = _grad(h_terminal, phi[:, -1])
    gSt = _vecmat(grad_ht, S[:, -1])
    lhs_t = _vecmat(gSt, g0)
    rhs_t = -((gSt * f0).sum(-1) + cfg.alpha_terminal * h_term)

    G = torch.cat([lhs, lhs_t[:, None]], dim=1)  # (B, N, m)
    h_b = torch.cat([rhs, rhs_t[:, None]], dim=1)
    tiny = torch.linalg.vector_norm(G, dim=-1) <= 1e-6  # inert rows: 0 u >= -1
    G = torch.where(tiny[..., None], torch.zeros_like(G), G)
    h_b = torch.where(tiny, torch.full_like(h_b, -1.0), h_b)

    # Input-scaled QP (symmetric limits).
    u_scale = device_constant(model.u_ub(spec, device="cpu", dtype=torch.float64).tolist(),
                              dtype=dtype, device=dev)
    u_ref_c = torch.minimum(torch.maximum(u_ref, -u_scale), u_scale)
    Qu = device_constant(_q_u(cfg.model_name, m), dtype=dtype, device=dev)
    w = Qu / u_scale
    P = torch.diag_embed(2.0 * (w * w)).expand(B, m, m)
    q = -2.0 * (w * w) * u_ref_c
    A = torch.cat([G, torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)], dim=1)
    lo = torch.cat([h_b, (-u_scale).expand(B, m)], dim=1)
    hi = torch.cat([torch.full((B, N), float("inf"), dtype=dtype, device=dev),
                    u_scale.expand(B, m)], dim=1)
    sol = solve_qp(P, q, A, lo, hi, iters=cfg.qp_iters)
    qp_ok = sol.prim_res < 1e-3

    diff_scaled = Qu * (sol.x - u_ref_c) / u_scale
    intervened = torch.linalg.vector_norm(diff_scaled, dim=-1) > cfg.intervention_tol

    u_backup = backup_policy(x0)
    safe_now = h_min > 0.01
    u_out = torch.where(qp_ok[:, None], sol.x,
                        torch.where(safe_now[:, None], u_ref_c, u_backup))
    using_backup = torch.where(qp_ok, intervened, ~safe_now)
    return BackupCBFResult(u=u_out, using_backup=using_backup, h_min=h_min, qp_ok=qp_ok,
                           phi=phi)
