"""Optimal-decay CBF-QP: decay-rate relaxation for pointwise feasibility.

Port of ``safe_control_tpu/solvers/optimal_decay_cbf_qp.py``, batched.  The
CBF row's class-K gains are multiplied by decision variables omega1, omega2
softly pinned to 1 with penalty p_sb = 1e4, so the QP is always feasible:

    min ||u - u_ref||^2 + p_sb (w1-1)^2 + p_sb (w2-1)^2
    s.t. r=2:  A u + b_f + (a1+a2) hdot w1 + a1 a2 h w2 >= 0
         r=1:  A u + b_f + alpha h w1 >= 0   (w2 unused, pinned to 1)
         input box

Decision vector z = [u; w1; w2], solved by the general ``qp.solve_qp``.
One obstacle row (the nearest obstacle).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from safe_control_tpu_torch.barriers import hocbf
from safe_control_tpu_torch.core.types import is_dummy
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers.qp import solve_qp

ALPHA1 = 0.5
ALPHA2 = 0.5
ALPHA_R1 = 0.5
OMEGA_REF = 1.0
P_SB = 1.0e4


class ODCBFResult(NamedTuple):
    u: torch.Tensor  # (B, m)
    omega1: torch.Tensor  # (B,)
    omega2: torch.Tensor  # (B,)
    feasible: torch.Tensor  # (B,) bool


def solve(model_name: str, spec, x, u_ref, nearest_obs, dt, iters: int = 1600) -> ODCBFResult:
    """Optimal-decay CBF-QPs: ``x (B,n)``, ``u_ref (B,m)``, ``nearest_obs (B,7)``."""
    model = get_model(model_name)
    B, m = u_ref.shape
    dtype, device = x.dtype, x.device
    n_z = m + 2

    h, hdot, grad = hocbf.ct_terms(model, model_name, x, nearest_obs, spec)
    a_u = (grad[..., :, None] * model.g(x, spec)).sum(-2)
    b_f = (grad * model.f(x, spec)).sum(-1)
    if model.REL_DEG == 2:
        w_cols = [(ALPHA1 + ALPHA2) * hdot, ALPHA1 * ALPHA2 * h]
    else:
        w_cols = [ALPHA_R1 * h, torch.zeros_like(h)]
    row = torch.cat([a_u, torch.stack(w_cols, dim=-1)], dim=-1)

    # Inert row for a dummy (absent) obstacle.
    dummy = is_dummy(nearest_obs)
    row = torch.where(dummy[:, None], torch.zeros_like(row), row)
    b_f = torch.where(dummy, torch.ones_like(b_f), b_f)

    p_diag = torch.tensor([2.0] * m + [2.0 * P_SB, 2.0 * P_SB], dtype=dtype, device=device)
    P = torch.diag_embed(p_diag).expand(B, n_z, n_z)
    q_w = torch.full((B, 2), -2.0 * P_SB * OMEGA_REF, dtype=dtype, device=device)
    q = torch.cat([-2.0 * u_ref, q_w], dim=-1)
    eye = torch.eye(n_z, dtype=dtype, device=device).expand(B, n_z, n_z)
    A = torch.cat([row[:, None, :], eye], dim=1)
    inf = torch.full((B, 2), float("inf"), dtype=dtype, device=device)
    lb = model.u_lb(spec, device=device, dtype=dtype).expand(B, m)
    ub = model.u_ub(spec, device=device, dtype=dtype).expand(B, m)
    l = torch.cat([-b_f[:, None], lb, -inf], dim=-1)
    u_up = torch.cat([inf[:, :1], ub, inf], dim=-1)
    sol = solve_qp(P, q, A, l, u_up, iters=iters)
    return ODCBFResult(
        u=sol.x[:, :m], omega1=sol.x[:, m], omega2=sol.x[:, m + 1],
        feasible=sol.prim_res < 1e-3,
    )
