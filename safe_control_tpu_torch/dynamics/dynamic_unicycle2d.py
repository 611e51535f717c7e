"""DynamicUnicycle2D: X=[x, y, theta, v], U=[a, omega], relative degree 2.

Port of ``safe_control_tpu/dynamics/dynamic_unicycle2d.py``, batched over
any leading axes: ``x`` is ``(..., 4)`` and ``u`` is ``(..., 2)``.
"""

from __future__ import annotations

import math

import torch

from safe_control_tpu_torch.dynamics.base import angle_normalize, masked_apply, spec_vector

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def f(x, spec):
    zero = torch.zeros_like(x[..., 0])
    return torch.stack(
        [x[..., 3] * torch.cos(x[..., 2]), x[..., 3] * torch.sin(x[..., 2]), zero, zero],
        dim=-1,
    )


def g(x, spec):
    gm = torch.tensor(
        [[0.0, 0.0], [0.0, 0.0], [0.0, 1.0], [1.0, 0.0]], dtype=x.dtype, device=x.device
    )
    return gm.expand(x.shape[:-1] + (N_STATES, N_CONTROLS))


def step(x, u, spec, dt):
    # g @ u as an elementwise product and sum: g holds exact zeros and ones,
    # so this is exact and never reaches a (possibly TF32) matmul.
    gu = (g(x, spec) * u[..., None, :]).sum(-1)
    x = x + (f(x, spec) + gu) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(x, goal, spec, d_min=0.05):
    k_omega = spec.nominal_k_omega
    k_a = spec.nominal_k_a
    k_v = spec.nominal_k_v
    distance = torch.clamp_min(
        torch.linalg.vector_norm(x[..., :2] - goal[..., :2], dim=-1) - d_min, 0.0
    )
    theta_d = torch.atan2(goal[..., 1] - x[..., 1], goal[..., 0] - x[..., 0])
    err = angle_normalize(theta_d - x[..., 2])
    omega = k_omega * err
    v = torch.where(
        torch.abs(err) > math.radians(90.0),
        torch.zeros_like(err),
        torch.clamp_max(k_v * distance * torch.cos(err), spec.v_max),
    )
    accel = k_a * (v - x[..., 3])
    return torch.stack([accel, omega], dim=-1)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.a_max, -spec.w_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.a_max, spec.w_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    # v is bounded in the MPC.
    return (
        torch.tensor([-inf, -inf, -inf, -spec.v_max], device=device, dtype=dtype),
        torch.tensor([inf, inf, inf, spec.v_max], device=device, dtype=dtype),
    )


def barrier_pos(x):
    return x[..., :2]
