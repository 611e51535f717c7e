"""KinematicBicycle2D: X=[x, y, theta, v], U=[a, beta_slip], relative degree 2.

Port of ``safe_control_tpu/dynamics/kinematic_bicycle2d.py``, batched over
any leading axes: ``x`` is ``(..., 4)`` and ``u`` is ``(..., 2)``.
``step`` writes ``x + (f + g u) dt`` component by component, the division
by the rear axle distance as a product with its reciprocal, so that the
fused kernel's model (``csrc/mpc_fused_models.h``) repeats every rounding.

The speed clip of ``step`` is ``minimum(maximum(v, v_min), v_max)`` against
tensors, not ``torch.clamp``: its derivative at a tie (v exactly at a
bound, as a robot cruising at v_max with a = 0 is) is 0.5, as that of the
JAX package's ``jnp.clip``; ``torch.clamp``'s is 1.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.core.types import norm2
from safe_control_tpu_torch.dynamics.base import angle_normalize, spec_vector

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def _like(v, c):
    """``c`` (a float, or a tensor field of a batched spec) as a tensor of
    ``v``'s type; a float is filled on the device, not copied there."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=v.dtype, device=v.device)
    return torch.full((), c, dtype=v.dtype, device=v.device)


def clip_tie(v, lo, hi):
    """``jnp.clip(v, lo, hi)`` with its derivative: 0.5 at a tie with a bound."""
    return torch.minimum(torch.maximum(v, _like(v, lo)), _like(v, hi))


def max_tie(v, c):
    """``jnp.maximum(v, c)`` with its derivative: 0.5 at a tie."""
    return torch.maximum(v, _like(v, c))


def beta_from_delta(delta, spec):
    """Slip angle from steering angle."""
    return torch.atan((spec.rear_ax_dist / spec.wheel_base) * torch.tan(delta))


def delta_from_beta(beta, spec):
    """Steering angle from slip angle."""
    return torch.atan((spec.wheel_base / spec.rear_ax_dist) * torch.tan(beta))


def f(x, spec):
    theta, v = x[..., 2], x[..., 3]
    zero = torch.zeros_like(v)
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta), zero, zero], dim=-1)


def g(x, spec):
    theta, v = x[..., 2], x[..., 3]
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    return torch.stack([
        torch.stack([zero, -v * torch.sin(theta)], -1),
        torch.stack([zero, v * torch.cos(theta)], -1),
        torch.stack([zero, v * (1.0 / spec.rear_ax_dist)], -1),
        torch.stack([one, zero], -1),
    ], dim=-2)


def step(x, u, spec, dt):
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    theta, v = x[..., 2], x[..., 3]
    a, beta = u[..., 0], u[..., 1]
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([
        x[..., 0] + (v * c + (-v * s) * beta) * dt,
        x[..., 1] + (v * s + (v * c) * beta) * dt,
        angle_normalize(theta + ((v * (1.0 / spec.rear_ax_dist)) * beta) * dt),
        clip_tie(v + a * dt, spec.v_min, spec.v_max),
    ], dim=-1)


def nominal_input(x, goal, spec, d_min=0.05, k_theta=0.5, k_a=1.5, k_v=0.5):
    distance = torch.clamp_min(norm2(x[..., :2] - goal[..., :2]) - d_min, 0.05)
    theta_d = torch.atan2(goal[..., 1] - x[..., 1], goal[..., 0] - x[..., 0])
    err = angle_normalize(theta_d - x[..., 2])
    delta = torch.clamp(k_theta * err, -spec.delta_max, spec.delta_max)
    beta = beta_from_delta(delta, spec)
    heading_scale = torch.clamp_min(torch.cos(err), 0.0)
    v = torch.clamp(k_v * distance * heading_scale, spec.v_min, spec.v_max)
    return torch.stack([k_a * (v - x[..., 3]), beta], dim=-1)


def stop(x, spec):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def has_stopped(x, spec, tol=0.05):
    return torch.abs(x[..., 3]) < tol


def rotate_to(x, theta_des, spec, k_theta=2.0):
    err = angle_normalize(theta_des - x[..., 2])
    return torch.stack([torch.zeros_like(err), k_theta * err], dim=-1)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.a_max, -spec.beta_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.a_max, spec.beta_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (torch.tensor([-inf, -inf, -inf, -spec.v_max], device=device, dtype=dtype),
            torch.tensor([inf, inf, inf, spec.v_max], device=device, dtype=dtype))


def barrier_pos(x):
    return x[..., :2]
