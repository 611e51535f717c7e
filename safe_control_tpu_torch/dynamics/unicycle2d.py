"""Unicycle2D: X=[x, y, theta], U=[v, omega], relative degree 1.

Port of ``safe_control_tpu/dynamics/unicycle2d.py``, batched over any
leading axes: ``x`` is ``(..., 3)`` and ``u`` is ``(..., 2)``.  ``step``
writes ``x + g(x) u dt`` component by component (g holds cos, sin and
exact zeros and ones), so that the fused kernel's model
(``csrc/mpc_fused_models.h``) repeats every rounding.  The continuous-time
barrier subtracts the heading sigmoid ``sigma`` (``barriers/hocbf.ct_h``);
the discrete-time one is the plain circle.
"""

from __future__ import annotations

import math

import torch

from safe_control_tpu_torch.core.types import norm2
from safe_control_tpu_torch.dynamics.base import angle_normalize, spec_vector

N_STATES = 3
N_CONTROLS = 2
REL_DEG = 1

# Sigmoid heading-shaping constants.
SIGMA_K1 = 0.5
SIGMA_K2 = 1.8


def f(x, spec):
    return torch.zeros_like(x)


def g(x, spec):
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zero], -1), torch.stack([s, zero], -1),
                        torch.stack([zero, one], -1)], dim=-2)


def step(x, u, spec, dt):
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    theta = x[..., 2]
    return torch.stack([
        x[..., 0] + (torch.cos(theta) * u[..., 0]) * dt,
        x[..., 1] + (torch.sin(theta) * u[..., 0]) * dt,
        angle_normalize(theta + u[..., 1] * dt),
    ], dim=-1)


def nominal_input(x, goal, spec, d_min=0.05, k_omega=2.0, k_v=1.0):
    distance = torch.clamp_min(norm2(x[..., :2] - goal[..., :2]) - d_min, 0.05)
    theta_d = torch.atan2(goal[..., 1] - x[..., 1], goal[..., 0] - x[..., 0])
    err = angle_normalize(theta_d - x[..., 2])
    omega = k_omega * err
    v = torch.where(torch.abs(err) > math.radians(90.0), torch.zeros_like(err),
                    k_v * distance * torch.cos(err))
    return torch.stack([v, omega], dim=-1)


def stop(x, spec):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def has_stopped(x, spec, tol=0.05):
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


def rotate_to(x, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - x[..., 2])
    return torch.stack([torch.zeros_like(err), k_omega * err], dim=-1)


def sigma(s):
    """Heading-shaping sigmoid."""
    e = torch.exp(SIGMA_K1 - s)
    return SIGMA_K2 * (e - 1.0) / (e + 1.0)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.v_max, -spec.w_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.v_max, spec.w_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (torch.full((N_STATES,), -inf, device=device, dtype=dtype),
            torch.full((N_STATES,), inf, device=device, dtype=dtype))


def barrier_pos(x):
    return x[..., :2]
