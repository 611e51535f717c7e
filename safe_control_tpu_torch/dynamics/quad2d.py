"""Quad2D planar quadrotor: X=[x, z, theta, vx, vz, w], U=[F_r, F_l], r=2.

Port of ``safe_control_tpu/dynamics/quad2d.py``, batched over any leading
axes: ``x`` is ``(..., 6)`` and ``u`` is ``(..., 2)``.  ``step`` is Euler on
``f + g u`` with theta wrapped, written component by component with the
divisions by the mass and the inertia as products with reciprocals, so that
the fused kernel's model (``csrc/mpc_fused_models.h``) repeats every
rounding.  ``nominal_input`` is the cascaded PD (position loop, then thrust
and attitude, then rotor forces); ``stop`` hovers in place.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.core.types import norm2
from safe_control_tpu_torch.dynamics.base import angle_normalize, spec_vector

N_STATES = 6
N_CONTROLS = 2
REL_DEG = 2

GRAVITY = 9.81


def f(x, spec):
    zero = torch.zeros_like(x[..., 0])
    return torch.stack([x[..., 3], x[..., 4], x[..., 5], zero, zero - GRAVITY, zero], dim=-1)


def _g_rows(theta, spec):
    """The non-zero entries of g: -sin/m and cos/m (both columns), r/I."""
    inv_m = 1.0 / spec.mass
    return -torch.sin(theta) * inv_m, torch.cos(theta) * inv_m, spec.radius * (1.0 / spec.inertia)


def g(x, spec):
    gs, gc, k = _g_rows(x[..., 2], spec)
    zero = torch.zeros_like(gs)
    rows = [[zero, zero]] * 3 + [[gs, gs], [gc, gc], [zero + k, zero - k]]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def step(x, u, spec, dt):
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    gs, gc, k = _g_rows(x[..., 2], spec)
    u0, u1 = u[..., 0], u[..., 1]
    return torch.stack([
        x[..., 0] + x[..., 3] * dt,
        x[..., 1] + x[..., 4] * dt,
        angle_normalize(x[..., 2] + x[..., 5] * dt),
        x[..., 3] + (gs * u0 + gs * u1) * dt,
        x[..., 4] + (-GRAVITY + (gc * u0 + gc * u1)) * dt,
        x[..., 5] + (k * u0 + -k * u1) * dt,
    ], dim=-1)


def nominal_input(x, goal, spec, k_px=3.0, k_dx=0.5, k_pz=0.1, k_dz=0.5,
                  k_p_theta=0.05, k_d_theta=0.05):
    """Cascaded PD: outer position loop -> thrust / attitude -> rotor forces."""
    m, r = spec.mass, spec.radius
    e_x = goal[..., 0] - x[..., 0]
    e_z = goal[..., 1] - x[..., 1]
    a_d_x = k_px * e_x + k_dx * (-x[..., 3])
    a_d_z = k_pz * e_z + k_dz * (-x[..., 4]) + GRAVITY
    T = m * torch.sqrt(a_d_x**2 + a_d_z**2)
    theta_d = -torch.atan2(a_d_x, a_d_z)
    e_theta = torch.atan2(torch.sin(theta_d - x[..., 2]), torch.cos(theta_d - x[..., 2]))
    tau = torch.clamp(k_p_theta * e_theta + k_d_theta * (-x[..., 5]), -1.0, 1.0)
    F_r = torch.clamp((T + tau / r) / 2.0, spec.f_min, spec.f_max)
    F_l = torch.clamp((T - tau / r) / 2.0, spec.f_min, spec.f_max)
    return torch.stack([F_r, F_l], dim=-1)


def stop(x, spec):
    """Hover at the current position."""
    return nominal_input(x, x[..., :2], spec)


def has_stopped(x, spec, tol=0.05):
    return norm2(x[..., 3:5]) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - x[..., 2])
    return torch.stack([torch.zeros_like(err), k_omega * err], dim=-1)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.f_min, spec.f_min], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.f_max, spec.f_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (torch.full((N_STATES,), -inf, device=device, dtype=dtype),
            torch.full((N_STATES,), inf, device=device, dtype=dtype))


def barrier_pos(x):
    return x[..., :2]
