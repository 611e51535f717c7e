"""Quad3D: linearized 6-DOF quadrotor, 12 states, 4 motor forces.

Port of ``safe_control_tpu/dynamics/quad3d.py``, batched over any leading
axes: ``x`` is ``(..., 12)`` = [x, y, z, th, ph, ps, vx, vy, vz, q, p, r] and
``u`` is ``(..., 4)``.  ``step`` is RK4 on ``A x + B u`` with the three
angles wrapped; the barrier is the RK4 sampled-data circle on (x, y), so the
discrete-time relative degree is 1.

``A x`` and ``B u`` are written as elementwise products and left-to-right
sums (A holds ones and +-GRAVITY, B = B1 B2 four non-zero rows), so no
matrix product, and no TF32, is on the path.  ``csrc/mpc_fused_models.h``
holds the same expressions for the fused kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_tpu_torch.barriers.geometry import h_circle
from safe_control_tpu_torch.dynamics.base import angle_normalize, free_bounds, masked_apply, spec_vector

N_STATES = 12
N_CONTROLS = 4
REL_DEG = 1  # discrete-time relative degree (RK4 sampled-data CBF)

GRAVITY = 9.8


def _b2(spec) -> np.ndarray:
    """The wrench map [F, tau_y, tau_x, tau_z] = B2 u (float64)."""
    L, nu = spec.arm_length, spec.nu_torque
    return np.array([[1.0, 1.0, 1.0, 1.0], [0.0, L, 0.0, -L],
                     [L, 0.0, -L, 0.0], [nu, -nu, nu, -nu]])


def input_rows(spec) -> tuple:
    """Rows 8..11 of B = B1 B2 as Python floats (the other rows are zero)."""
    inv = (1.0 / spec.mass, 1.0 / spec.iy, 1.0 / spec.ix, 1.0 / spec.iz)
    return tuple(tuple(float(inv[r] * c) for c in row) for r, row in enumerate(_b2(spec)))


def _bu(u, spec):
    """(B u)[8:12], each row summed left to right."""
    out = []
    for row in input_rows(spec):
        s = row[0] * u[..., 0]
        for j in range(1, N_CONTROLS):
            s = s + row[j] * u[..., j]
        out.append(s)
    return out


def _deriv(z, bu):
    """A z + B u with the rows of B u given."""
    return torch.stack(
        [z[..., 6 + i] for i in range(6)]
        + [GRAVITY * z[..., 3], -GRAVITY * z[..., 4]] + bu, dim=-1)


def f(x, spec):
    zero = torch.zeros_like(x[..., 0])
    return _deriv(x, [zero] * 4)


def g(x, spec):
    rows = torch.zeros((N_STATES, N_CONTROLS), dtype=x.dtype, device=x.device)
    rows[8:] = torch.tensor(input_rows(spec), dtype=x.dtype, device=x.device)
    return rows.expand(x.shape[:-1] + (N_STATES, N_CONTROLS))


def step(x, u, spec, dt):
    """RK4 with th, ph, ps wrapped into [-pi, pi)."""
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    bu = _bu(u, spec)
    k1 = _deriv(x, bu)
    k2 = _deriv(x + dt / 2 * k1, bu)
    k3 = _deriv(x + dt / 2 * k2, bu)
    k4 = _deriv(x + dt * k3, bu)
    xn = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return masked_apply(xn, angle_normalize, 3, 6)


def _allocate(spec, F, tau_y, tau_x, tau_z):
    """pinv(B2) wrench -> motor forces, clipped to [u_min, u_max]."""
    pinv = np.linalg.pinv(_b2(spec))
    wrench = (F, tau_y, tau_x, tau_z)
    u = []
    for row in pinv:
        s = float(row[0]) * wrench[0]
        for j in range(1, 4):
            s = s + float(row[j]) * wrench[j]
        u.append(s)
    return torch.clamp(torch.stack(u, dim=-1), spec.u_min, spec.u_max)


def nominal_input(x, goal, spec, k_p=1.0, k_d=2.0, k_ang=5.0):
    """PD position loop -> linearized attitude targets -> allocation.
    ``goal`` may be (..., 2) or (..., >=3); a missing z target is 0."""
    gz = goal[..., 2] if goal.shape[-1] >= 3 else torch.zeros_like(x[..., 2])
    ax = k_p * (goal[..., 0] - x[..., 0]) + k_d * (-x[..., 6])
    ay = k_p * (goal[..., 1] - x[..., 1]) + k_d * (-x[..., 7])
    az = k_p * (gz - x[..., 2]) + k_d * (-x[..., 8])
    theta_des = ax / GRAVITY
    phi_des = -ay / GRAVITY
    F_des = spec.mass * az
    tau_y = spec.iy * (k_ang * (theta_des - x[..., 3]) + k_d * (-x[..., 9]))
    tau_x = spec.ix * (k_ang * (phi_des - x[..., 4]) + k_d * (-x[..., 10]))
    tau_z = spec.iz * (k_ang * (0.0 - x[..., 5]) + k_d * (-x[..., 11]))
    return _allocate(spec, F_des, tau_y, tau_x, tau_z)


def stop(x, spec, k_stop=1.0):
    """Velocity-damping stop."""
    theta_des = -k_stop * x[..., 6] / GRAVITY
    phi_des = k_stop * x[..., 7] / GRAVITY
    F_des = spec.mass * (-k_stop * x[..., 8])
    tau_y = spec.iy * k_stop * (theta_des - x[..., 3] - x[..., 9] / k_stop)
    tau_x = spec.ix * k_stop * (phi_des - x[..., 4] - x[..., 10] / k_stop)
    tau_z = spec.iz * k_stop * (0.0 - x[..., 5] - x[..., 11] / k_stop)
    return _allocate(spec, F_des, tau_y, tau_x, tau_z)


def has_stopped(x, spec, tol=0.05):
    return (torch.linalg.vector_norm(x[..., 6:9], dim=-1) < tol) & (
        torch.linalg.vector_norm(x[..., 9:12], dim=-1) < tol)


def rotate_to(x, ang_des, spec, k_omega=2.0):
    """Yaw to ``ang_des`` at hover."""
    F_hover = torch.full_like(x[..., 0], spec.mass * GRAVITY)
    tau_y = spec.iy * k_omega * (0.0 - x[..., 3] - x[..., 9] / k_omega)
    tau_x = spec.ix * k_omega * (0.0 - x[..., 4] - x[..., 10] / k_omega)
    tau_z = spec.iz * k_omega * (ang_des - x[..., 5] - x[..., 11] / k_omega)
    return _allocate(spec, F_hover, tau_y, tau_x, tau_z)


def dt_h(x, obs, spec):
    """Cylinder-obstacle circle barrier in (x, y)."""
    return h_circle(x[..., :2], obs, spec.radius, spec.cbf_beta)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.u_min] * N_CONTROLS, device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.u_max] * N_CONTROLS, device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    return free_bounds(N_STATES, device=device, dtype=dtype)


def barrier_pos(x):
    return x[..., :2]
