"""DriftingCar: the global 8-state wrapper over DynamicBicycle2D.

Port of ``safe_control_tpu/dynamics/drifting_car.py``, batched over any
leading axes: X = [x, y, theta, r, beta, V, delta, tau], U = [delta_dot,
tau_dot].  The pose follows x_dot = V cos(theta + beta), y_dot = V
sin(theta + beta), theta_dot = r.  ``step`` runs the body dynamics first and
then integrates the position with the NEXT (V, beta, r) and the CURRENT
heading, as the JAX model does.  ``f``/``g`` are the full 8-dimensional
affine dynamics (for the backup CBF); ``nominal_input`` is the cascaded P
steering and torque law.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.dynamics import dynamic_bicycle2d as dyn
from safe_control_tpu_torch.dynamics.base import angle_normalize, spec_vector
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import clip_tie

N_STATES = 8
N_CONTROLS = 2
REL_DEG = 1


def f(x, spec):
    """Full-state drift dynamics."""
    f_dyn = dyn.f(x[..., 3:8], spec)
    theta, r, beta, V = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
    pose = torch.stack([V * torch.cos(theta + beta), V * torch.sin(theta + beta), r], dim=-1)
    return torch.cat([pose, f_dyn], dim=-1)


def g(x, spec):
    """Full-state control matrix: the inputs reach delta and tau only."""
    zero = torch.zeros_like(x[..., 0])
    one = torch.ones_like(zero)
    rows = [[zero, zero]] * 6 + [[one, zero], [zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def step(x, u, spec, dt):
    """Body dynamics first, then the pose with the next (V, beta, r) and the
    current theta."""
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    x_dyn_next = dyn.step(x[..., 3:8], u, spec, dt)
    theta = x[..., 2]
    r, beta, V = x_dyn_next[..., 0], x_dyn_next[..., 1], x_dyn_next[..., 2]
    xg = x[..., 0] + V * torch.cos(theta + beta) * dt
    yg = x[..., 1] + V * torch.sin(theta + beta) * dt
    th = angle_normalize(theta + r * dt)
    return torch.cat([torch.stack([xg, yg, th], dim=-1), x_dyn_next], dim=-1)


def nominal_input(x, goal, spec, d_min=0.5):
    """Cascaded P steering and torque-rate law toward ``goal[..., :2]``."""
    dx_ = goal[..., 0] - x[..., 0]
    dy_ = goal[..., 1] - x[..., 1]
    distance = torch.sqrt(dx_ * dx_ + dy_ * dy_)
    heading_err = angle_normalize(torch.atan2(dy_, dx_) - x[..., 2])
    delta_des = clip_tie(2.0 * heading_err, -spec.delta_max, spec.delta_max)
    delta_dot = clip_tie(3.0 * (delta_des - x[..., 6]), -spec.delta_dot_max, spec.delta_dot_max)
    V_des = torch.minimum(distance, torch.full_like(distance, spec.v_max))
    tau_des = clip_tie(500.0 * (V_des - x[..., 5]), -spec.tau_max, spec.tau_max)
    tau_dot = clip_tie(2000.0 * (tau_des - x[..., 7]), -spec.tau_dot_max, spec.tau_dot_max)
    return torch.stack([delta_dot, tau_dot], dim=-1)


def stop(x, spec):
    return dyn.stop(x[..., 3:8], spec)


def has_stopped(x, spec, tol=0.5):
    return dyn.has_stopped(x[..., 3:8], spec, tol)


def rotate_to(x, theta_des, spec):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return dyn.u_lb(spec, device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return dyn.u_ub(spec, device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    lb_d, ub_d = dyn.state_bounds(spec, device=device, dtype=dtype)
    lb_p = spec_vector([-inf, -inf, -inf], device=device, dtype=dtype).expand(
        lb_d.shape[:-1] + (3,))
    ub_p = spec_vector([inf, inf, inf], device=device, dtype=dtype).expand(ub_d.shape[:-1] + (3,))
    return torch.cat([lb_p, lb_d], dim=-1), torch.cat([ub_p, ub_d], dim=-1)


def barrier_pos(x):
    return x[..., :2]
