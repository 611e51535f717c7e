"""Manipulator2D: 3-link planar arm, X=[q1, q2, q3], U = joint velocities.

Port of ``safe_control_tpu/dynamics/manipulator2d.py``, batched over any
leading axes: kinematic dynamics q' = u, forward kinematics, the
Jacobian-transpose IK nominal input (the end effector's Jacobian in closed
form) and the per-link sampled-circle barrier: each link carries 9, 8 and 6
circles (23 in all), and each circle gives one CBF row per obstacle
(``ct_multi_h``; ``barriers/hocbf.ct_cbf_rows_multi``).  The circle
centers use ``core.types.linspace``, which rounds as the JAX package's
jitted ``jnp.linspace``.  The MPC barrier acts on ``barrier_pos(x) = 0``, a
constant, as the JAX package's does.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.barriers.geometry import h_circle
from safe_control_tpu_torch.core.types import linspace
from safe_control_tpu_torch.dynamics.base import spec_vector

N_STATES = 3
N_CONTROLS = 3
REL_DEG = 1
NUM_LINKS = 3

# Link discretization: ceil(L_i / (10/60)) steps on links of 80/70/50 px / 60
# => 9 + 8 + 6 = 23 circles, a static count.
_NUM_STEPS = (8, 7, 5)
NUM_CIRCLES = sum(n + 1 for n in _NUM_STEPS)


def _link_lengths(spec):
    return (spec.link_len_1, spec.link_len_2, spec.link_len_3)


def f(x, spec):
    return torch.zeros_like(x)


def g(x, spec):
    eye = torch.eye(N_STATES, dtype=x.dtype, device=x.device)
    return eye.expand(x.shape[:-1] + (N_STATES, N_CONTROLS))


def step(x, u, spec, dt):
    return x + u * dt


def joint_positions(x, spec):
    """Base and the three joint / end-effector positions, ``(..., 4, 2)``."""
    angles = torch.cumsum(x, dim=-1)
    L = torch.tensor(_link_lengths(spec), dtype=x.dtype, device=x.device)
    deltas = L[:, None] * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    base = torch.tensor([spec.base_x, spec.base_y], dtype=x.dtype, device=x.device)
    base = base.expand(x.shape[:-1] + (1, 2))
    return torch.cat([base, base + torch.cumsum(deltas, dim=-2)], dim=-2)


def end_effector(x, spec):
    return joint_positions(x, spec)[..., -1, :]


def link_circle_centers(x, spec):
    """Centers of the ``NUM_CIRCLES`` circles along the links, ``(..., 23, 2)``."""
    pts = joint_positions(x, spec)
    centers = []
    for i, n in enumerate(_NUM_STEPS):
        t = linspace(0.0, 1.0, n + 1, dtype=x.dtype, device=x.device)[:, None]
        a, b = pts[..., i, None, :], pts[..., i + 1, None, :]
        centers.append(a + t * (b - a))
    return torch.cat(centers, dim=-2)


def ee_jacobian(x, spec):
    """d(end effector)/dq, ``(..., 2, 3)``: column k sums
    L_i (-sin a_i, cos a_i) over the links i >= k."""
    angles = torch.cumsum(x, dim=-1)
    L = torch.tensor(_link_lengths(spec), dtype=x.dtype, device=x.device)
    terms = L * torch.stack([-torch.sin(angles), torch.cos(angles)], dim=-2)  # (..., 2, 3)
    return torch.flip(torch.cumsum(torch.flip(terms, [-1]), dim=-1), [-1])


def nominal_input(x, goal, spec, d_min=0.05):
    """IK P-control: omega = J' (kp (goal - ee)), clipped to +-w_max."""
    J = ee_jacobian(x, spec)
    v_des = spec.kp * (goal[..., :2] - end_effector(x, spec))
    omega = J[..., 0, :] * v_des[..., 0, None] + J[..., 1, :] * v_des[..., 1, None]
    return torch.clamp(omega, -spec.w_max, spec.w_max)


def stop(x, spec):
    return torch.zeros_like(x)


def has_stopped(x, spec, tol=0.05):
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


def rotate_to(x, theta_des, spec, k_omega=2.0):
    return torch.zeros_like(x)


def ct_multi_h(x, obs, spec):
    """The ``NUM_CIRCLES`` barrier values for one obstacle, ``(..., 23)``:
    h_j = |c_j(q) - o|^2 - beta (r + r_obs)^2."""
    return h_circle(link_circle_centers(x, spec), obs[..., None, :], spec.radius,
                    spec.manip_beta)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.w_max] * 3, device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.w_max] * 3, device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (torch.full((N_STATES,), -inf, device=device, dtype=dtype),
            torch.full((N_STATES,), inf, device=device, dtype=dtype))


def barrier_pos(x):
    # The base is fixed; the barrier of the CBF-QP goes through ct_multi_h.
    return x[..., :2] * 0.0
