"""KinematicBicycle2D with the Collision-Cone CBF (C3BF) for moving obstacles.

Port of ``safe_control_tpu/dynamics/kinematic_bicycle2d_c3bf.py``: the
kinematic bicycle dynamics with only the barrier replaced,

    h = <p_rel, v_rel> + |p_rel| |v_rel| cos(phi),
    cos(phi) = sqrt(max(|p_rel|^2 - R^2, eps)) / (|p_rel| + eps),

with p_rel / v_rel the position / velocity of a constant-velocity obstacle
(vx, vy in obs columns 3:5) relative to the robot and R = (r_obs + r_robot)
beta.  Relative degree 1.  Batched: ``x (..., 4)`` against ``obs (..., 7)``.

The norms are ``sqrt`` of sums of squares, whose derivative at a zero
vector is NaN as that of the JAX package's ``jnp.linalg.norm`` (a robot at
rest beside a static obstacle); ``torch.linalg.norm``'s would be 0.  The
``max`` with eps takes 0.5 of the derivative at a tie, as ``jnp.maximum``.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.core.types import OBS_R, OBS_VX, OBS_VY
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import *  # noqa: F401,F403
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import max_tie

REL_DEG = 1

CT_BETA = 1.0  # the continuous-time barrier's margin
DT_BETA = 1.01  # the discrete-time barrier's
EPS = 1e-6


def relative_motion(x, obs):
    """``(p_rel, v_rel)`` of the obstacle, each a pair of ``(...)`` tensors."""
    theta, v = x[..., 2], x[..., 3]
    p_rel = (obs[..., 0] - x[..., 0], obs[..., 1] - x[..., 1])
    v_rel = (obs[..., OBS_VX] - v * torch.cos(theta), obs[..., OBS_VY] - v * torch.sin(theta))
    return p_rel, v_rel


def _c3bf_h(x, obs, spec, beta):
    ego_dim = (obs[..., OBS_R] + spec.radius) * beta
    (px, py), (vx, vy) = relative_motion(x, obs)
    p_mag = torch.sqrt(px * px + py * py)
    v_mag = torch.sqrt(vx * vx + vy * vy)
    sqrt_term = torch.sqrt(max_tie(p_mag**2 - ego_dim**2, EPS))
    cos_phi = sqrt_term / (p_mag + EPS)
    return (px * vx + py * vy) + p_mag * v_mag * cos_phi


def ct_h(x, obs, spec):
    return _c3bf_h(x, obs, spec, CT_BETA)


def dt_h(x, obs, spec):
    return _c3bf_h(x, obs, spec, DT_BETA)
