"""KinematicBicycle2D with the Dynamic Parabolic CBF (DPCBF) for moving obstacles.

Port of ``safe_control_tpu/dynamics/kinematic_bicycle2d_dpcbf.py``: the
kinematic bicycle dynamics with only the barrier replaced.  In the
line-of-sight frame (x' toward the obstacle):

    h = v_rel_x' + lambda v_rel_y'^2 + mu
    lambda = k_lambda sqrt(d_safe) / max(|v_rel|, eps) sqrt(s^2 - 1) / R
    mu     = k_mu     sqrt(d_safe)                     sqrt(s^2 - 1) / R
    d_safe = max(|p_rel|^2 - R^2, eps),  R = (r_obs + r_robot) s

with k_lambda = 0.1, k_mu = 0.5 and s = 1.05.  Relative degree 1, the same
barrier in continuous and discrete time.  Batched: ``x (..., 4)`` against
``obs (..., 7)``.  The norms and the ``max`` with eps differentiate as the
JAX package's (``kinematic_bicycle2d_c3bf``'s docstring).
"""

from __future__ import annotations

import math

import torch

from safe_control_tpu_torch.core.types import OBS_R
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import *  # noqa: F401,F403
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import max_tie
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d_c3bf import relative_motion

REL_DEG = 1

K_LAMBDA = 0.1
K_MU = 0.5
S_MARGIN = 1.05
EPS = 1e-6


def _dpcbf_h(x, obs, spec, s=S_MARGIN):
    ego_dim = (obs[..., OBS_R] + spec.radius) * s
    (px, py), (vx, vy) = relative_motion(x, obs)
    p_mag = torch.sqrt(px * px + py * py)
    v_mag = torch.sqrt(vx * vx + vy * vy)
    rot = torch.atan2(py, px)
    c, sn = torch.cos(rot), torch.sin(rot)
    v_rel_x = c * vx + sn * vy
    v_rel_y = -sn * vx + c * vy
    d_safe = max_tie(p_mag**2 - ego_dim**2, EPS)
    scale = math.sqrt(s**2 - 1.0) / ego_dim
    lam = K_LAMBDA * torch.sqrt(d_safe) / max_tie(v_mag, EPS) * scale
    mu = K_MU * torch.sqrt(d_safe) * scale
    return v_rel_x + lam * v_rel_y**2 + mu


def ct_h(x, obs, spec):
    return _dpcbf_h(x, obs, spec)


def dt_h(x, obs, spec):
    return _dpcbf_h(x, obs, spec)
