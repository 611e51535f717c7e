"""Barrier value functions h(x) (port of ``safe_control_tpu/barriers/geometry.py``).

One function per obstacle geometry, broadcasting over leading axes:
``p`` is ``(..., 2)`` and ``obs`` is ``(..., 7)``.  Derivatives come from
``torch.func``.  Both the circle and the superellipsoid branch are always
evaluated under ``torch.where``; the superellipsoid branch carries the guards
a, b >= 1e-3 and e >= 2 so that circle and dummy rows, whose superellipsoid
value is computed but not selected, cannot produce NaN in the value or its
derivative.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.core.types import (
    OBS_B,
    OBS_E,
    OBS_FLAG,
    OBS_R,
    OBS_THETA,
    OBS_X,
    OBS_Y,
)


def h_circle(p, obs, robot_radius, beta=1.01):
    """h = ||p - o||^2 - beta * d_min^2."""
    d_min = obs[..., OBS_R] + robot_radius
    diff = p - obs[..., OBS_X : OBS_Y + 1]
    return (diff * diff).sum(-1) - beta * d_min**2


def h_superellipsoid(p, obs, robot_radius):
    """h = |px'/(a+r)|^e + |py'/(b+r)|^e - 1 in the obstacle frame."""
    a = torch.clamp_min(torch.abs(obs[..., OBS_R]), 1e-3)
    b = torch.clamp_min(torch.abs(obs[..., OBS_B]), 1e-3)
    e = torch.clamp_min(torch.abs(obs[..., OBS_E]), 2.0)
    theta = obs[..., OBS_THETA]
    ct, st = torch.cos(theta), torch.sin(theta)
    dx = p[..., 0] - obs[..., OBS_X]
    dy = p[..., 1] - obs[..., OBS_Y]
    px = ct * dx + st * dy
    py = -st * dx + ct * dy
    return (
        torch.pow(torch.abs(px) / (a + robot_radius), e)
        + torch.pow(torch.abs(py) / (b + robot_radius), e)
        - 1.0
    )


def h_point(p, obs, robot_radius, beta=1.01):
    """Flag-dispatched barrier for a point robot (circle vs superellipsoid)."""
    is_circle = obs[..., OBS_FLAG] < 0.5
    return torch.where(
        is_circle,
        h_circle(p, obs, robot_radius, beta),
        h_superellipsoid(p, obs, robot_radius),
    )
