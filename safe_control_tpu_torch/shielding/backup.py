"""Backup policies: simple closed-loop controllers that can be rolled out.

Port of ``safe_control_tpu/shielding/backup.py``, batched over any leading
axes: each policy is a function ``u = policy(x, ...)`` of states ``(..., n)``
that the gatekeeper rolls out and the backup CBF differentiates.

- ``lane_change``: cascaded PD to a target lane y (DriftingCar);
- ``stopping``: PD braking to rest with a holding torque (DriftingCar);
- ``evade``: phased PD into a safe pocket (DoubleIntegrator2D); the JAX
  package's nested ``jnp.where`` phases are nested ``torch.where`` here.

Every ``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` is
``torch.minimum`` / ``torch.maximum`` against a tensor, whose derivative at a
tie is 0.5 as JAX's (the backup CBF takes ``jacfwd`` through them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from safe_control_tpu_torch.core.types import angle_normalize
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import _like, clip_tie, max_tie


class LaneChangeGains(NamedTuple):
    kp_y: float = 0.25
    kd_y: float = 0.3
    kp_theta: float = 1.2
    kd_theta: float = 1.0
    kp_delta: float = 2.5
    kp_v: float = 500.0
    kp_tau_dot: float = 2.0
    target_velocity: float = 8.0
    theta_des_max: float = math.radians(20.0)
    delta_max: float = math.radians(20.0)
    delta_dot_max: float = math.radians(25.0)
    tau_max: float = 4000.0
    tau_dot_max: float = 8000.0


def lane_change(x, target_y, spec, gains: LaneChangeGains = LaneChangeGains()):
    """Cascaded PD lane change for DriftingCar: ``x (..., 8)`` -> ``(..., 2)``."""
    y, theta, r, beta = x[..., 1], x[..., 2], x[..., 3], x[..., 4]
    V, delta, tau = max_tie(x[..., 5], 0.1), x[..., 6], x[..., 7]
    vy = V * torch.sin(angle_normalize(theta + beta))
    theta_des = torch.atan(gains.kp_y * (target_y - y) - gains.kd_y * vy)
    theta_des = clip_tie(theta_des, -gains.theta_des_max, gains.theta_des_max)
    course = angle_normalize(theta + beta)
    theta_err = angle_normalize(theta_des - course)
    delta_des = clip_tie(gains.kp_theta * theta_err - gains.kd_theta * r,
                         -gains.delta_max, gains.delta_max)
    delta_dot = clip_tie(gains.kp_delta * (delta_des - delta),
                         -gains.delta_dot_max, gains.delta_dot_max)
    tau_des = clip_tie(gains.kp_v * (gains.target_velocity - V), -gains.tau_max, gains.tau_max)
    tau_dot = clip_tie(gains.kp_tau_dot * (tau_des - tau), -gains.tau_dot_max, gains.tau_dot_max)
    return torch.stack([delta_dot, tau_dot], dim=-1)


class StoppingGains(NamedTuple):
    kp_v: float = 1000.0
    kd_theta: float = 1.0
    kp_delta: float = 3.0
    stop_velocity_threshold: float = 0.05
    min_braking_torque: float = -500.0
    holding_torque: float = -100.0
    delta_max: float = math.radians(20.0)
    delta_dot_max: float = math.radians(25.0)
    tau_max: float = 4000.0
    tau_dot_max: float = 8000.0


def stopping(x, spec, gains: StoppingGains = StoppingGains()):
    """PD braking to a stop with a holding torque for DriftingCar."""
    r, V, delta, tau = x[..., 3], x[..., 5], x[..., 6], x[..., 7]
    tau_des_moving = torch.minimum(-gains.kp_v * V, _like(V, gains.min_braking_torque))
    tau_des = torch.where(V > gains.stop_velocity_threshold, tau_des_moving,
                          _like(V, gains.holding_torque))
    tau_des = clip_tie(tau_des, -gains.tau_max, gains.tau_max)
    tau_err = tau_des - tau
    tau_dot = 5000.0 * torch.sign(tau_err) * torch.minimum(torch.abs(tau_err) / 50.0,
                                                           _like(tau_err, 1.0))
    tau_dot = clip_tie(tau_dot, -gains.tau_dot_max, gains.tau_dot_max)
    delta_des = clip_tie(-gains.kd_theta * r, -gains.delta_max, gains.delta_max)
    delta_dot = clip_tie(gains.kp_delta * (delta_des - delta),
                         -gains.delta_dot_max, gains.delta_dot_max)
    return torch.stack([delta_dot, tau_dot], dim=-1)


class EvadeConfig(NamedTuple):
    pocket_center: tuple  # (x, y)
    pocket_x_min: float
    pocket_x_max: float
    pocket_y_min: float
    pocket_y_max: float
    goal_x_min: float = 0.0
    goal_x_max: float = 0.0
    goal_y_min: float = 0.0
    goal_y_max: float = 0.0
    has_goal: bool = False
    kp: float = 2.0
    kd: float = 2.0


def evade(x, cfg: EvadeConfig, spec):
    """Phased PD evade-to-pocket for DoubleIntegrator2D: ``x (..., 4)``."""
    px, py, vx, vy = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    margin = spec.radius + 0.1
    cx, cy = cfg.pocket_center
    pair = lambda a, b: torch.stack(torch.broadcast_tensors(a, b), dim=-1)

    # Goal zone: brake.
    in_goal = ((px >= cfg.goal_x_min) & (px <= cfg.goal_x_max) & (py >= cfg.goal_y_min)
               & (py <= cfg.goal_y_max))
    if not cfg.has_goal:
        in_goal = torch.zeros_like(in_goal)
    brake = pair(-cfg.kd * vx, -cfg.kd * vy)

    # Deep inside the pocket: brake.
    dist_c = torch.sqrt((px - cx) * (px - cx) + (py - cy) * (py - cy))
    inside = ((px >= cfg.pocket_x_min + margin) & (px <= cfg.pocket_x_max - margin)
              & (py >= cfg.pocket_y_min + margin) & (py <= cfg.pocket_y_max - margin)
              & (dist_c < 1.0))

    # Near the pocket's x-range: aligned, or stay high while above the wall.
    near_x = (px >= cfg.pocket_x_min - 2.0) & (px <= cfg.pocket_x_max + 2.0)
    safe_x_entry = (px >= cfg.pocket_x_min + margin) & (px <= cfg.pocket_x_max - margin)
    a_near_aligned = pair(cfg.kp * (cx - px) - cfg.kd * vx, cfg.kp * (cy - py) - cfg.kd * vy)
    ty_near = torch.where(py > cfg.pocket_y_min, max_tie(py, 3.0), torch.zeros_like(py))
    a_near_unaligned = pair(cfg.kp * (cx - px) - cfg.kd * vx,
                            cfg.kp * (ty_near - py) - cfg.kd * vy)
    a_near = torch.where(safe_x_entry[..., None], a_near_aligned, a_near_unaligned)

    # Far: run along the hallway toward the pocket's x.
    ty_far = torch.where((py > cfg.pocket_y_min) & (px > cfg.pocket_x_max), max_tie(py, 3.0),
                         torch.zeros_like(py))
    ex = cx - px
    a_far = pair(
        cfg.kp * torch.sign(ex) * torch.minimum(torch.abs(ex), _like(ex, 3.0)) - cfg.kd * vx,
        cfg.kp * (ty_far - py) - cfg.kd * vy,
    )

    a = torch.where(in_goal[..., None], brake, torch.where(
        inside[..., None], brake, torch.where(near_x[..., None], a_near, a_far)))
    a_mag = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
    scale = torch.where(a_mag > spec.a_max, spec.a_max / max_tie(a_mag, 1e-9),
                        torch.ones_like(a_mag))
    return a * scale[..., None]
