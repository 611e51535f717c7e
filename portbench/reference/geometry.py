"""Obstacle encoding, angles, barrier values and the collision oracle.

Obstacles are 7-vectors ``[ox, oy, r_or_a, b_or_vx, e_or_vy, theta, flag]``:
flag 0 is a circle (columns 3:5 hold a moving circle's velocity), flag 1 a
superellipsoid; padded rows sit at (1000, 1000).
"""

from __future__ import annotations

import math

import torch

OBS_DIM = 7
DUMMY_OBS_POS = 1000.0
OBS_R, OBS_FLAG = 2, 6


def angle_normalize(x):
    """Wrap into [-pi, pi) with floor semantics."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def norm2(v):
    """sqrt(v0^2 + v1^2) over a last axis of 2."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def is_dummy(obs):
    return obs[..., 0] >= DUMMY_OBS_POS - 1.0


def pad_obstacles(rows, k: int, *, dtype=torch.float32, device=None):
    """``rows`` (lists of up to 7 numbers) as a ``(k, 7)`` tensor, padded
    with dummy rows."""
    out = torch.zeros((k, OBS_DIM), dtype=dtype, device=device)
    out[:, :2] = DUMMY_OBS_POS
    for i, r in enumerate(rows[:k]):
        out[i, :2] = 0.0
        out[i, : len(r)] = torch.tensor([float(v) for v in r], dtype=dtype)
    return out


def h_circle(p, obs, robot_radius, beta):
    d_min = obs[..., OBS_R] + robot_radius
    diff = p - obs[..., 0:2]
    return (diff * diff).sum(-1) - beta * d_min**2


def h_superellipsoid(p, obs, robot_radius):
    a = torch.clamp_min(torch.abs(obs[..., 2]), 1e-3)
    b = torch.clamp_min(torch.abs(obs[..., 3]), 1e-3)
    e = torch.clamp_min(torch.abs(obs[..., 4]), 2.0)
    theta = obs[..., 5]
    ct, st = torch.cos(theta), torch.sin(theta)
    dx = p[..., 0] - obs[..., 0]
    dy = p[..., 1] - obs[..., 1]
    px = ct * dx + st * dy
    py = -st * dx + ct * dy
    return (torch.pow(torch.abs(px) / (a + robot_radius), e)
            + torch.pow(torch.abs(py) / (b + robot_radius), e) - 1.0)


def h_point(p, obs, robot_radius, beta):
    """Circle or superellipsoid barrier by the obstacle's flag."""
    return torch.where(obs[..., OBS_FLAG] < 0.5, h_circle(p, obs, robot_radius, beta),
                       h_superellipsoid(p, obs, robot_radius))


def collides(radius, pos, obs):
    """``pos (B, 2)`` inside any row of ``obs (B, K, 7)``: ``(B,)``."""
    p = pos[:, None, :]
    circle_hit = norm2(p - obs[..., :2]) < obs[..., OBS_R] + radius
    a = torch.clamp_min(torch.abs(obs[..., 2]), 1e-3)
    b = torch.clamp_min(torch.abs(obs[..., 3]), 1e-3)
    e = torch.clamp_min(torch.abs(obs[..., 4]), 2.0)
    th = obs[..., 5]
    ct, st = torch.cos(th), torch.sin(th)
    dx, dy = p[..., 0] - obs[..., 0], p[..., 1] - obs[..., 1]
    px = ct * dx + st * dy
    py = -st * dx + ct * dy
    se_hit = (torch.pow(torch.abs(px) / (a + radius), e)
              + torch.pow(torch.abs(py) / (b + radius), e) - 1.0) <= 0.0
    is_se = (obs[..., OBS_FLAG] >= 0.5) & (obs[..., 4] >= 2.0)
    hit = ~is_dummy(obs) & torch.where(is_se, se_hit, circle_hit)
    return hit.any(-1)
