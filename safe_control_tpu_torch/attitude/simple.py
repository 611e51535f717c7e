"""Simple attitude (yaw side-channel) controllers, batched.

Port of ``safe_control_tpu/attitude/simple.py``: a constant yaw rate, and a
P-control of the yaw toward the velocity vector with an optional
acceleration preview.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.core.types import angle_normalize


def simple_att(spec, yaw):
    """Constant yaw rate."""
    return spec.w_max


def velocity_tracking_yaw(model_name: str, spec, x, yaw, u, kp: float = 1.5,
                          preview_time: float = 0.0):
    """Yaw-rate commands ``(B,)`` aligning each heading with its velocity:
    ``x (B, n)``, ``yaw (B,)``, ``u (B, m)``."""
    if model_name == spec_mod.SINGLE_INTEGRATOR_2D:
        vx, vy = u[..., 0], u[..., 1]
    else:  # DoubleIntegrator2D (and other velocity-state models)
        vx, vy = x[..., 2], x[..., 3]
        if preview_time > 0.0:
            vx = vx + preview_time * u[..., 0]
            vy = vy + preview_time * u[..., 1]
    speed = torch.hypot(vx, vy)
    desired = torch.atan2(vy, vx)
    err = angle_normalize(desired - yaw)
    u_att = torch.clamp(kp * err, -spec.w_max, spec.w_max)
    return torch.where(speed < 1e-2, torch.zeros_like(u_att), u_att)
