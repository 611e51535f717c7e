"""Geometry and angle helpers (port of ``safe_control_tpu/utils/helpers.py``)."""

from __future__ import annotations

import numpy as np
import torch

from safe_control_tpu_torch.core.types import angle_normalize  # noqa: F401 (re-export)


def fov_edge_points(pos, yaw, fov_angle, cam_range):
    """Left and right FoV boundary points of a robot at ``pos (..., 2)`` with
    heading ``yaw`` (a float or a tensor broadcasting against ``pos[..., 0]``)."""
    yaw = torch.as_tensor(yaw, dtype=pos.dtype, device=pos.device)
    al = yaw - fov_angle / 2.0
    ar = yaw + fov_angle / 2.0
    left = torch.stack([pos[..., 0] + cam_range * torch.cos(al),
                        pos[..., 1] + cam_range * torch.sin(al)], dim=-1)
    right = torch.stack([pos[..., 0] + cam_range * torch.cos(ar),
                         pos[..., 1] + cam_range * torch.sin(ar)], dim=-1)
    return left, right


def rect_to_superellipsoid(obs_rectangle, e, theta):
    """Rectangles ``[ox, oy, w, h]`` -> superellipsoid 7-vectors: a = w/2,
    b = h/2, flag 1 (NumPy)."""
    if e < 2:
        raise ValueError("e should be >= 2 for superellipsoid approximation")
    rows = [[ox, oy, w / 2.0, h / 2.0, e, theta, 1.0]
            for (ox, oy, w, h) in np.asarray(obs_rectangle, dtype=float)]
    return np.array(rows)
