"""Core tensor types and helpers (port of ``safe_control_tpu/core/types.py``).

Obstacles use the 7-vector encoding ``[ox, oy, r_or_a, b_or_vx, e_or_vy,
theta, flag]`` with flag 0 = circle (cols 3:5 double as vx, vy for dynamic
obstacles) and flag 1 = superellipsoid (a, b, e, theta).  Every obstacle set
is a fixed-size ``(K, 7)`` tensor padded with dummy obstacles far away at
(1000, 1000).
"""

from __future__ import annotations

import math

import torch

OBS_DIM = 7
DUMMY_OBS_POS = 1000.0

# Obstacle column indices.
OBS_X, OBS_Y, OBS_R, OBS_B, OBS_E, OBS_THETA, OBS_FLAG = range(7)
# Dynamic-obstacle aliases (circle obstacles reuse cols 3:5 as velocity).
OBS_VX, OBS_VY = 3, 4

FLAG_CIRCLE = 0.0
FLAG_SUPERELLIPSOID = 1.0


def dummy_obstacle(*, device=None, dtype=torch.float32) -> torch.Tensor:
    """A single far-away dummy obstacle row."""
    return torch.tensor(
        [DUMMY_OBS_POS, DUMMY_OBS_POS, 0, 0, 0, 0, 0], dtype=dtype, device=device
    )


def pad_obstacles(obs, num_obs: int, *, device=None, dtype=torch.float32) -> torch.Tensor:
    """Pad/truncate an ``(n, <=7)`` obstacle array to fixed shape ``(num_obs, 7)``.

    Rows with fewer than 7 columns are zero-extended, missing rows become
    dummy obstacles at (1000, 1000).
    """
    obs = torch.as_tensor(obs, dtype=dtype, device=device)
    if obs.numel() == 0:
        obs = torch.zeros((0, OBS_DIM), dtype=dtype, device=device)
    if obs.ndim == 1:
        obs = obs[None, :]
    n, d = obs.shape
    if d < OBS_DIM:
        obs = torch.cat(
            [obs, torch.zeros((n, OBS_DIM - d), dtype=dtype, device=device)], dim=1
        )
    elif d > OBS_DIM:
        obs = obs[:, :OBS_DIM]
    if n >= num_obs:
        return obs[:num_obs]
    pad = dummy_obstacle(device=device, dtype=dtype).expand(num_obs - n, OBS_DIM)
    return torch.cat([obs, pad], dim=0)


def is_dummy(obs: torch.Tensor) -> torch.Tensor:
    """Boolean mask of padded dummy rows for a ``(..., 7)`` obstacle tensor."""
    return obs[..., OBS_X] >= DUMMY_OBS_POS - 1.0


def angle_normalize(x):
    """Wrap angle(s) into [-pi, pi).

    ``torch.remainder`` has the floor semantics of ``jnp.mod`` for negative
    angles; ``torch.fmod`` would not.
    """
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi
