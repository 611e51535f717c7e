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


def norm2(v):
    """Euclidean norm over a last axis of 2, as ``sqrt(v0*v0 + v1*v1)``: the
    sum that the JAX package's ``jnp.linalg.norm`` of a 2-vector takes."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def linspace(start: float, stop: float, num: int, endpoint: bool = True, *, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """Evenly spaced values, rounded as the JAX package's ``jnp.linspace``
    inside a jitted function (XLA turns the division by ``div`` into a
    product with its reciprocal ``r``): ``start * (1 - i r) + i (stop r)``,
    each operation in ``dtype``, so that both packages hold the same values."""
    div = num - 1 if endpoint else num
    # torch.full, not torch.tensor: no copy from the host.
    start_t = torch.full((), start, dtype=dtype, device=device)
    stop_t = torch.full((), stop, dtype=dtype, device=device)
    if num == 1:
        return start_t[None]
    r = 1.0 / torch.full((), div, dtype=dtype, device=device)
    i = torch.arange(div, dtype=dtype, device=device)
    out = start_t * (1 - i * r) + i * (stop_t * r)
    return torch.cat([out, stop_t[None]]) if endpoint else out


def per_robot(t, batch: int):
    """A set shared by a batch, ``(L, d)``, or one per robot, ``(B, L, d)``,
    as ``(B, L, d)`` (a view, no copy)."""
    return t.expand((batch,) + t.shape[-2:])


def take_rows(x, idx):
    """``x[b, idx[b]]`` for ``x (B, L, ...)`` and ``idx (B,)``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def first_true(mask):
    """Index of the first True on the last axis, 0 where there is none:
    what ``jnp.argmax`` of a boolean array gives (the mask is cast to
    integers first)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


_CONSTANTS: dict = {}
_CONSTANTS_MAX = 256


def device_constant(values, *, device=None, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per values, type and
    device and kept: a later call copies nothing from the host, so that it
    can run inside a CUDA graph capture (the first call must come before).
    The tensor is shared; do not write to it."""
    key = (tuple(values) if isinstance(values, (list, tuple)) else values, dtype,
           torch.device(device) if device is not None else None)
    t = _CONSTANTS.get(key)
    if t is None:
        if len(_CONSTANTS) >= _CONSTANTS_MAX:
            del _CONSTANTS[next(iter(_CONSTANTS))]
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
