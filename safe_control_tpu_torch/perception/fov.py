"""Field-of-view sensing: detection, membership, persistent obstacle memory.

Port of ``safe_control_tpu/perception/fov.py``, batched over robots:

- circle-vs-sector intersection with the angular-radius term
- ``detect_unknown_obs_fov``: superellipsoids are circularized on detection
- ``is_in_fov``: point membership
- ``detect_unknown_obs_ray``: detection through the sensing footprint
- a fixed-slot memory of detected obstacles with tolerance-based dedup, so
  that CBF rows persist after an obstacle leaves the field of view

Unknown obstacles come in as a padded ``(K, 7)`` set shared by the batch, or
``(B, K, 7)``; a memory is ``(B, M, 7)`` slots and a ``(B, M)`` valid mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from safe_control_tpu_torch.core.types import (
    OBS_B,
    OBS_FLAG,
    OBS_R,
    angle_normalize,
    dummy_obstacle,
    first_true,
    is_dummy,
    linspace,
    norm2,
    per_robot,
)
from safe_control_tpu_torch.perception import grid as grid_mod


def circle_intersects_fov(robot_pos, robot_yaw, fov_angle, cam_range, center, radius):
    """Whether circles ``(center (..., 2), radius (...))`` meet the FoV
    sector of ``(robot_pos (..., 2), robot_yaw (...))``, elementwise."""
    to_c = center - robot_pos
    dist = norm2(to_c)
    inside = dist <= radius
    too_far = dist - radius > cam_range
    angle_to_c = torch.atan2(to_c[..., 1], to_c[..., 0])
    angle_diff = torch.abs(angle_normalize(angle_to_c - robot_yaw))
    in_cone = angle_diff <= fov_angle / 2
    ang_rad = torch.asin(torch.clamp(radius / torch.clamp_min(dist, 1e-9), 0.0, 1.0))
    in_widened = angle_diff <= fov_angle / 2 + ang_rad
    return inside | (~too_far & (in_cone | in_widened))


def circularize(obs):
    """Superellipsoid rows ``(..., 7)`` become conservative circles."""
    is_se = obs[..., OBS_FLAG] >= 0.5
    r_circ = torch.clamp_min(torch.maximum(obs[..., OBS_R], obs[..., OBS_B]), 0.0)
    zero = torch.zeros_like(r_circ)
    circ = torch.stack([obs[..., 0], obs[..., 1], r_circ, zero, zero, zero, zero], dim=-1)
    return torch.where(is_se[..., None], circ, obs)


def detect_unknown_obs_fov(robot_pos, robot_yaw, unknown_obs, spec):
    """``(obs (B, K, 7) circularized, detected (B, K))`` for robots
    ``(robot_pos (B, 2), robot_yaw (B,))`` and a padded unknown set."""
    obs = per_robot(unknown_obs, robot_pos.shape[0])
    c = circularize(obs)
    hit = circle_intersects_fov(robot_pos[:, None, :], robot_yaw[:, None], spec.fov_angle,
                                spec.cam_range, c[..., :2], c[..., OBS_R])
    return c, hit & ~is_dummy(obs)


def is_in_fov(robot_pos, robot_yaw, point, spec, check_range: bool = False):
    """Point-in-FoV test, elementwise over the leading axes."""
    to_p = point[..., :2] - robot_pos
    angle = torch.atan2(to_p[..., 1], to_p[..., 0])
    diff = torch.abs(angle_normalize(angle - robot_yaw))
    ok = diff <= spec.fov_angle / 2
    if check_range:
        ok = ok & (norm2(to_p) <= spec.cam_range)
    return ok


def detect_unknown_obs_ray(robot_pos, unknown_obs, footprint, gs, obs_margin: float = 0.05,
                           n_boundary: int = 24):
    """Detection through the accumulated sensing footprint, grid-based.

    ``n_boundary`` points on each obstacle's margin-shrunk boundary are
    tested against the robot's footprint; the detected circle is fitted to
    the two visible points of extreme bearing from the robot.  Returns
    ``(obs (B, K, 7) fitted circles, detected (B, K))``.
    """
    B = robot_pos.shape[0]
    obs = per_robot(unknown_obs, B)
    dev, dtype = obs.device, obs.dtype
    angles = linspace(0.0, 2.0 * math.pi, n_boundary, endpoint=False, device=dev, dtype=dtype)
    c = circularize(obs)
    r_eff = torch.clamp_min(c[..., OBS_R] - obs_margin, 1e-3)  # (B, K)
    ring = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # (P, 2)
    pts = c[..., None, :2] + r_eff[..., None, None] * ring  # (B, K, P, 2)
    visible = grid_mod.lookup(footprint, gs, pts)  # (B, K, P)
    any_vis = torch.any(visible, dim=-1) & ~is_dummy(obs)
    to_pts = pts - robot_pos[:, None, None, :]
    bearings = angle_normalize(
        torch.atan2(to_pts[..., 1], to_pts[..., 0])
        - torch.atan2(c[..., 1] - robot_pos[:, None, 1], c[..., 0] - robot_pos[:, None, 0])[..., None]
    )
    inf = torch.full_like(bearings, math.inf)
    lo = torch.argmin(torch.where(visible, bearings, inf), dim=-1)
    hi = torch.argmax(torch.where(visible, bearings, -inf), dim=-1)
    left = torch.gather(pts, 2, lo[..., None, None].expand(B, -1, 1, 2))[..., 0, :]
    right = torch.gather(pts, 2, hi[..., None, None].expand(B, -1, 1, 2))[..., 0, :]
    center = (left + right) / 2.0
    radius = norm2(right - left) / 2.0
    zero = torch.zeros_like(radius)
    fitted = torch.stack([center[..., 0], center[..., 1], radius, zero, zero, zero, zero], dim=-1)
    return torch.where(any_vis[..., None], fitted, obs), any_vis


class ObsMemory(NamedTuple):
    """Fixed-slot persistent memory of detected unknown obstacles."""

    slots: torch.Tensor  # (B, M, 7)
    valid: torch.Tensor  # (B, M) bool


def init_memory(num_slots: int, batch: int, *, device=None, dtype=torch.float32) -> ObsMemory:
    return ObsMemory(
        slots=dummy_obstacle(device=device, dtype=dtype).repeat(batch, num_slots, 1),
        valid=torch.zeros((batch, num_slots), dtype=torch.bool, device=device),
    )


def merge_memory(mem: ObsMemory, detected, detected_mask, merge_tol: float = 1e-3,
                 radius_tol: float = 1e-2) -> ObsMemory:
    """Tolerance-dedup merge of detections ``(B, K, 7)`` / ``(B, K)``.

    The detections are taken one at a time in index order, each robot of the
    batch at once: a detection updates the first matching valid slot, or
    else claims the first free slot (one that an earlier detection of this
    call may have just filled is no longer free).  With the memory full,
    a new detection is dropped.
    """
    slots, valid = mem.slots, mem.valid
    rows = torch.arange(slots.shape[0], device=slots.device)
    for k in range(detected.shape[1]):
        obs, m = detected[:, k], detected_mask[:, k]
        center_d = norm2(slots[..., :2] - obs[:, None, :2])
        radius_d = torch.abs(slots[..., OBS_R] - obs[:, None, OBS_R])
        shape_d = torch.abs(slots[..., OBS_FLAG] - obs[:, None, OBS_FLAG])
        match = valid & (center_d <= merge_tol) & (radius_d <= radius_tol) & (shape_d <= 0.5)
        has_match = torch.any(match, dim=-1)
        idx = torch.where(has_match, first_true(match), first_true(~valid))
        do_write = m & (has_match | torch.any(~valid, dim=-1))
        cur = slots[rows, idx]
        slots = slots.index_put((rows, idx), torch.where(do_write[:, None], obs, cur))
        valid = valid.index_put((rows, idx), valid[rows, idx] | do_write)
    return ObsMemory(slots=slots, valid=valid)
