"""Visibility-promoting yaw controllers over the occupancy-grid footprint.

Port of ``safe_control_tpu/attitude/visibility.py``, batched over robots:

- ``visibility_area_yaw``: scores 36 candidate yaws by the unexplored cells
  inside each candidate FoV sector and P-controls to the argmax;
- ``visibility_raycast_yaw``: casts 36 rays and scores each direction by
  boundary distance, potential new FoV area and ray escape (weights
  0.3 / 0.5 / 0.2), with a 0.3 angular-distance penalty.

The candidate scores of a batch are one broadcast over ``(B, n_yaw)``
cells (``sector_counts``).  Ties go to the first candidate, as
``jnp.argmax`` gives them.
"""

from __future__ import annotations

import math

import torch

from safe_control_tpu_torch.core.types import angle_normalize, first_true, linspace
from safe_control_tpu_torch.perception import grid as grid_mod


def candidate_yaws(n: int, *, device=None, dtype=torch.float32):
    return linspace(-math.pi, math.pi, n, endpoint=False, device=device, dtype=dtype)


def sector_counts(footprint, gs: grid_mod.GridSpec, pos, yaws, spec):
    """Cells of each candidate FoV sector, and the unexplored ones among them.

    ``footprint (B, nx, ny)``, ``pos (B, P, 2)`` positions, ``yaws (Y,)``
    candidates; returns two ``(B, P, Y)`` counts.  Only the window of cells
    within camera range of a position can lie in its sectors, so each
    position tests that window (its cell centers computed as
    ``grid.cell_centers`` computes them): the range test and the bearing of
    every cell once, and the Y cones broadcast against them.  The P
    positions go one at a time.
    """
    B = pos.shape[0]
    dev, dtype = pos.device, pos.dtype
    h = int(math.ceil(spec.cam_range / gs.resolution)) + 1
    offs = torch.arange(-h, h + 1, device=dev)
    rows = torch.arange(B, device=dev)[:, None, None]
    half = spec.fov_angle / 2.0
    n_sector, n_new = [], []
    for p in range(pos.shape[1]):
        px, py = pos[:, p, 0], pos[:, p, 1]
        ix = torch.floor(px / gs.resolution).long()[:, None] + offs  # (B, w)
        iy = torch.floor(py / gs.resolution).long()[:, None] + offs
        dx = ((ix.to(dtype) + 0.5) * gs.resolution - px[:, None])[:, :, None]  # (B, w, 1)
        dy = ((iy.to(dtype) + 0.5) * gs.resolution - py[:, None])[:, None, :]  # (B, 1, w)
        on_grid = (((ix >= 0) & (ix < gs.nx))[:, :, None]
                   & ((iy >= 0) & (iy < gs.ny))[:, None, :])
        in_range = (dx * dx + dy * dy <= spec.cam_range**2) & on_grid  # (B, w, w)
        ang = torch.atan2(dy, dx)
        in_cone = torch.abs(angle_normalize(ang[:, None] - yaws[None, :, None, None])) <= half
        sector = in_range[:, None] & in_cone  # (B, Y, w, w)
        known = footprint[rows, ix.clamp(0, gs.nx - 1)[:, :, None],
                          iy.clamp(0, gs.ny - 1)[:, None, :]]
        n_sector.append(sector.sum((-2, -1)))
        n_new.append((sector & ~known[:, None]).sum((-2, -1)))
    return torch.stack(n_sector, dim=1), torch.stack(n_new, dim=1)


def visibility_area_yaw(footprint, gs: grid_mod.GridSpec, pos, current_yaw, spec,
                        kp: float = 1.5, n_yaw_samples: int = 36):
    """Yaw rates ``(B,)`` toward the candidate yaw that sees the most
    unexplored cells; an empty map rotates at the maximum rate."""
    yaws = candidate_yaws(n_yaw_samples, device=pos.device, dtype=pos.dtype)
    _, scores = sector_counts(footprint, gs, pos[:, None], yaws, spec)
    target = yaws[torch.argmax(scores[:, 0], dim=-1)]
    err = angle_normalize(target - current_yaw)
    w = torch.clamp(kp * err, -spec.w_max, spec.w_max)
    return torch.where(footprint.flatten(1).any(-1), w, torch.full_like(w, spec.w_max))


def visibility_raycast_yaw(footprint, gs: grid_mod.GridSpec, pos, current_yaw, spec,
                           kp: float = 1.5, num_rays: int = 36, max_ray_length: float = 10.0,
                           n_ray_samples: int = 32):
    """Ray-cast exploration yaw rates ``(B,)``.

    Per ray: boundary distance = the distance to the first sample outside
    the footprint; potential area = the unexplored share of the candidate
    FoV sector; ray score = 1.0 if fully outside the map, 0.8 if extending
    well beyond, 0.2 otherwise.  Combined 0.3/0.5/0.2, then the 0.3 angular
    penalty.
    """
    dev, dtype = pos.device, pos.dtype
    yaws = candidate_yaws(num_rays, device=dev, dtype=dtype)  # (Y,)
    reach = linspace(0.05, 1.0, n_ray_samples, device=dev, dtype=dtype) * max_ray_length  # (S,)
    d = torch.stack([torch.cos(yaws), torch.sin(yaws)], dim=-1)  # (Y, 2)
    pts = pos[:, None, None, :] + reach[None, None, :, None] * d[None, :, None, :]  # (B, Y, S, 2)
    inside = grid_mod.lookup(footprint, gs, pts)  # (B, Y, S)
    outside = ~inside
    boundary_dist = torch.where(
        outside.any(-1), reach[first_true(outside)],
        torch.full(outside.shape[:-1], max_ray_length, dtype=dtype, device=dev))
    frac_in = inside.to(dtype).mean(-1)
    ray_score = torch.where(frac_in <= 0.0, 1.0, torch.where(frac_in < 0.8, 0.8, 0.2)).to(dtype)
    n_sector, n_new = sector_counts(footprint, gs, pos[:, None], yaws, spec)
    potential = n_new[:, 0] / torch.clamp_min(n_sector[:, 0], 1)
    scores = 0.3 / (boundary_dist + 0.1) + 0.5 * potential + 0.2 * ray_score
    penalty = torch.abs(angle_normalize(yaws - current_yaw[:, None])) / math.pi
    combined = scores * (1.0 - 0.3 * penalty)
    target = yaws[torch.argmax(combined, dim=-1)]
    err = angle_normalize(target - current_yaw)
    w = torch.clamp(kp * err, -spec.w_max, spec.w_max)
    return torch.where(footprint.flatten(1).any(-1), w, torch.full_like(w, spec.w_max))
