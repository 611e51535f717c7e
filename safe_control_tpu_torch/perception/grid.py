"""Occupancy-grid sensing footprint and braking-distance safety area.

Port of ``safe_control_tpu/perception/grid.py``, batched.  The sensing
footprint is a fixed-shape boolean grid, OR-updated each step with the
current field-of-view sector; a robot's footprint is ``(nx, ny)`` and a
batch's ``(B, nx, ny)``.  Every function broadcasts over leading axes:
positions are ``(..., 2)``, yaws, speeds and rates ``(...)``, and masks come
out ``(..., nx, ny)``.

- ``fov_mask``: cells inside the current FoV sector (angle window + range)
- ``update_footprint``: OR-in the current FoV mask
- ``safety_area_mask``: a velocity-aligned braking tube for integrators, a
  decelerating-arc rollout for yaw-rate models
- ``is_beyond_footprint``: the 'point_mass' or 'safety_area' coverage test

Coverage is tested on cell centers at grid resolution, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from safe_control_tpu_torch.core.types import angle_normalize, norm2


@dataclasses.dataclass(frozen=True)
class GridSpec:
    width: float
    height: float
    resolution: float = 0.1

    @property
    def nx(self) -> int:
        return int(round(self.width / self.resolution))

    @property
    def ny(self) -> int:
        return int(round(self.height / self.resolution))


def cell_centers(gs: GridSpec, *, device=None, dtype=torch.float32):
    """``(cx, cy)``, each ``(nx, ny)``: the cell centers' coordinates."""
    xs = (torch.arange(gs.nx, device=device, dtype=dtype) + 0.5) * gs.resolution
    ys = (torch.arange(gs.ny, device=device, dtype=dtype) + 0.5) * gs.resolution
    return torch.meshgrid(xs, ys, indexing="ij")


def _offsets(gs: GridSpec, pos):
    """Cell-center offsets from ``pos (..., 2)``: ``(dx, dy)``, ``(..., nx, ny)``."""
    cx, cy = cell_centers(gs, device=pos.device, dtype=pos.dtype)
    return cx - pos[..., 0, None, None], cy - pos[..., 1, None, None]


def empty_footprint(gs: GridSpec, batch: int, *, device=None):
    return torch.zeros((batch, gs.nx, gs.ny), dtype=torch.bool, device=device)


def init_footprint(gs: GridSpec, pos, spec, exploration: bool = False):
    """Initial footprint: a disk of 2x the robot radius around each start
    position; exploration mode buffers it by a further 10x radius."""
    r = 2.0 * spec.radius + (10.0 * spec.radius if exploration else 0.0)
    return disk_mask(gs, pos, r)


def disk_mask(gs: GridSpec, center, radius):
    dx, dy = _offsets(gs, center)
    return dx * dx + dy * dy <= radius**2


def cell_index(gs: GridSpec, p):
    """Clipped cell indices ``(ix, iy)`` of points ``p (..., 2)`` (int64),
    truncating toward zero as the JAX package's int32 cast does."""
    ix = torch.clamp((p[..., 0] / gs.resolution).to(torch.int32), 0, gs.nx - 1)
    iy = torch.clamp((p[..., 1] / gs.resolution).to(torch.int32), 0, gs.ny - 1)
    return ix.long(), iy.long()


def lookup(grid, gs: GridSpec, p):
    """``grid[b, ix, iy]`` at the cells of points ``p (B, ..., 2)``, for a
    per-robot grid ``(B, nx, ny)``."""
    ix, iy = cell_index(gs, p)
    B = grid.shape[0]
    flat = grid.reshape(B, -1)
    idx = (ix * gs.ny + iy).reshape(B, -1)
    return torch.gather(flat, 1, idx).reshape(ix.shape)


def fov_mask(gs: GridSpec, pos, yaw, spec):
    """Cells inside the FoV sector (angle window + camera range) of each
    pose: ``pos (..., 2)``, ``yaw (...)`` -> ``(..., nx, ny)``."""
    dx, dy = _offsets(gs, pos)
    dist2 = dx * dx + dy * dy
    ang = torch.atan2(dy, dx)
    in_cone = torch.abs(angle_normalize(ang - yaw[..., None, None])) <= spec.fov_angle / 2.0
    return (dist2 <= spec.cam_range**2) & in_cone


def update_footprint(footprint, gs: GridSpec, pos, yaw, spec):
    return footprint | fov_mask(gs, pos, yaw, spec)


def segment_tube_mask(gs: GridSpec, p0, p1, radius):
    """Cells within ``radius`` of the segments p0-p1 (``(..., 2)`` each)."""
    cx, cy = cell_centers(gs, device=p0.device, dtype=p0.dtype)
    d = p1 - p0
    len2 = torch.clamp_min(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], 1e-12)
    x0, y0 = p0[..., 0, None, None], p0[..., 1, None, None]
    d0, d1 = d[..., 0, None, None], d[..., 1, None, None]
    t = torch.clamp(((cx - x0) * d0 + (cy - y0) * d1) / len2[..., None, None], 0.0, 1.0)
    ex = cx - (x0 + t * d0)
    ey = cy - (y0 + t * d1)
    return ex * ex + ey * ey <= radius**2


def braking_arc_points(pos, yaw, v, yaw_rate, spec, dt, max_decel, max_ang_decel, n_pts=32):
    """Decelerating-arc rollout for yaw-rate models, a fixed number of
    points with a stop mask: ``(..., n_pts + 1, 2)``, the start first."""
    p, yw = pos, yaw
    pts = [pos]
    sign_rate = torch.sign(yaw_rate)
    for k in range(n_pts):
        t = torch.full_like(v, float(k)) * dt  # k * dt rounded in the state's dtype
        v_c = torch.clamp_min(v - max_decel * t, 0.0)
        om = yaw_rate - sign_rate * max_ang_decel * t
        om = torch.where(torch.sign(om) != sign_rate, torch.zeros_like(om), om)
        yw = yw + om * dt
        step = torch.stack([torch.cos(yw), torch.sin(yw)], dim=-1)
        p_new = p + v_c[..., None] * step * dt
        p = torch.where((v_c > 0.0)[..., None], p_new, p)
        pts.append(p)
    return torch.stack(pts, dim=-2)


def safety_area_mask(gs: GridSpec, pos, yaw, v, yaw_rate, spec, dt, max_decel=1.0,
                     max_ang_decel=1.0, integrator: bool = False, vel=None, n_pts=32):
    """Braking-distance safety area as a grid mask ``(..., nx, ny)``.

    Integrators: a tube of the robot radius along the velocity (the yaw
    where the robot stands still) over the braking distance.  Yaw-rate
    models: the union of the tubes around the segments of the decelerating
    arc, OR-ed one segment at a time.
    """
    if integrator:
        speed = norm2(vel)
        braking = speed**2 / (2.0 * max(max_decel, 1e-6))
        heading = torch.where(
            (speed > 1e-6)[..., None],
            vel / torch.clamp_min(speed, 1e-9)[..., None],
            torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1),
        )
        p1 = pos + braking[..., None] * heading
        return segment_tube_mask(gs, pos, p1, spec.radius)

    pts = braking_arc_points(pos, yaw, v, yaw_rate, spec, dt, max_decel, max_ang_decel, n_pts)
    mask = segment_tube_mask(gs, pts[..., 0, :], pts[..., 1, :], spec.radius)
    for k in range(1, n_pts):
        mask = mask | segment_tube_mask(gs, pts[..., k, :], pts[..., k + 1, :], spec.radius)
    return mask


def is_beyond_footprint(footprint, gs: GridSpec, pos, safety_mask=None):
    """Visibility-violation test, ``(B,)``.

    'point_mass' mode: the robot's cell must be known.  'safety_area' mode
    (pass ``safety_mask``): every safety-area cell must be known.
    """
    if safety_mask is not None:
        return torch.any((safety_mask & ~footprint).flatten(-2), dim=-1)
    return ~lookup(footprint, gs, pos[:, None, :])[:, 0]
