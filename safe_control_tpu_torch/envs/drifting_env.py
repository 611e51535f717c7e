"""Drifting environment: tracks, lanes, friction puddles and obstacle cars.

Port of ``safe_control_tpu/envs/drifting_env.py``.  The track geometry is
made on the host with NumPy (straight, oval and L-shaped tracks; lane
centres of a straight multi-lane track); the centreline and its normals live
on the device, and every query is a function of position tensors
``(..., 2)``: the centreline-distance boundary collision, the signed lateral
offset, the friction puddles (the first active puddle that holds the point
wins) and the static or constant-velocity obstacle cars.  Puddles and cars
sit in fixed slots (radius 0 marks an empty slot) and stay host-side arrays
until a query asks for them.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_PUDDLES = 8
MAX_OBSTACLE_CARS = 8


class DriftingEnv:
    """Host-side container with the device-side queries of a drift track.

    ``device``: where the centreline and the query results live (the card
    unless ``"cpu"`` is asked for).
    """

    def __init__(self, track_type="straight", track_width=8.0, track_length=100.0,
                 num_lanes=1, *, device="cuda"):
        self.device = torch.device(device)
        self.track_type = track_type
        self.track_width = float(track_width)
        self.track_length = float(track_length)
        self.num_lanes = int(num_lanes)
        self.lane_width = track_width / num_lanes if num_lanes > 1 else track_width

        if track_type == "straight":
            n = 100
            x = np.linspace(0, track_length, n)
            y = np.zeros(n)
        elif track_type == "oval":
            n = 200
            a, b = track_length / 2, track_length / 2.5
            t = np.linspace(0, 2 * np.pi, n)
            x = a * np.cos(t) + a
            y = b * np.sin(t)
        elif track_type == "l_shape":
            seg1, seg2 = track_length * 0.6, track_length * 0.4
            cr = track_width
            x1 = np.linspace(0, seg1, 60)
            y1 = np.zeros(60)
            th = np.linspace(-np.pi / 2, 0, 20)
            xc = seg1 + cr + cr * np.cos(th)
            yc = cr + cr * np.sin(th)
            x2 = np.full(40, seg1 + cr)
            y2 = np.linspace(cr, cr + seg2, 40)
            x = np.concatenate([x1, xc, x2])
            y = np.concatenate([y1, yc, y2])
        else:
            raise ValueError(f"Unknown track type: {track_type}")

        self.centerline_np = np.column_stack([x, y])
        dx, dy = np.gradient(x), np.gradient(y)
        ln = np.sqrt(dx**2 + dy**2)
        nx, ny = -dy / ln, dx / ln
        hw = track_width / 2
        self.left_boundary_np = np.column_stack([x + hw * nx, y + hw * ny])
        self.right_boundary_np = np.column_stack([x - hw * nx, y - hw * ny])
        self.normals_np = np.column_stack([nx, ny])

        if num_lanes > 1 and track_type == "straight":
            self.lane_centers = [hw - (i + 0.5) * self.lane_width for i in range(num_lanes)]
        else:
            self.lane_centers = [0.0]

        self.centerline = torch.as_tensor(self.centerline_np, dtype=torch.float32,
                                          device=self.device)
        self.normals = torch.as_tensor(self.normals_np, dtype=torch.float32, device=self.device)

        # Fixed slots: puddles [x, y, radius, friction], cars [x, y, theta, vx, vy, radius].
        self._puddles = np.zeros((MAX_PUDDLES, 4))
        self._n_puddles = 0
        self._cars = np.zeros((MAX_OBSTACLE_CARS, 6))
        self._n_cars = 0

    # ----------------------------------------------------------- mutation
    def add_puddle(self, x, y, radius, friction=0.3):
        self._puddles[self._n_puddles] = [x, y, radius, friction]
        self._n_puddles += 1

    def add_obstacle_car(self, x, y, theta, radius=1.2):
        self._cars[self._n_cars] = [x, y, theta, 0.0, 0.0, radius]
        self._n_cars += 1
        return self._n_cars - 1

    def add_dynamic_obstacle_car(self, x, y, theta, vx, vy, radius=1.2):
        self._cars[self._n_cars] = [x, y, theta, vx, vy, radius]
        self._n_cars += 1
        return self._n_cars - 1

    def get_lane_center(self, lane_idx):
        return self.lane_centers[lane_idx]

    def get_middle_lane_idx(self):
        return self.num_lanes // 2

    @property
    def puddles(self):
        return torch.as_tensor(self._puddles, dtype=torch.float32, device=self.device)

    @property
    def obstacle_cars(self):
        return torch.as_tensor(self._cars, dtype=torch.float32, device=self.device)

    @property
    def obstacle_cars_np(self):
        """The obstacle-car slots as a float32 host array (no device copy)."""
        return self._cars.astype(np.float32)

    # ------------------------------------------------------------ queries
    def _nearest_d2(self, position):
        d = self.centerline.to(position.dtype) - position[..., None, :2]
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]  # (..., P)

    def check_collision(self, position, robot_radius=0.0):
        """Centreline-distance boundary collision of ``position (..., 2)``."""
        dist = torch.sqrt(self._nearest_d2(position).amin(-1))
        return dist + robot_radius > self.track_width / 2.0

    def signed_lateral_offset(self, position):
        """Signed distance from the centreline along the track normal."""
        idx = torch.argmin(self._nearest_d2(position), dim=-1)
        rel = position[..., :2] - self.centerline[idx]
        nrm = self.normals[idx]
        return rel[..., 0] * nrm[..., 0] + rel[..., 1] * nrm[..., 1]

    def get_friction_at_position(self, position, default_friction=1.0):
        """Puddle friction at ``position (..., 2)`` (a tensor on any device):
        the lowest friction of the active puddles that hold it, else the
        default."""
        p = torch.as_tensor(self._puddles, dtype=position.dtype, device=position.device)
        dx = position[..., 0, None] - p[:, 0]
        dy = position[..., 1, None] - p[:, 1]
        d = torch.sqrt(dx * dx + dy * dy)
        inside = (d <= p[:, 2]) & (p[:, 2] > 0)
        mu = torch.where(inside, p[:, 3], torch.full_like(d, float("inf"))).amin(-1)
        return torch.where(torch.isfinite(mu), mu, torch.full_like(mu, default_friction))

    def obstacle_car_states(self, t=0.0):
        """(M, 6) obstacle-car rows predicted at time t (constant velocity)."""
        c = self.obstacle_cars
        return torch.cat([c[:, :2] + c[:, 3:5] * t, c[:, 2:]], dim=-1)

    def check_obstacle_collision(self, position, robot_radius=0.0, t=0.0):
        c = self.obstacle_car_states(t)
        dx = position[..., 0, None] - c[:, 0]
        dy = position[..., 1, None] - c[:, 1]
        d = torch.sqrt(dx * dx + dy * dy)
        return torch.any((d < robot_radius + c[:, 5]) & (c[:, 5] > 0), dim=-1)

    def step_dynamic_obstacles(self, dt):
        """Host-side advance of the obstacle cars."""
        self._cars[:, 0] += self._cars[:, 3] * dt
        self._cars[:, 1] += self._cars[:, 4] * dt
