"""Rectangular workspace environment.

Port of ``safe_control_tpu/envs/env.py``: boundary strips, the circle and
superellipsoid obstacle lists split by their flag, and the grid helpers of
the occupancy-based perception.  Construction is host NumPy, as in the JAX
package; the controllers consume the padded obstacle rows (``all_obs``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from safe_control_tpu_torch.core.types import OBS_DIM


class Env:
    """Host-side environment container."""

    def __init__(self, width=20.0, height=20.0, known_obs: Sequence = (), resolution=0.1):
        self.width = float(width)
        self.height = float(height)
        self.resolution = float(resolution)
        self.x_range = (0.0, self.width)
        self.y_range = (0.0, self.height)

        known = np.asarray(list(known_obs), dtype=float)
        if known.size == 0:
            known = np.zeros((0, OBS_DIM))
        if known.shape[1] < OBS_DIM:
            known = np.hstack([known, np.zeros((known.shape[0], OBS_DIM - known.shape[1]))])
        self.obs_circle = known[known[:, -1] == 0]
        se = known[known[:, -1] == 1]
        if len(se) and not (se[:, 4] >= 2).all():
            raise ValueError("e should be >= 2 for superellipsoid")
        self.obs_superellipsoid = se
        self.obs_boundary = self._boundary_strips(self.width, self.height)
        self.obs_rectangle = np.zeros((0, 4))

        self.grid_width = int(self.width / self.resolution)
        self.grid_height = int(self.height / self.resolution)

    @staticmethod
    def _boundary_strips(w, h, linewidth=0.05):
        return np.array([
            [0, 0, linewidth, h],
            [0, h, w, linewidth],
            [linewidth, 0, w, linewidth],
            [w, linewidth, linewidth, h],
        ])

    def get_map_shape(self):
        return (self.grid_height, self.grid_width)

    def f_to_grid(self, points):
        return (np.asarray(points) / self.resolution).astype(int)

    def grid_to_f(self, grid_points):
        return np.asarray(grid_points) * self.resolution + self.resolution / 2.0

    @property
    def all_obs(self) -> np.ndarray:
        """(N, 7) combined circle + superellipsoid obstacle rows."""
        return np.vstack([self.obs_circle, self.obs_superellipsoid])
