"""Warehouse environment: a 100 x 100 world, static obstacles and "ghosts".

Port of ``safe_control_tpu/envs/warehouse_env.py``: a 4 x 4 grid of circular
static obstacles, leveled moving "ghost" obstacles (the tables of levels 1-7,
with the sequential reshuffle of levels 6-7, exactly as the JAX package has
them), the start (10, 10), the goal (90, 90) and the zig-zag nominal
waypoints.

The ghosts live on the host as a float64 ``(MAX_GHOSTS, 5)`` NumPy array
``[x, y, vx, vy, radius]`` (radius 0 marks an empty slot) and ``step``
advances them there, reflecting a position that crosses the [2, 98] bounce
band (so a ghost's path is exactly ``fold_position(x0 + v t)`` at the sample
times).  ``ghosts`` hands the current table to the device as float32, and
the collision checks are functions of position tensors ``(..., 2)``.
``safe_spots`` runs once per level.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_GHOSTS = 32
GHOST_RADIUS = 2.0
OBS_RADIUS = 7.0
BOUNCE_LO = 2.0
BOUNCE_HI = 98.0


def fold_position(z, lo=BOUNCE_LO, hi=BOUNCE_HI):
    """Triangle-wave fold of an unbounded coordinate tensor into the bounce
    band: the exact path of a position-reflecting ghost.  ``torch.remainder``
    is the floored modulo of ``jnp.mod`` (its argument goes negative)."""
    w = hi - lo
    m = torch.remainder(z - lo, 2.0 * w)
    return lo + (w - torch.abs(w - m))


def _ghost_table(level) -> list:
    """The ghost rows ``[x, y, vx, vy, radius]`` of a level ("hero" is level
    3).  In the level-6/7 reshuffle each ghost passes through every rule in
    order, so an earlier rewrite can trigger a later rule on the same ghost."""
    s = str(level).lower()
    lvl = 3 if s == "hero" else int(level)
    g = []

    def add(x, y, vx, vy):
        g.append([x, y, vx, vy, GHOST_RADIUS])

    if lvl == 0:
        return g
    if lvl == 1:
        add(95, 50, -4.0, 0.0)
        add(50, 5, 0.0, 4.0)
        add(5, 70, 4.0, 0.0)
        return g
    if lvl == 2:
        add(95, 50, -4.0, 0.0)
        add(50, 5, 0.0, 4.0)
        add(5, 70, 2.5, 0.0)
        add(30, 95, 0.0, -4.0)
        add(90, 90, -2.0, -2.0)
        return g

    # Hero layouts, lvl >= 3.
    speed = {3: 2.5, 4: 3.0, 5: 3.0, 6: 2.7}.get(lvl, 2.6)
    num_extra = {3: 0, 4: 3, 5: 6, 6: 10}.get(lvl, 0)
    # the main 11
    add(95, 50, -speed, 0.0)
    add(50, 5, 0.0, speed)
    add(5, 70, speed, 0.0)
    add(30, 95, 0.0, -speed)
    add(90, 90, -speed * 0.7, -speed * 0.7)
    add(95, 10, -speed, 0.0)
    add(5, 30, speed, 0.0)
    add(95, 90, -speed, 0.0)
    add(10, 95, 0.0, -speed)
    add(70, 5, 0.0, speed)
    add(90, 95, 0.0, -speed)
    if num_extra >= 3:  # level 4
        add(20, 20, 1.5, 1.5)
        add(80, 80, -1.5, -1.5)
        add(20, 80, speed, -speed)
    if num_extra >= 6:  # level 5
        add(80, 20, -speed, speed)
        add(5, 40, speed * 0.8, 0.0)
        add(95, 60, -speed * 0.8, 0.0)
    if lvl in (3, 4, 5):  # the y=70 sweeper slowed down
        tgt = 1.5 if lvl == 3 else 2.5
        for row in g:
            if abs(row[1] - 70.0) < 1e-6 and abs(row[3]) < 1e-9:
                row[2] = tgt if row[2] > 0 else -tgt
    if lvl in (4, 5):  # the slow blockers shifted off the diagonal
        for row in g:
            if abs(row[0] - 20.0) < 1e-6 and abs(row[1] - 20.0) < 1e-6:
                row[1], row[3] = 15.0, 0.0
            if abs(row[0] - 80.0) < 1e-6 and abs(row[1] - 80.0) < 1e-6:
                row[1], row[3] = 85.0, 0.0
    if num_extra >= 10:  # level 6, "super dense"
        add(5, 15, speed * 0.9, 0.0)
        add(95, 80, -speed * 0.9, 0.0)
        add(20, 95, 0.0, -speed * 0.9)
        add(80, 5, 0.0, speed * 0.9)
        add(15, 85, speed * 0.7, -speed * 0.7)
        add(85, 15, -speed * 0.7, speed * 0.7)
        add(35, 5, 0.0, speed * 0.9)
        add(75, 95, 0.0, -speed * 0.9)
        add(95, 30, -speed * 0.9, 0.0)
        add(5, 65, speed * 0.9, 0.0)
        add(50, 10, 0.0, speed * 0.45)
    if lvl >= 7:  # cross-flow
        fs = speed * 0.8
        for y in (44.0, 58.0, 72.0, 86.0):
            add(5, y, fs, 0.0)
        for x in (44.0, 58.0, 72.0, 86.0):
            add(x, 5, 0.0, fs)
        add(5, 54, fs, -fs * 0.4)
        add(54, 5, -fs * 0.4, fs)
        add(40, 5, 0.0, fs * 1.1)
        add(6, 40, fs * 1.1, 0.0)
        add(95, 34, -fs * 1.1, 0.0)
        add(95, 30, -speed, 0.0)
        add(66, 80, 0.0, -fs * 1.2)
        add(66, 60, 0.0, fs * 1.2)
        add(20, 70, speed * 1.02, 0.0)
    if lvl >= 6:  # the sequential reshuffle
        for row in g:
            if abs(row[0] - 5.0) < 1e-6 and abs(row[1] - 30.0) < 1e-6:
                row[1] = 25.0
            if abs(row[0] - 20.0) < 1e-6 and abs(row[1] - 20.0) < 1e-6:
                row[0], row[1], row[3] = 45.0, 25.0, 0.0
            if abs(row[0] - 50.0) < 1e-6 and abs(row[1] - 5.0) < 1e-6:
                row[0] = 95.0
            if abs(row[0] - 70.0) < 1e-6 and abs(row[1] - 5.0) < 1e-6:
                row[0] = 25.0
            if abs(row[1] - 50.0) < 1e-6 and abs(row[3]) < 1e-9 and row[2] < 0:
                row[1] = 55.0
            if abs(row[0] - 80.0) < 1e-6 and abs(row[1] - 80.0) < 1e-6:
                row[1], row[3] = 85.0, 0.0
            for y_relief in (15.0, 25.0, 40.0, 65.0, 70.0):
                if abs(row[0] - 5.0) < 1e-6 and abs(row[1] - y_relief) < 1e-6:
                    row[0], row[2] = 95.0, -abs(row[2])
    return g


def _reflect(pos, vel):
    """Reflect positions ``(G, 2)`` that left the bounce band back into it
    and flip those velocity components, in place."""
    for dim in (0, 1):
        over = pos[:, dim] > BOUNCE_HI
        under = pos[:, dim] < BOUNCE_LO
        pos[over, dim] = 2.0 * BOUNCE_HI - pos[over, dim]
        pos[under, dim] = 2.0 * BOUNCE_LO - pos[under, dim]
        vel[over | under, dim] *= -1


class WarehouseEnv:
    """The leveled warehouse.  ``device``: where ``ghosts`` and the
    collision checks' constants live (the card unless ``"cpu"`` is asked
    for)."""

    def __init__(self, level=1, dt=0.05, *, device="cuda"):
        self.device = torch.device(device)
        self.level = level
        self.dt = dt
        self.width = 100.0
        self.height = 100.0
        self.obs_radius = OBS_RADIUS
        static = [[x, y, OBS_RADIUS] for x in (20, 40, 60, 80) for y in (20, 40, 60, 80)]
        self.static_obstacles = np.array(static, dtype=float)
        self.start_pos = np.array([10.0, 10.0])
        self.goal_pos = np.array([90.0, 90.0])
        self.goal_radius = 5.0
        self.reset()

    def reset(self):
        rows = _ghost_table(self.level)
        ghosts = np.zeros((MAX_GHOSTS, 5))
        for i, r in enumerate(rows):
            ghosts[i] = r
        self._ghosts = ghosts

    @property
    def ghosts_np(self) -> np.ndarray:
        """The current ghost table as float32 on the host."""
        return self._ghosts.astype(np.float32)

    @property
    def ghosts(self) -> torch.Tensor:
        """The current ``(MAX_GHOSTS, 5)`` ghost table, float32, on the device."""
        return torch.as_tensor(self.ghosts_np, device=self.device)

    @property
    def static_obs7(self):
        """Static obstacles as 7-vector rows for a controller."""
        s = self.static_obstacles
        return np.hstack([s, np.zeros((len(s), 4))])

    def step(self):
        """Advance the ghosts one ``dt``; a position that crosses the band is
        reflected (one reflection a step is exact: |v| dt << the band)."""
        g = self._ghosts
        pos, vel = g[:, 0:2], g[:, 2:4]
        for dim in (0, 1):
            g[:, dim] += g[:, dim + 2] * self.dt
        _reflect(pos, vel)

    def safe_spots(self, robot_radius=0.8, margin=0.7, grid_step=2.0, sim_seconds=240.0):
        """``(S, 2)`` parking points (NumPy) that no ghost's bouncing path
        comes within ``radius + robot_radius + margin`` of, and that clear the
        static obstacles by ``robot_radius + 0.2``.

        The ghosts are simulated for ``sim_seconds`` with ``step``'s bounce
        on the host; the distances of the candidates to every sampled
        position are taken on the env's device in float64, a block of sample
        times at once (each a square root of a sum of squares, as NumPy's
        norm rounds it: the same spots as the JAX package)."""
        g = self._ghosts
        act = g[g[:, 4] > 0]
        xs = np.arange(3.0, self.width - 2.0, grid_step)
        ys = np.arange(3.0, self.height - 2.0, grid_step)
        cand = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
        keep = np.ones(len(cand), dtype=bool)
        for sx, sy, sr in self.static_obstacles:
            keep &= np.linalg.norm(cand - np.array([sx, sy]), axis=1) > sr + robot_radius + 0.2
        if len(act):
            n_steps = int(sim_seconds / self.dt)
            pos = act[:, :2].copy()
            vel = act[:, 2:4].copy()
            path = np.empty((n_steps,) + pos.shape)
            for k in range(n_steps):
                pos += vel * self.dt
                _reflect(pos, vel)
                path[k] = pos
            f64 = dict(dtype=torch.float64, device=self.device)
            c = torch.as_tensor(cand, **f64)
            path = torch.as_tensor(path, **f64)
            clearance = torch.as_tensor(act[:, 4] + robot_radius + margin, **f64)  # (G,)
            min_d = torch.full((len(cand),), float("inf"), **f64)
            for k0 in range(0, n_steps, 200):
                p = path[k0:k0 + 200]
                dx = c[:, None, None, 0] - p[None, :, :, 0]
                dy = c[:, None, None, 1] - p[None, :, :, 1]
                d = torch.sqrt(dx * dx + dy * dy) - clearance
                min_d = torch.minimum(min_d, d.amin(dim=(1, 2)))
            keep &= (min_d > 0.0).cpu().numpy()
        return cand[keep]

    def ghost_states(self, t=0.0):
        """(G, 5) constant-velocity ghost prediction at time t (no bounce)."""
        g = self.ghosts
        return torch.cat([g[:, :2] + g[:, 2:4] * t, g[:, 2:]], dim=1)

    def check_boundary_collision(self, position, robot_radius=0.0):
        x, y = position[..., 0], position[..., 1]
        return ((x - robot_radius < 0) | (x + robot_radius > self.width)
                | (y - robot_radius < 0) | (y + robot_radius > self.height))

    def check_static_collision(self, position, robot_radius=0.0):
        s = torch.as_tensor(self.static_obstacles, dtype=torch.float32, device=self.device)
        d = torch.sqrt((position[..., 0, None] - s[:, 0]) ** 2
                       + (position[..., 1, None] - s[:, 1]) ** 2)
        return torch.any(d < robot_radius + s[:, 2], dim=-1)

    def check_ghost_collision(self, position, robot_radius=0.0, t=0.0):
        g = self.ghost_states(t)
        d = torch.sqrt((position[..., 0, None] - g[:, 0]) ** 2
                       + (position[..., 1, None] - g[:, 1]) ** 2)
        return torch.any((d < robot_radius + g[:, 4]) & (g[:, 4] > 0), dim=-1)

    def check_goal_reached(self, position):
        goal = torch.as_tensor(self.goal_pos, dtype=torch.float32, device=position.device)
        d = position[..., :2] - goal
        return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) < self.goal_radius

    @staticmethod
    def get_nominal_waypoints():
        """The diagonal zig-zag path."""
        return np.array([
            (10, 10),
            (30, 10), (30, 30),
            (50, 30), (50, 50),
            (70, 50), (70, 70),
            (90, 70), (90, 90),
        ], dtype=float)
