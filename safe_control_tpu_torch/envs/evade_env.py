"""Evade environment: a hallway, a safe pocket, a goal and a "bullet" obstacle.

Port of ``safe_control_tpu/envs/evade_env.py``: the geometry is a frozen
config and every query is a function of position tensors ``(..., 2)``, so
that the gatekeeper can evaluate many candidate states in one batch: the
boundary collision with the pocket cut out, the rectangle-vs-circle bullet
collision with the nose extension, the respawning constant-velocity bullet
and the goal / pocket membership.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EvadeEnv:
    hallway_length: float = 50.0
    hallway_width: float = 4.0
    pocket_x: float = 20.0
    pocket_length: float = 10.0
    pocket_width: float = 4.0
    goal_length: float = 5.0
    bullet_speed: float = 3.0
    bullet_width: float = 4.0
    bullet_length: float = 3.0
    bullet_start_x: float = -3.0

    @property
    def half_width(self):
        return self.hallway_width / 2.0

    @property
    def pocket_x_min(self):
        return self.pocket_x

    @property
    def pocket_x_max(self):
        return self.pocket_x + self.pocket_length

    @property
    def pocket_y_min(self):
        return self.half_width

    @property
    def pocket_y_max(self):
        return self.half_width + self.pocket_width

    @property
    def pocket_center(self):
        return ((self.pocket_x_min + self.pocket_x_max) / 2.0,
                (self.pocket_y_min + self.pocket_y_max) / 2.0)

    @property
    def goal_x_min(self):
        return self.hallway_length - self.goal_length

    @property
    def goal_x_max(self):
        return self.hallway_length

    def check_collision(self, position, robot_radius=0.0):
        """Boundary collision with the pocket cut out of the top wall."""
        x, y = position[..., 0], position[..., 1]
        r = robot_radius
        bottom = y - r < -self.half_width
        left = x - r < 0.0
        right = x + r > self.hallway_length
        above_top = y + r > self.half_width
        in_pocket_x = (x >= self.pocket_x_min) & (x <= self.pocket_x_max)
        pocket_top = y + r > self.pocket_y_max
        pocket_left = (x - r < self.pocket_x_min) & (y > self.half_width)
        pocket_right = (x + r > self.pocket_x_max) & (y > self.half_width)
        top_hit = torch.where(in_pocket_x, pocket_top | pocket_left | pocket_right,
                              torch.ones_like(in_pocket_x))
        return bottom | (above_top & top_hit) | left | right

    def bullet_x_at(self, t, x0=None):
        """The bullet's x at time ``t`` (a tensor), wrapped at respawn."""
        x0 = self.bullet_start_x if x0 is None else x0
        travel = self.hallway_length + self.bullet_length - self.bullet_start_x
        return (torch.remainder(x0 - self.bullet_start_x + self.bullet_speed * t, travel)
                + self.bullet_start_x)

    def check_bullet_collision(self, position, robot_radius, bullet_x):
        """Rectangle (with the nose extension) against the robot's circle."""
        x, y = position[..., 0], position[..., 1]
        bullet_x = torch.as_tensor(bullet_x, dtype=x.dtype, device=x.device)
        bx_min = bullet_x - self.bullet_length / 2.0
        bx_max = bullet_x + self.bullet_length / 2.0 + self.bullet_length / 3.0
        cx = torch.minimum(torch.maximum(x, bx_min), bx_max)
        cy = torch.clamp(y, -self.bullet_width / 2.0, self.bullet_width / 2.0)
        return torch.sqrt((x - cx) * (x - cx) + (y - cy) * (y - cy)) < robot_radius

    def check_goal_reached(self, position):
        x, y = position[..., 0], position[..., 1]
        return ((x >= self.goal_x_min) & (x <= self.goal_x_max) & (y >= -self.half_width)
                & (y <= self.half_width))

    def is_in_safe_pocket(self, position, margin=0.0):
        x, y = position[..., 0], position[..., 1]
        return ((x >= self.pocket_x_min + margin) & (x <= self.pocket_x_max - margin)
                & (y >= self.pocket_y_min + margin) & (y <= self.pocket_y_max - margin))
