"""The two models of the benchmarked configurations, batched over leading
axes, each operation in the order of the configurations' published
dynamics: DynamicUnicycle2D (X = [x, y, theta, v], U = [a, omega],
relative degree 2) and KinematicBicycle2D under the dynamic parabolic CBF
(X = [x, y, theta, v], U = [a, beta], relative degree 1)."""

from __future__ import annotations

import math

import torch

from portbench.reference.geometry import OBS_R, angle_normalize, h_point, norm2


class DynamicUnicycle2D:
    n, m, rel_deg = 4, 2, 2

    def __init__(self, spec):
        self.spec = spec

    def f(self, x):
        zero = torch.zeros_like(x[..., 0])
        return torch.stack([x[..., 3] * torch.cos(x[..., 2]), x[..., 3] * torch.sin(x[..., 2]),
                            zero, zero], dim=-1)

    def step(self, x, u, dt):
        g = torch.tensor(((0.0, 0.0), (0.0, 0.0), (0.0, 1.0), (1.0, 0.0)), dtype=x.dtype,
                         device=x.device).expand(x.shape[:-1] + (4, 2))
        gu = (g * u[..., None, :]).sum(-1)
        x = x + (self.f(x) + gu) * dt
        return torch.cat([x[..., :2], angle_normalize(x[..., 2:3]), x[..., 3:]], dim=-1)

    def nominal_input(self, x, goal, d_min=0.05):
        s = self.spec
        distance = torch.clamp_min(
            torch.linalg.vector_norm(x[..., :2] - goal[..., :2], dim=-1) - d_min, 0.0)
        theta_d = torch.atan2(goal[..., 1] - x[..., 1], goal[..., 0] - x[..., 0])
        err = angle_normalize(theta_d - x[..., 2])
        omega = s.nominal_k_omega * err
        v = torch.where(torch.abs(err) > math.radians(90.0), torch.zeros_like(err),
                        torch.clamp_max(s.nominal_k_v * distance * torch.cos(err), s.v_max))
        return torch.stack([s.nominal_k_a * (v - x[..., 3]), omega], dim=-1)

    def stop(self, x):
        return torch.stack([self.spec.nominal_k_a * (0.0 - x[..., 3]),
                            torch.zeros_like(x[..., 3])], dim=-1)

    def rotate_to(self, x, theta_des, k_omega=2.0):
        err = angle_normalize(theta_des - x[..., 2])
        return torch.stack([torch.zeros_like(err), k_omega * err], dim=-1)

    def has_stopped(self, x, tol=0.05):
        return torch.abs(x[..., 3]) < tol

    def u_box(self):
        s = self.spec
        return [-s.a_max, -s.w_max], [s.a_max, s.w_max]

    def bounded_states(self):
        """(index, lower, upper) of the state rows the MPC bounds."""
        return ((3, -self.spec.v_max, self.spec.v_max),)

    def dt_h(self, x, obs):
        return h_point(x[..., :2], obs, self.spec.radius, self.spec.cbf_beta)


class KinematicBicycle2DDPCBF:
    n, m, rel_deg = 4, 2, 1
    K_LAMBDA, K_MU, S_MARGIN, EPS = 0.1, 0.5, 1.05, 1e-6

    def __init__(self, spec):
        self.spec = spec

    @staticmethod
    def _like(v, c):
        return torch.full((), c, dtype=v.dtype, device=v.device)

    def f(self, x):
        theta, v = x[..., 2], x[..., 3]
        zero = torch.zeros_like(v)
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta), zero, zero], dim=-1)

    def g(self, x):
        theta, v = x[..., 2], x[..., 3]
        zero, one = torch.zeros_like(v), torch.ones_like(v)
        return torch.stack([
            torch.stack([zero, -v * torch.sin(theta)], -1),
            torch.stack([zero, v * torch.cos(theta)], -1),
            torch.stack([zero, v * (1.0 / self.spec.rear_ax_dist)], -1),
            torch.stack([one, zero], -1),
        ], dim=-2)

    def step(self, x, u, dt):
        s = self.spec
        x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (4,)))
        theta, v = x[..., 2], x[..., 3]
        a, beta = u[..., 0], u[..., 1]
        c, sn = torch.cos(theta), torch.sin(theta)
        v_next = torch.minimum(torch.maximum(v + a * dt, self._like(v, s.v_min)),
                               self._like(v, s.v_max))
        return torch.stack([
            x[..., 0] + (v * c + (-v * sn) * beta) * dt,
            x[..., 1] + (v * sn + (v * c) * beta) * dt,
            angle_normalize(theta + ((v * (1.0 / s.rear_ax_dist)) * beta) * dt),
            v_next,
        ], dim=-1)

    def nominal_input(self, x, goal, d_min=0.05, k_theta=0.5, k_a=1.5, k_v=0.5):
        s = self.spec
        distance = torch.clamp_min(norm2(x[..., :2] - goal[..., :2]) - d_min, 0.05)
        theta_d = torch.atan2(goal[..., 1] - x[..., 1], goal[..., 0] - x[..., 0])
        err = angle_normalize(theta_d - x[..., 2])
        delta = torch.clamp(k_theta * err, -s.delta_max, s.delta_max)
        beta = torch.atan((s.rear_ax_dist / s.wheel_base) * torch.tan(delta))
        heading_scale = torch.clamp_min(torch.cos(err), 0.0)
        v = torch.clamp(k_v * distance * heading_scale, s.v_min, s.v_max)
        return torch.stack([k_a * (v - x[..., 3]), beta], dim=-1)

    def stop(self, x):
        return torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)

    def rotate_to(self, x, theta_des, k_theta=2.0):
        err = angle_normalize(theta_des - x[..., 2])
        return torch.stack([torch.zeros_like(err), k_theta * err], dim=-1)

    def has_stopped(self, x, tol=0.05):
        return torch.abs(x[..., 3]) < tol

    def u_box(self):
        s = self.spec
        return [-s.a_max, -s.beta_max], [s.a_max, s.beta_max]

    def ct_h(self, x, obs):
        """The DPCBF value in the line-of-sight frame of the obstacle."""
        s = self.spec
        ego_dim = (obs[..., OBS_R] + s.radius) * self.S_MARGIN
        theta, v = x[..., 2], x[..., 3]
        px, py = obs[..., 0] - x[..., 0], obs[..., 1] - x[..., 1]
        vx = obs[..., 3] - v * torch.cos(theta)
        vy = obs[..., 4] - v * torch.sin(theta)
        p_mag = torch.sqrt(px * px + py * py)
        v_mag = torch.sqrt(vx * vx + vy * vy)
        rot = torch.atan2(py, px)
        c, sn = torch.cos(rot), torch.sin(rot)
        v_rel_x = c * vx + sn * vy
        v_rel_y = -sn * vx + c * vy
        d_safe = torch.maximum(p_mag**2 - ego_dim**2, self._like(p_mag, self.EPS))
        scale = math.sqrt(self.S_MARGIN**2 - 1.0) / ego_dim
        lam = self.K_LAMBDA * torch.sqrt(d_safe) / torch.maximum(
            v_mag, self._like(v_mag, self.EPS)) * scale
        mu = self.K_MU * torch.sqrt(d_safe) * scale
        return v_rel_x + lam * v_rel_y**2 + mu


MODELS = {"DynamicUnicycle2D": DynamicUnicycle2D,
          "KinematicBicycle2D_DPCBF": KinematicBicycle2DDPCBF}


def make_model(name: str, spec):
    return MODELS[name](spec)


def is_in_fov(pos, yaw, point, fov_angle):
    to_p = point[..., :2] - pos
    angle = torch.atan2(to_p[..., 1], to_p[..., 0])
    return torch.abs(angle_normalize(angle - yaw)) <= fov_angle / 2
