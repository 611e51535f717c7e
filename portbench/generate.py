"""The traffic generators.  A traffic file under ``traffic/`` names its
generator (``generator``) and holds its parameters; a configuration file
holds the scene.  Every draw comes from a ``torch.Generator`` on the CPU
seeded from ``--seed``, in float32, so that a seed gives the same inputs on
any machine; the inputs then move to the device."""

from __future__ import annotations

import math

import torch


def generator(seed: int) -> torch.Generator:
    """A CPU generator for ``seed`` (any whole number)."""
    return torch.Generator().manual_seed(int(seed) * 1_000_003 % (2**63))


def _u(gen, *shape):
    return torch.rand(shape, generator=gen, dtype=torch.float32)


def route_starts(scene: dict, radius: float, params: dict, gen: torch.Generator, batch: int):
    """Robots spread along the scene's route: arc length uniform over the
    route, ``lateral_m`` either side of it, heading along the leg, speed
    uniform in ``speed_range``, each goal the next waypoint.  A start within
    ``clearance_m`` of an obstacle's edge (robot radius included) is drawn
    again.  Returns ``x0 (B, 4)``, ``next_wp (B,)`` int64."""
    route = torch.tensor(scene["waypoints"], dtype=torch.float32)[:, :2]
    legs = route[1:] - route[:-1]
    lengths = torch.sqrt((legs * legs).sum(-1))
    cum = torch.cat([torch.zeros(1), torch.cumsum(lengths, 0)])
    obs = torch.tensor([o[:3] for o in scene["obstacles"]], dtype=torch.float32)
    reach = obs[:, 2] + radius + params["clearance_m"]
    x0 = torch.zeros((batch, 4))
    leg_of = torch.zeros((batch,), dtype=torch.long)
    todo = torch.ones((batch,), dtype=torch.bool)
    for _ in range(1000):
        k = int(todo.sum())
        if k == 0:
            break
        s = _u(gen, k) * cum[-1]
        lat = (2.0 * _u(gen, k) - 1.0) * params["lateral_m"]
        v = params["speed_range"][0] + _u(gen, k) * (params["speed_range"][1]
                                                     - params["speed_range"][0])
        leg = torch.clamp(torch.searchsorted(cum, s, right=True) - 1, 0, len(lengths) - 1)
        d = legs[leg] / lengths[leg][:, None]
        p = route[leg] + (s - cum[leg])[:, None] * d + lat[:, None] * torch.stack(
            [-d[:, 1], d[:, 0]], -1)
        gap = torch.sqrt(((p[:, None, :] - obs[None, :, :2]) ** 2).sum(-1)) - reach
        ok = (gap > 0).all(-1)
        idx = torch.nonzero(todo).flatten()
        keep = idx[ok]
        x0[keep] = torch.cat([p, torch.atan2(d[:, 1], d[:, 0])[:, None], v[:, None]], -1)[ok]
        leg_of[keep] = leg[ok]
        todo[keep] = False
    if bool(todo.any()):
        raise RuntimeError("route_starts: no free start found")
    return x0, leg_of + 1


def route_waypoints(scene: dict, next_wp):
    """Each robot's remaining route from its next waypoint, ``(B, W, 2)``
    padded with the last waypoint, and its length ``(B,)``."""
    route = torch.tensor(scene["waypoints"], dtype=torch.float32)[:, :2]
    W = route.shape[0]
    idx = torch.clamp(next_wp[:, None] + torch.arange(W)[None, :], max=W - 1)
    return route[idx], (W - next_wp).long()


def dpcbf_scenarios(scene: dict, params: dict, gen: torch.Generator, batch: int):
    """Moving-obstacle scenarios: ``n_obstacles`` centres uniform over
    [x_min, width] x [1, height - 1], headings uniform in [-pi, pi), speeds
    uniform in ``speed_range``, radius ``radius``; every robot at the start
    state.  Returns ``obs (B, K, 7)``, ``x0 (B, 4)``."""
    K = scene["n_obstacles"]
    width, height = scene["workspace"]
    pos = _u(gen, batch, K, 2)
    lo = torch.tensor([scene["obstacle_x_min"], 1.0])
    hi = torch.tensor([width, height - 1.0])
    pos = lo + pos * (hi - lo)
    ang = -math.pi + _u(gen, batch, K) * (2.0 * math.pi)
    sr = scene["speed_range"]
    spd = sr[0] + _u(gen, batch, K) * (sr[1] - sr[0])
    vel = spd[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    r = torch.full((batch, K, 1), scene["obstacle_radius"])
    obs = torch.cat([pos, r, vel, torch.zeros((batch, K, 2))], dim=-1)
    x0 = torch.tensor(scene["start"], dtype=torch.float32).repeat(batch, 1)
    return obs, x0
