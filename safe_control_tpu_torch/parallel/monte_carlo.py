"""Monte Carlo sweep: thousands of randomized scenarios as one batch.

Port of ``safe_control_tpu/parallel/monte_carlo.py`` on one device: the
scenarios are the tracker's leading batch axis, so one ``tracking.step``
advances them all (on a card the CBF-QP of every scenario is one launch of
the QP kernel), and the dynamic obstacles advance and bounce in the same
loop.  The sweep state (tracker states, obstacle arrays, steps done) is one
tuple of tensors that ``utils/checkpoint.py`` saves and restores.

``dpcbf_sweep_init`` draws from a ``torch.Generator``; it cannot reproduce
``jax.random``'s stream, so a comparison with the JAX package feeds the JAX
init's arrays through ``interop.sweep_state_from_numpy``.

``run_sharded_sweep`` splits the scenarios over the ranks of a
``parallel.mesh.ScenarioMesh``: each rank advances its block chunk by chunk,
the statistics are summed over the ranks (``sweep_stats(state, mesh)``) and
the final state is gathered, so that every rank holds what the one-device
sweep holds.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from safe_control_tpu_torch.parallel import mesh as mesh_mod
from safe_control_tpu_torch.sim import tracking
from safe_control_tpu_torch.utils.profiling import span


class SweepState(NamedTuple):
    tracker: tracking.TrackerState  # batched (B, ...)
    obs: torch.Tensor  # (B, K, 7) per-scenario dynamic obstacles
    steps_done: torch.Tensor  # () int64


class SweepResult(NamedTuple):
    ret: torch.Tensor  # (B,) final return codes
    x: torch.Tensor  # (B, n) final states
    success_rate: torch.Tensor  # ()
    collision_rate: torch.Tensor  # ()


def dpcbf_sweep_init(cfg: tracking.TrackerConfig, spec, generator: torch.Generator, batch: int,
                     waypoints, n_obstacles: int = 8, speed_range=(0.3, 0.8),
                     workspace=(22.0, 15.0), *, device="cuda",
                     dtype=torch.float32) -> SweepState:
    """Randomized dynamic-obstacle scenarios: obstacle centres uniform over
    [6, workspace_x] x [1, workspace_y - 1], headings uniform in [-pi, pi],
    speeds uniform in ``speed_range``, radius 0.5; every robot starts at
    (1, 7.5) heading east at 1 m/s.  Draws on the generator's device, then
    moves to ``device``."""
    g_dev = generator.device
    u = lambda *shape: torch.rand(shape, generator=generator, device=g_dev, dtype=dtype)
    pos = u(batch, n_obstacles, 2)
    lo = torch.tensor([6.0, 1.0], dtype=dtype, device=g_dev)
    hi = torch.tensor([workspace[0], workspace[1] - 1.0], dtype=dtype, device=g_dev)
    pos = lo + pos * (hi - lo)
    ang = -math.pi + u(batch, n_obstacles) * (2.0 * math.pi)
    spd = speed_range[0] + u(batch, n_obstacles) * (speed_range[1] - speed_range[0])
    vel = spd[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    r = torch.full((batch, n_obstacles, 1), 0.5, dtype=dtype, device=g_dev)
    zeros = torch.zeros((batch, n_obstacles, 2), dtype=dtype, device=g_dev)
    obs = torch.cat([pos, r, vel, zeros], dim=-1).to(device)
    x0 = torch.tensor([1.0, 7.5, 0.0, 1.0], dtype=dtype, device=device).repeat(batch, 1)
    wps = torch.as_tensor(waypoints, dtype=dtype, device=device)
    st = tracking.init_state(cfg, spec, x0, 0.0, first_goal=wps[0, :2], device=device,
                             dtype=dtype)
    return SweepState(tracker=st, obs=obs,
                      steps_done=torch.zeros((), dtype=torch.long, device=device))


def run_sweep_chunk(cfg: tracking.TrackerConfig, spec, state: SweepState, waypoints, n_waypoints,
                    n_steps: int, y_range=(0.0, 15.0), with_trajectory: bool = False):
    """Advance every scenario by ``n_steps``: each step the tracking step
    (the span ``tracking.step``), then the obstacles' (``sweep.obstacles``,
    timed on the device too).  With ``with_trajectory`` also return the
    per-step states ``x (B, n_steps, n)``, inputs ``u (B, n_steps, m)`` and
    obstacle centres after the step ``obs_xy (B, n_steps, K, 2)``, stacked
    on the device."""
    tr, obs = state.tracker, state.obs
    xs, us, oxy = [], [], []
    for _ in range(n_steps):
        out = tracking.step(cfg, spec, tr, waypoints, n_waypoints, obs)
        tr = out.state
        with span("sweep.obstacles", device=True):
            obs = tracking.step_dynamic_obstacles(obs, cfg.dt, y_range=y_range)
        if with_trajectory:
            xs.append(tr.x)
            us.append(out.u)
            oxy.append(obs[..., :2])
    final = SweepState(tracker=tr, obs=obs, steps_done=state.steps_done + n_steps)
    if with_trajectory:
        return final, dict(x=torch.stack(xs, dim=1), u=torch.stack(us, dim=1),
                           obs_xy=torch.stack(oxy, dim=1))
    return final


def sweep_stats(state: SweepState, axis_name: Optional[mesh_mod.ScenarioMesh] = None):
    """(success rate, collision rate) of the batch: the shares of RET_DONE
    and RET_INFEASIBLE return codes.  ``axis_name``: a ``ScenarioMesh`` (the
    JAX package's mesh axis) over whose ranks the counts are summed."""
    ret = state.tracker.ret
    counts = torch.stack([(ret == tracking.RET_DONE).to(torch.float32).sum(),
                          (ret == tracking.RET_INFEASIBLE).to(torch.float32).sum(),
                          torch.full((), ret.shape[0], dtype=torch.float32, device=ret.device)])
    if axis_name is not None:
        counts = mesh_mod.psum_scenario(counts, axis_name)
    return counts[0] / counts[2], counts[1] / counts[2]


def run_sharded_sweep(mesh: mesh_mod.ScenarioMesh, cfg: tracking.TrackerConfig, spec,
                      state: SweepState, waypoints, n_waypoints, n_steps: int, chunk: int = 50):
    """The sweep over the ranks of ``mesh``: ``ceil(n_steps / chunk)`` chunks
    of ``chunk`` steps (as the JAX package counts them) on each rank's block
    of ``state`` (the whole batch, the same on every rank; the batch must
    divide the world size), the rates summed over the ranks after every
    chunk.  Returns ``(final SweepState, SweepResult)``, both whole on every
    rank."""
    local = mesh_mod.shard_leading_axis(mesh, state)
    wps = mesh_mod.replicate(mesh, torch.as_tensor(waypoints))
    s = c = None
    for _ in range(math.ceil(n_steps / chunk)):
        local = run_sweep_chunk(cfg, spec, local, wps, n_waypoints, chunk)
        s, c = sweep_stats(local, mesh)
    tracker, obs = mesh_mod.gather_leading_axis(mesh, (local.tracker, local.obs))
    final = SweepState(tracker=tracker, obs=obs, steps_done=local.steps_done)
    return final, SweepResult(ret=tracker.ret, x=tracker.x, success_rate=s, collision_rate=c)
