"""One step of the waypoint tracker for a batch of robots: the idle /
track / stop / rotate state machine, the waypoint advance, the nearest-K
unpassed obstacle selection, the nominal input, the position controller
(the MPC-CBF solve or the CBF-QP), the collision oracle, the integration,
the return codes and the freeze of finished robots; and the motion of the
moving obstacles."""

from __future__ import annotations

import math

import torch

from portbench.reference import mpc as mpc_ref
from portbench.reference import qp as qp_ref
from portbench.reference.geometry import (
    DUMMY_OBS_POS,
    angle_normalize,
    collides,
    is_dummy,
    norm2,
)

IDLE, TRACK, STOP, ROTATE = 0, 1, 2, 3
RET_INFEASIBLE, RET_DONE, RET_OK = -2, -1, 0


def take_rows(x, idx):
    return x[torch.arange(x.shape[0], device=x.device), idx]


def select_obstacles(num_obs, window, pos, heading, all_obs, speed):
    """Nearest ``num_obs`` rows, unpassed before passed, valid before padded;
    equal scores keep the lower index first."""
    B, Ka = all_obs.shape[:2]
    dtype = all_obs.dtype
    half = window / 2.0
    valid = ~is_dummy(all_obs)
    to_obs = all_obs[..., :2] - pos[:, None, :]
    dist = norm2(to_obs)
    ang = torch.atan2(to_obs[..., 1], to_obs[..., 0])
    rel = ang - heading[:, None]
    unpassed = torch.abs(angle_normalize(rel)) <= half
    unpassed_rev = torch.abs(angle_normalize(rel - math.pi)) <= half
    unpassed = unpassed | ((speed < -1e-3)[:, None] & unpassed_rev)
    any_unpassed = torch.any(unpassed & valid, dim=-1, keepdim=True)
    big = 1e6
    score = (dist + big * (~valid).to(dtype)
             + 0.5 * big * (~unpassed & any_unpassed).to(dtype))
    k = min(num_obs, Ka)
    idx = torch.sort(score, dim=-1, stable=True).indices[:, :k]
    sel = torch.gather(all_obs, 1, idx[..., None].expand(B, k, all_obs.shape[-1]))
    sel_valid = torch.gather(valid & ~(any_unpassed & ~unpassed), 1, idx)
    dummies = torch.zeros((B, num_obs, all_obs.shape[-1]), dtype=dtype, device=all_obs.device)
    dummies[..., :2] = DUMMY_OBS_POS
    sel = torch.where(sel_valid[..., None], sel, dummies[:, :k])
    if k < num_obs:
        sel = torch.cat([sel, dummies[:, k:]], dim=1)
    return sel


def step(model, tcfg: dict, st, state: dict, waypoints, n_waypoints, obs):
    """One step.  ``state``: ``x (B, n)``, ``mode``, ``goal_idx``, ``ret``
    (B,) int64, ``u_prev (B, m)`` and, for the MPC, ``U (B, N, m)``.
    ``tcfg``: the tracker's settings (``controller`` 'mpc_cbf' or 'cbf_qp',
    ``dt``, ``num_obs``, ``reached_threshold``, ``rotation_threshold``,
    ``angle_window_pi``, ``qp_iters``); ``st``: the MPC settings.  Returns
    the new state, the applied ``u``, the nominal ``u_ref``, the state
    machine's ``pre`` (mode, goal index, all done) before the freeze, the
    obstacles ``known``, and for the MPC its ``solution`` and ``problem``
    inputs."""
    x, mode, goal_idx = state["x"], state["mode"], state["goal_idx"]
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    pos, heading = x[:, :2], x[:, 2]
    wps = waypoints[..., :2].expand((B,) + waypoints.shape[-2:]).to(dtype)
    W = wps.shape[1]
    known = obs.expand((B,) + obs.shape[-2:])

    stopped = model.has_stopped(x)
    mode = torch.where((mode == STOP) & stopped, ROTATE, mode)
    wp = take_rows(wps, torch.clamp(goal_idx, 0, W - 1))
    reached = ((norm2(pos - wp) < tcfg["reached_threshold"]) & (goal_idx < n_waypoints)
               & (mode != STOP))
    goal_idx = torch.where(reached, goal_idx + 1, goal_idx)
    all_done = goal_idx >= n_waypoints
    mode = torch.where(all_done & (mode != STOP), IDLE, mode)
    wp = take_rows(wps, torch.clamp(goal_idx, 0, W - 1))
    goal_angle = torch.atan2(wp[:, 1] - pos[:, 1], wp[:, 0] - pos[:, 0])
    aligned = torch.abs(angle_normalize(heading - goal_angle)) <= tcfg["rotation_threshold"]
    mode = torch.where((mode == ROTATE) & aligned & ~all_done, TRACK, mode)

    obs_sel = select_obstacles(tcfg["num_obs"], tcfg["angle_window_pi"] * math.pi, pos, heading,
                               known, x[:, 3])
    u_track = model.nominal_input(x, wp)
    u_stop = model.stop(x)
    u_rotate = model.rotate_to(x, goal_angle)
    u_ref = torch.where((mode == TRACK)[:, None], u_track,
                        torch.where((mode == ROTATE)[:, None], u_rotate, u_stop))

    out = {}
    if tcfg["controller"] == "mpc_cbf":
        goal_full = torch.zeros((B, model.n), dtype=dtype, device=dev)
        goal_full[:, :2] = wp
        args = (x, goal_full, obs_sel[:, : st.num_obs], state["u_prev"], state["U"])
        sol = mpc_ref.solve(model, st, tcfg["dt"], *args)
        u = torch.where((mode == TRACK)[:, None], sol.u, u_ref)
        feasible = torch.ones((B,), dtype=torch.bool, device=dev)
        out.update(solution=sol, problem=args)
    elif tcfg["controller"] == "cbf_qp":
        res = qp_ref.cbf_qp(model, x, u_ref, obs_sel, tcfg["qp_iters"])
        u, feasible = res.u, res.feasible
    else:
        raise ValueError(f"unknown controller {tcfg['controller']!r}")

    out.update(finish(model, tcfg, state, known, u, feasible, mode, goal_idx, all_done))
    out.update(u_ref=u_ref, pre=(mode, goal_idx, all_done), known=known)
    return out


def finish(model, tcfg, state, known, u, feasible, mode, goal_idx, all_done):
    """The collision oracle, the integration with ``u``, the return codes
    and the freeze of the robots that had finished before the step."""
    x = state["x"]
    collide_pre = collides(model.spec.radius, x[:, :2], known)
    x_next = model.step(x, u, tcfg["dt"])
    collide_post = collides(model.spec.radius, x_next[:, :2], known)
    bad = ~feasible | collide_pre | collide_post
    ret = torch.where(bad, RET_INFEASIBLE, torch.where(all_done & (mode != STOP), RET_DONE,
                                                       RET_OK))
    frozen = state["ret"] < 0

    def keep(old, new):
        return torch.where(frozen.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

    return dict(u=u, x=keep(x, x_next), mode=keep(state["mode"], mode),
                goal_idx=keep(state["goal_idx"], goal_idx), ret=keep(state["ret"], ret.long()),
                feasible=feasible)


def move_obstacles(obs, dt, y_range):
    """Constant-velocity obstacles (velocity in columns 3:5), the y velocity
    flipped where a centre leaves ``y_range``."""
    obs = torch.cat([obs[..., 0:2] + obs[..., 3:5] * dt, obs[..., 2:]], dim=-1)
    vx, vy = obs[..., 3], obs[..., 4]
    flip_y = (obs[..., 1] < y_range[0]) | (obs[..., 1] > y_range[1])
    vy = vy * torch.where(flip_y, -1.0, 1.0).to(obs.dtype)
    return torch.cat([obs[..., :3], vx[..., None], vy[..., None], obs[..., 5:]], dim=-1)
