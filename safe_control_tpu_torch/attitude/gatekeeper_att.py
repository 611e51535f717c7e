"""Gatekeeper applied to the yaw channel (exploration-safety shielding).

Port of ``safe_control_tpu/attitude/gatekeeper_att.py``, batched over
robots.  The positional prediction is shielded in the yaw channel, so that
the camera sees the part of the path that matters before the robot commits
to it:

1. the prediction is extended to cover the nominal + backup horizon;
2. critical point = the first predicted position outside the footprint;
3. reactive fallback: a critical point within camera range but outside the
   current FoV -> the backup yaw at once, the commitment dropped;
4. the crossing step caps the nominal horizon so that the backup completes
   inside the known region;
5. candidates = a nominal prefix (the visibility-area yaw along the path)
   then the velocity-tracking backup; the backward search shortens the
   prefix by ``discount_steps`` per candidate;
6. validity: the critical point enters the FoV before the braking deadline,
   and at every step the braking-lookahead tube along the path lies inside
   that step's FoV sector;
7. commit the longest valid prefix, or keep the previous commitment and
   retry after ``event_offset``; past its end, the live backup yaw.

The candidates of a batch are one broadcast over ``(B, candidates)``; the
rollout over the T predicted steps is a loop.  ``first index`` rules
(argmax of booleans) are those of ``jnp.argmax``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from safe_control_tpu_torch.attitude.visibility import candidate_yaws, sector_counts
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.core.types import (
    angle_normalize,
    first_true,
    linspace,
    norm2,
    take_rows,
)
from safe_control_tpu_torch.perception import grid as grid_mod


@dataclasses.dataclass(frozen=True)
class GatekeeperAttConfig:
    """The yaw gatekeeper's knobs, with the JAX package's fields and defaults."""

    dt: float = 0.05
    nominal_horizon: float = 1.0  # [s]
    backup_horizon: float = 2.0  # [s]
    event_offset: float = 0.5  # [s]
    horizon_discount: float = 0.25  # [s] (= max(5 dt, dt))
    validation_slack: float = 0.05
    tube_margin: float = 0.0
    braking_distance_scale: float = 1.0
    braking_distance_margin: float = 0.35  # radius + 0.10 by default
    kp_vis: float = 1.5  # visibility-area gain
    kp_backup: float = 1.5  # velocity-tracking gain
    n_yaw_samples: int = 36
    n_tube_samples: int = 8

    @property
    def nominal_steps(self) -> int:
        return max(int(math.ceil(self.nominal_horizon / self.dt)), 0)

    @property
    def backup_steps(self) -> int:
        return max(int(math.ceil(self.backup_horizon / self.dt)), 1)

    @property
    def total_steps(self) -> int:
        return self.nominal_steps + self.backup_steps

    @property
    def discount_steps(self) -> int:
        return max(int(math.ceil(self.horizon_discount / self.dt)), 1)

    @property
    def event_offset_steps(self) -> int:
        return max(int(math.ceil(self.event_offset / self.dt)), 1)

    @property
    def num_candidates(self) -> int:
        return self.nominal_steps // self.discount_steps + 2


class GatekeeperAttState(NamedTuple):
    committed_u: torch.Tensor  # (B, total_steps) committed yaw rates
    committed_len: torch.Tensor  # (B,) int64, valid length of committed_u
    time_idx: torch.Tensor  # (B,) int64
    next_event_idx: torch.Tensor  # (B,) int64
    initialized: torch.Tensor  # (B,) bool
    # Replan statistics.
    total_replans: torch.Tensor
    accepted_replans: torch.Tensor
    rejected_replans: torch.Tensor
    nominal_steps_total: torch.Tensor


def init_state(cfg: GatekeeperAttConfig, batch: int, *, device=None,
               dtype=torch.float32) -> GatekeeperAttState:
    z = torch.zeros((batch,), dtype=torch.long, device=device)
    return GatekeeperAttState(
        committed_u=torch.zeros((batch, cfg.total_steps), dtype=dtype, device=device),
        committed_len=z,
        time_idx=z,
        next_event_idx=z,
        initialized=torch.zeros((batch,), dtype=torch.bool, device=device),
        total_replans=z,
        accepted_replans=z,
        rejected_replans=z,
        nominal_steps_total=z,
    )


def _in_fov(pos, yaw, point, spec, slack=0.0, check_range=True):
    """Cone membership with an angular and range slack, elementwise."""
    to_p = point - pos
    ang = torch.abs(angle_normalize(torch.atan2(to_p[..., 1], to_p[..., 0]) - yaw))
    ok = ang <= spec.fov_angle / 2.0 + slack
    if check_range:
        ok = ok & (norm2(to_p) <= spec.cam_range + slack)
    return ok


def _prefix_sum(x, base: int = 16):
    """Inclusive prefix sums over the last axis, added in the order of the
    JAX package's ``jnp.cumsum`` on its CPU backend: in order within blocks
    of ``base``, plus the prefix of the block totals (taken the same way)."""
    n = x.shape[-1]
    if n <= base:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    pad = (-n) % base
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    inner = _prefix_sum(xp.reshape(x.shape[:-1] + (-1, base)), base)
    pre = _prefix_sum(inner[..., -1], base)
    excl = torch.cat([pre.new_zeros(pre.shape[:-1] + (1,)), pre[..., :-1]], dim=-1)
    return (inner + excl[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]


def max_braking_distance(cfg: GatekeeperAttConfig, spec, model_name: str, *, device=None,
                         dtype=torch.float32):
    """The braking distance the validity test allows for.  For
    DoubleIntegrator2D it is a ``dtype`` scalar tensor, summed in that dtype
    as the JAX package's ``jnp.maximum`` makes it; otherwise a float."""
    if model_name == spec_mod.DOUBLE_INTEGRATOR_2D:
        a_max = torch.full((), max(spec.a_max, 1e-6), dtype=dtype, device=device)
        base = spec.v_max**2 / (2.0 * a_max)
    elif model_name == spec_mod.SINGLE_INTEGRATOR_2D:
        base = spec.v_max * cfg.dt
    else:
        base = spec.cam_range * 0.25
    return cfg.braking_distance_scale * base + cfg.braking_distance_margin


def visibility_targets(footprint, gs: grid_mod.GridSpec, positions, spec, n_yaw: int):
    """Per-step visibility-area target yaws ``(B, P)`` along predicted paths
    ``positions (B, P, 2)``, each scored against the current footprint."""
    yaws = candidate_yaws(n_yaw, device=positions.device, dtype=positions.dtype)
    _, scores = sector_counts(footprint, gs, positions, yaws, spec)  # (B, P, Y)
    return yaws[torch.argmax(scores, dim=-1)]


def _arc_lookahead_points(path, brake_dist, n_pts: int):
    """For each start index i, the point at arc length ``brake_dist`` along
    the path polyline ``(B, T, 2)``, and ``n_pts`` samples of the segment
    from the start to it: ``(B, T, 2)`` and ``(B, T, n_pts, 2)``."""
    T = path.shape[-2]
    seg = norm2(path[:, 1:] - path[:, :-1])  # (B, T-1)
    cum = torch.cat([seg.new_zeros(seg.shape[:-1] + (1,)), _prefix_sum(seg)], dim=-1)  # (B, T)
    target = cum + brake_dist  # (B, T): one per start index i
    past = cum[:, None, :] >= (target - 1e-9)[:, :, None]  # (B, i, j)
    any_past = past.any(-1)
    i = torch.arange(T, device=path.device)
    j = torch.where(any_past, first_true(past), T - 1)
    j = torch.maximum(j, i)
    j0 = torch.clamp_min(j - 1, 0)
    cum_j, cum_j0 = torch.gather(cum, 1, j), torch.gather(cum, 1, j0)
    seg_len = torch.clamp_min(cum_j - cum_j0, 1e-9)
    alpha = torch.clamp((target - cum_j0) / seg_len, 0.0, 1.0)
    p_j = torch.gather(path, 1, j[..., None].expand(-1, -1, 2))
    p_j0 = torch.gather(path, 1, j0[..., None].expand(-1, -1, 2))
    cps = p_j0 + alpha[..., None] * (p_j - p_j0)
    cps = torch.where(any_past[..., None], cps, path[:, T - 1:T])
    ts = linspace(0.0, 1.0, n_pts, device=path.device, dtype=path.dtype)
    tube_pts = path[:, :, None, :] + ts[None, None, :, None] * (cps[:, :, None, :]
                                                                - path[:, :, None, :])
    return cps, tube_pts


def step(cfg: GatekeeperAttConfig, spec, model_name: str, state: GatekeeperAttState,
         footprint, gs: grid_mod.GridSpec, pos_traj, vel_traj, yaw):
    """One yaw-gatekeeper step for a batch of robots.

    ``footprint (B, nx, ny)``, predicted positions and velocities
    ``pos_traj``/``vel_traj (B, T+1, 2)``, ``yaw (B,)``.  Returns
    ``(u_att (B,), new_state, info)``.
    """
    T = cfg.total_steps
    dt = cfg.dt
    backup_steps = cfg.backup_steps
    B = pos_traj.shape[0]
    dev, dtype = pos_traj.device, pos_traj.dtype
    w_max = spec.w_max

    # ---- critical point: the first predicted cell outside the footprint ----
    unknown = ~grid_mod.lookup(footprint, gs, pos_traj)  # (B, T+1)
    has_crossing = unknown.any(-1)
    crossing_step = first_true(unknown)
    critical_point = take_rows(pos_traj, crossing_step)  # (B, 2)

    brake_dist = max_braking_distance(cfg, spec, model_name, device=dev, dtype=dtype)

    def backup_rate(vel, yw):
        des = torch.atan2(vel[..., 1], vel[..., 0])
        rate = torch.clamp(cfg.kp_backup * angle_normalize(des - yw), -w_max, w_max)
        return torch.where(norm2(vel) > 1e-2, rate, torch.zeros_like(rate))

    live_backup = backup_rate(vel_traj[:, 0], yaw)

    # ---- reactive fallback --------------------------------------------------
    cp_dist = norm2(critical_point - pos_traj[:, 0])
    cp_in_range = cp_dist <= spec.cam_range + cfg.validation_slack
    cp_visible = _in_fov(pos_traj[:, 0], yaw, critical_point, spec, 0.0, check_range=True)
    reactive = has_crossing & cp_in_range & ~cp_visible

    # ---- event: backward search over nominal prefixes ---------------------
    event = (state.time_idx >= state.next_event_idx) | ~state.initialized
    latest_nominal = torch.clamp_min(crossing_step - backup_steps, 0)
    max_nominal = torch.where(has_crossing, torch.clamp_max(latest_nominal, cfg.nominal_steps),
                              torch.full_like(latest_nominal, cfg.nominal_steps))

    vis_targets = visibility_targets(footprint, gs, pos_traj[:, :T], spec, cfg.n_yaw_samples)

    C = cfg.num_candidates
    cand_lens = torch.clamp_min(
        max_nominal[:, None] - torch.arange(C, device=dev) * cfg.discount_steps, 0)  # (B, C)
    yw = yaw[:, None].expand(B, C)
    cand_yaws, cand_rates = [], []
    for k in range(T):
        nominal = torch.clamp(cfg.kp_vis * angle_normalize(vis_targets[:, k, None] - yw),
                              -w_max, w_max)
        rate = torch.where(k < cand_lens, nominal, backup_rate(vel_traj[:, k, None, :], yw))
        cand_yaws.append(yw)
        cand_rates.append(rate)
        yw = angle_normalize(yw + rate * dt)
    cand_yaws = torch.stack(cand_yaws, dim=-1)  # (B, C, T): yaw at the start of each step
    cand_rates = torch.stack(cand_rates, dim=-1)  # (B, C, T)
    cand_total = torch.clamp_max(cand_lens + backup_steps, T)  # committed length

    # ---- validity -----------------------------------------------------------
    path = pos_traj[:, :T]
    d_to_cp = norm2(path - critical_point[:, None])
    within_brake = d_to_cp <= brake_dist + cfg.validation_slack
    deadline = torch.minimum(crossing_step, torch.where(
        within_brake.any(-1), first_true(within_brake), T - 1))
    deadline = torch.clamp(deadline, 0, T - 1)

    _, tube_pts = _arc_lookahead_points(path, brake_dist, cfg.n_tube_samples)

    in_cand = torch.arange(T, device=dev) < cand_total[..., None]  # (B, C, T)
    # (a) the critical point seen (cone + camera range) before the deadline
    sees = _in_fov(path[:, None], cand_yaws, critical_point[:, None, None], spec,
                   cfg.validation_slack)
    seen_cum = torch.cumsum((sees & in_cand).long(), dim=-1) > 0
    at = torch.minimum(deadline[:, None], cand_total - 1)
    global_ok = torch.gather(seen_cum, 2, at[..., None])[..., 0]
    # (b) the braking tube of every step inside that step's FoV sector
    tubes = _in_fov(path[:, None, :, None], cand_yaws[..., None], tube_pts[:, None], spec,
                    cfg.validation_slack + cfg.tube_margin).all(-1)  # (B, C, T)
    tubes_ok = (tubes | ~in_cand).all(-1)
    cand_valid = torch.where(has_crossing[:, None], global_ok & tubes_ok,
                             torch.ones_like(global_ok))
    found = cand_valid.any(-1)
    best = first_true(cand_valid)  # the first valid = the longest nominal prefix

    commit = event & found
    committed_u = torch.where(commit[:, None], take_rows(cand_rates, best), state.committed_u)
    committed_len = torch.where(commit, take_rows(cand_total, best), state.committed_len)
    zero = torch.zeros_like(state.time_idx)
    time_idx = torch.where(commit, zero, state.time_idx)
    next_event = torch.where(commit, torch.full_like(zero, cfg.event_offset_steps),
                             torch.where(event, state.time_idx + cfg.event_offset_steps,
                                         state.next_event_idx))

    # ---- emit: the committed rate, or the live backup past its end --------
    in_committed = time_idx < committed_len
    u_att = torch.where(in_committed, take_rows(committed_u, torch.clamp(time_idx, 0, T - 1)),
                        live_backup)

    # The reactive fallback overrides everything and drops the commitment.
    u_att = torch.where(reactive, live_backup, u_att)
    committed_len = torch.where(reactive, zero, committed_len)
    time_idx = torch.where(reactive, zero, time_idx)
    next_event = torch.where(reactive, zero, next_event)

    u_att = torch.clamp(u_att, -w_max, w_max)

    accepted = commit & ~reactive
    nominal_len = take_rows(cand_lens, best)
    new_state = GatekeeperAttState(
        committed_u=committed_u,
        committed_len=committed_len,
        time_idx=time_idx + 1,
        next_event_idx=next_event,
        initialized=torch.ones_like(state.initialized),
        total_replans=state.total_replans + (event & ~reactive).long(),
        accepted_replans=state.accepted_replans + accepted.long(),
        rejected_replans=state.rejected_replans + ((event & ~found) | reactive).long(),
        nominal_steps_total=state.nominal_steps_total + torch.where(accepted, nominal_len, zero),
    )
    info = dict(
        event=event,
        found=found,
        reactive=reactive,
        nominal_len=nominal_len,
        crossing=has_crossing,
        crossing_step=crossing_step,
        critical_point=critical_point,
    )
    return u_att, new_state, info


def extend_prediction(model, spec, x_pred, dt: float, total_steps: int):
    """Extend predicted states ``x_pred (B, P, n)`` to ``total_steps + 1``
    states with a zero-control rollout of the last one."""
    P = x_pred.shape[1]
    need = total_steps + 1 - P
    if need <= 0:
        return x_pred[:, : total_steps + 1]
    u0 = x_pred.new_zeros((x_pred.shape[0], model.N_CONTROLS))
    x = x_pred[:, -1]
    tail = []
    for _ in range(need):
        x = model.step(x, u0, spec, dt)
        tail.append(x)
    return torch.cat([x_pred, torch.stack(tail, dim=1)], dim=1)
