"""Heterogeneous fleets: several model families advanced together.

Port of ``safe_control_tpu/parallel/fleet.py`` (BASELINE anchor 5).  A
heterogeneous fleet is a tuple of homogeneous groups, each on its own
leading robot axis; one batched call advances a whole group (on a card a
CBF-QP group's ``tracking.step`` is one launch of the QP kernel), and a
fleet-wide snapshot of positions couples the groups between chunks.

Two kinds of fleet:

- the tracked fleet (``FleetGroup``, ``step_fleet``): every group runs the
  tracking loop; with ``inter_robot`` each robot sees the nearest 4 robots
  of the OTHER groups (its own group is left out entirely, as in the JAX
  package) as circle obstacles, inflated by ``coupling_margin``, held fixed
  for the chunk's ``n_steps``;
- the shielded fleet (``ShieldedGroup``, ``step_fleet_shielded``): every
  robot is under its own gatekeeper (``shielding/gatekeeper.py``, batched
  over the group), nominal = the PD waypoint policy, backup = a deadbeat
  brake; each robot validates its commitments against its nearest
  ``k_neighbors`` robots' future positions from a snapshot taken once a
  chunk (their committed trajectories, or a constant-velocity prediction).

Ties in the nearest-neighbour choices keep the lower index first (a stable
sort), as ``lax.top_k`` does.  ``step_fleet_shielded_sharded`` is the same
shielded step with each group's robots split over the ranks of a
``parallel.mesh.ScenarioMesh``: one all-gather a group builds the snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.core.types import norm2
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.parallel import mesh as mesh_mod
from safe_control_tpu_torch.shielding import gatekeeper as gk_mod
from safe_control_tpu_torch.sim import tracking


def _nearest(d, k: int):
    """Indices of the ``k`` smallest entries of each row of ``d``, the lower
    index first among equal ones (``lax.top_k(-d, k)``)."""
    return torch.sort(d, dim=-1, stable=True).indices[:, :k]


def _offsets(groups) -> np.ndarray:
    return np.cumsum([0] + [g.count for g in groups])


# ============================== tracked fleets ==============================

@dataclasses.dataclass(frozen=True)
class FleetGroup:
    """One homogeneous sub-fleet under the tracking loop."""

    cfg: tracking.TrackerConfig
    count: int
    robot_radius: float = 0.25  # the radius other groups see as an obstacle


class FleetState(NamedTuple):
    trackers: Tuple[tracking.TrackerState, ...]  # one batched state per group


def init_fleet(groups: List[FleetGroup], specs, x0s, waypoints_list, *, device=None,
               dtype=torch.float32) -> FleetState:
    """``x0s[i]``: ``(count_i, n_i)`` initial states.  Every robot of group i
    takes ``waypoints_list[i][0]`` as the first goal of its initial mode, as
    in the JAX package."""
    states = []
    for g, spec, x0, wps in zip(groups, specs, x0s, waypoints_list):
        dev = device if device is not None else (x0.device if isinstance(x0, torch.Tensor)
                                                 else "cuda")
        first = torch.as_tensor(wps, dtype=dtype, device=dev)[0]
        states.append(tracking.init_state(g.cfg, spec, x0, 0.0, first_goal=first, device=dev,
                                          dtype=dtype))
    return FleetState(trackers=tuple(states))


def fleet_positions(groups, state: FleetState) -> torch.Tensor:
    """``(total, 3)`` rows ``[x, y, radius]`` of every robot of the fleet."""
    rows = []
    for g, st in zip(groups, state.trackers):
        pos = get_model(g.cfg.model_name).barrier_pos(st.x)
        rows.append(torch.cat([pos, torch.full((g.count, 1), g.robot_radius, dtype=pos.dtype,
                                               device=pos.device)], dim=1))
    return torch.cat(rows, dim=0)


def coupling_obstacles(groups: List[FleetGroup], state: FleetState, known_obs,
                       coupling_margin: float = 0.3) -> list:
    """Per group, ``(count, Kk + 4, 7)`` obstacle rows: ``known_obs`` and
    each robot's nearest 4 robots of the other groups as circles, their radii
    inflated by ``coupling_margin`` (in the constraint rows only)."""
    offs = _offsets(groups)
    allpos = fleet_positions(groups, state)
    out = []
    for gi, (g, st) in enumerate(zip(groups, state.trackers)):
        others = torch.cat([allpos[: offs[gi]], allpos[offs[gi] + g.count:]], dim=0)
        p = get_model(g.cfg.model_name).barrier_pos(st.x)
        k = min(4, others.shape[0])
        sel = others[_nearest(norm2(others[None, :, :2] - p[:, None, :]), k)]
        rows = torch.cat([sel[..., :2], sel[..., 2:3] + coupling_margin,
                          sel.new_zeros((g.count, k, 4))], dim=-1)
        out.append(torch.cat([known_obs.expand((g.count,) + known_obs.shape), rows], dim=1))
    return out


def step_fleet(groups: List[FleetGroup], specs, state: FleetState, waypoints_list,
               n_waypoints_list, known_obs, inter_robot: bool = True, n_steps: int = 1,
               coupling_margin: float = 0.3) -> FleetState:
    """Advance every group ``n_steps`` tracking steps.  With ``inter_robot``
    each robot's obstacles are ``coupling_obstacles`` (the other groups'
    robots held fixed for the chunk).  ``known_obs``: ``(Kk, 7)`` padded;
    ``waypoints_list[i]``: ``(W, 2)`` or ``(count_i, W, 2)``."""
    if inter_robot:
        obs_list = coupling_obstacles(groups, state, known_obs, coupling_margin)
    else:
        obs_list = [known_obs] * len(groups)
    new_states = []
    for gi, (g, spec, st) in enumerate(zip(groups, specs, state.trackers)):
        for _ in range(n_steps):
            st = tracking.step(g.cfg, spec, st, waypoints_list[gi], n_waypoints_list[gi],
                               obs_list[gi]).state
        new_states.append(st)
    return FleetState(trackers=tuple(new_states))


def fleet_stats(groups, state: FleetState) -> Dict[str, int]:
    done = bad = total = 0
    for g, st in zip(groups, state.trackers):
        done += int((st.ret == tracking.RET_DONE).sum())
        bad += int((st.ret == tracking.RET_INFEASIBLE).sum())
        total += g.count
    return dict(total=total, reached=done, infeasible_or_collision=bad)


# ============================= shielded fleets ==============================

@dataclasses.dataclass(frozen=True)
class ShieldedGroup:
    """One homogeneous sub-fleet under gatekeeper shielding."""

    model_name: str
    count: int
    gk: gk_mod.GatekeeperConfig
    robot_radius: float = 0.25
    reached_threshold: float = 0.3
    safety_margin: float = 0.1  # inter-robot margin on top of the radii


class ShieldedFleetState(NamedTuple):
    x: Tuple[torch.Tensor, ...]  # per group (count, n)
    goal_idx: Tuple[torch.Tensor, ...]  # per group (count,) int64
    gk: Tuple[gk_mod.GatekeeperState, ...]  # per group, batched over the robots
    backup_steps: Tuple[torch.Tensor, ...]  # per group (count,) int64, cumulative
    commits: Tuple[torch.Tensor, ...]  # per group (count,) int64, cumulative


# Shielding is sound only if, for every family of the fleet, the brake
# policy parks the robot inside the validated backup window and the planar
# velocity feeds the constant-velocity prediction the other robots check
# against.  A family without both registered is refused when the fleet is
# built.

def _di_brake(spec, dt):
    def brake(x):
        a = -x[..., 2:4] / dt
        mag = norm2(a)
        scale = torch.where(mag > spec.a_max, spec.a_max / torch.clamp_min(mag, 1e-9),
                            torch.ones_like(mag))
        return a * scale[..., None]
    return brake


def _heading_speed_brake(spec, dt):
    if float(spec.v_min) > 0.0:
        raise ValueError(
            f"{spec.model}: spec.v_min={float(spec.v_min)} > 0: the model's step clamp keeps "
            "it moving forever, so a brake backup can never park it and shielded-fleet "
            "commitments would be unsound.  Configure the group's spec with v_min=0.")

    def brake(x):
        a = torch.clamp(-x[..., 3] / dt, -spec.a_max, spec.a_max)
        return torch.stack([a, torch.zeros_like(a)], dim=-1)
    return brake


def _di_planar_velocity(x):
    return x[..., 2:4]


def _heading_speed_planar_velocity(x):
    return x[..., 3:4] * torch.stack([torch.cos(x[..., 2]), torch.sin(x[..., 2])], dim=-1)


# (spec, dt) -> (x -> u): a deadbeat brake that parks within ceil(v0 /
# (a_max dt)) steps and holds
BRAKE_REGISTRY = {
    spec_mod.DOUBLE_INTEGRATOR_2D: _di_brake,
    spec_mod.DYNAMIC_UNICYCLE_2D: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D_C3BF: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D_DPCBF: _heading_speed_brake,
}

# x (..., n) -> (..., 2) ground-plane velocity
PLANAR_VELOCITY_REGISTRY = {
    spec_mod.DOUBLE_INTEGRATOR_2D: _di_planar_velocity,
    spec_mod.DYNAMIC_UNICYCLE_2D: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D_C3BF: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D_DPCBF: _heading_speed_planar_velocity,
}


def register_brake_policy(model_name: str, builder) -> None:
    """Register a deadbeat brake-policy builder ``(spec, dt) -> (x -> u)``
    for a model family, required before it can join a shielded fleet: the
    policy must reach zero velocity within the backup window and hold."""
    BRAKE_REGISTRY[model_name] = builder


def register_planar_velocity(model_name: str, fn) -> None:
    """Register ``x (..., n) -> (..., 2)`` planar velocity for a model family."""
    PLANAR_VELOCITY_REGISTRY[model_name] = fn


def _brake_policy(model_name: str, spec, dt: float):
    try:
        builder = BRAKE_REGISTRY[model_name]
    except KeyError:
        raise KeyError(
            f"no registered shielded-fleet brake policy for {model_name!r}; register one "
            "with parallel.fleet.register_brake_policy (a model.stop fallback would creep "
            "past the validated backup window)") from None
    return builder(spec, dt)


def _planar_velocity(model_name: str, x):
    try:
        fn = PLANAR_VELOCITY_REGISTRY[model_name]
    except KeyError:
        raise KeyError(
            f"no registered planar-velocity extractor for {model_name!r}; register one with "
            "parallel.fleet.register_planar_velocity (a zeros fallback would validate "
            "commitments against static ghosts of a moving robot)") from None
    return fn(x)


def init_shielded_fleet(groups: List[ShieldedGroup], x0s, *, device=None,
                        dtype=torch.float32) -> ShieldedFleetState:
    for g in groups:  # fail at construction
        if g.model_name not in BRAKE_REGISTRY:
            _brake_policy(g.model_name, None, 0.0)
        if g.model_name not in PLANAR_VELOCITY_REGISTRY:
            _planar_velocity(g.model_name, None)
    xs, gidx, gks, bsteps, commits = [], [], [], [], []
    for g, x0 in zip(groups, x0s):
        dev = device if device is not None else (x0.device if isinstance(x0, torch.Tensor)
                                                 else "cuda")
        x = torch.as_tensor(x0, dtype=dtype, device=dev)
        zero = torch.zeros((g.count,), dtype=torch.long, device=dev)
        xs.append(x)
        gidx.append(zero)
        gks.append(gk_mod.init_state(g.gk, g.count, device=dev, dtype=dtype))
        bsteps.append(zero.clone())
        commits.append(zero.clone())
    return ShieldedFleetState(x=tuple(xs), goal_idx=tuple(gidx), gk=tuple(gks),
                              backup_steps=tuple(bsteps), commits=tuple(commits))


def _committed_pos_table(g, model, dt, Ltab, st_x, gk_st):
    """``(count, Ltab, 2)`` future positions: each robot's own committed
    trajectory read from its current time index (clipped to its end), or a
    constant-velocity line for a robot whose gatekeeper has not initialized
    (the first chunk)."""
    L = g.gk.committed_len
    ar = torch.arange(Ltab, device=st_x.device)
    idx = torch.clamp(gk_st.time_idx[:, None] + ar, 0, L - 1)
    cx = gk_st.committed_x
    pts = model.barrier_pos(torch.gather(cx, 1, idx[..., None].expand(idx.shape + cx.shape[-1:])))
    vel = _planar_velocity(g.model_name, st_x)
    p0 = model.barrier_pos(st_x)
    steps = ar.to(p0.dtype)[:, None] * dt
    cv = p0[:, None, :] + vel[:, None, :] * steps
    return torch.where(gk_st.initialized[:, None, None], pts, cv)


def _snapshot_rows(groups, state: ShieldedFleetState, Ltab: int, prediction: str) -> list:
    """Per group, the rows ``[x, y, radius, future positions (Ltab * 2)]``
    of its robots in ``state``."""
    rows = []
    for g, st_x, gk_st in zip(groups, state.x, state.gk):
        model = get_model(g.model_name)
        pos = model.barrier_pos(st_x)
        if prediction == "commitments":
            tab = _committed_pos_table(g, model, g.gk.dt, Ltab, st_x, gk_st)
        else:
            vel = _planar_velocity(g.model_name, st_x)
            steps = torch.arange(Ltab, dtype=pos.dtype, device=pos.device)[None, :, None] * g.gk.dt
            tab = pos[:, None, :] + vel[:, None, :] * steps
        n = st_x.shape[0]
        rows.append(torch.cat([pos, torch.full((n, 1), g.robot_radius, dtype=pos.dtype,
                                               device=pos.device),
                               tab.reshape(n, Ltab * 2)], dim=1))
    return rows


def _advance_group(g: ShieldedGroup, spec, state: ShieldedFleetState, gi: int, allrows,
                   self_idx, wps, n_wps, known_obs, n_steps: int, k_neighbors: int, Ltab: int):
    """``n_steps`` gatekeeper steps of group ``gi``'s robots in ``state``
    against their nearest neighbours in the snapshot ``allrows`` (``self_idx``
    their own rows).  Returns the group's fields of ``ShieldedFleetState``."""
    model = get_model(g.model_name)
    dt = g.gk.dt
    x, gk_st, goal_idx = state.x[gi], state.gk[gi], state.goal_idx[gi]
    bk, cm = state.backup_steps[gi], state.commits[gi]
    count, W = x.shape[0], wps.shape[1]
    rows = torch.arange(count, device=x.device)

    pos = model.barrier_pos(x)
    d = norm2(allrows[None, :, :2] - pos[:, None, :])  # (count, total)
    d[rows, self_idx] = float("inf")
    k = min(k_neighbors, allrows.shape[0] - 1)
    nbrs = allrows[_nearest(d, k)]  # (count, k, 3 + 2 Ltab)
    reach = nbrs[..., 2] + g.robot_radius + g.safety_margin  # (count, k)
    tab = nbrs[..., 3:].reshape(count, k, Ltab, 2).transpose(1, 2)  # (count, Ltab, k, 2)
    backup_policy = _brake_policy(g.model_name, spec, dt)
    static_spec = spec.replace(radius=g.robot_radius)

    for s in range(n_steps):
        wp = wps[rows, torch.clamp(goal_idx, 0, W - 1)]

        def collision_fn(xx, t_idx, s=s):
            # xx (count, *S, n), t_idx of shape S
            p = model.barrier_pos(xx)
            static_hit = tracking.collision_any(static_spec, p.reshape(-1, 2),
                                                known_obs).reshape(p.shape[:-1])
            j = torch.clamp(s + t_idx, 0, Ltab - 1)
            dist = norm2(tab[:, j] - p[..., None, :])  # (count, *S, k)
            r = reach.reshape((count,) + (1,) * j.dim() + (k,))
            return static_hit | torch.any(dist < r, dim=-1)

        out = gk_mod.step(g.gk, spec, gk_st, x, backup_policy, collision_fn,
                          nominal_policy=lambda xx, wp=wp: model.nominal_input(xx, wp, spec))
        x = model.step(x, out.u, spec, dt)
        gk_st = out.state
        reached = (norm2(model.barrier_pos(x) - wp) < g.reached_threshold) & (goal_idx < n_wps)
        goal_idx = torch.where(reached, goal_idx + 1, goal_idx)
        bk = bk + out.using_backup.long()
        cm = cm + out.candidate_found.long()
    return x, goal_idx, gk_st, bk, cm


def _check_prediction(prediction: str) -> None:
    if prediction not in ("commitments", "constant_velocity"):
        raise ValueError(f"unknown prediction mode {prediction!r}")


def _step_groups(groups, specs, state, allrows, self_starts, waypoints_list, n_waypoints_list,
                 known_obs, n_steps, k_neighbors, Ltab) -> ShieldedFleetState:
    outs = [_advance_group(g, spec, state, gi, allrows,
                           self_starts[gi] + torch.arange(state.x[gi].shape[0],
                                                          device=allrows.device),
                           waypoints_list[gi], n_waypoints_list[gi], known_obs, n_steps,
                           k_neighbors, Ltab)
            for gi, (g, spec) in enumerate(zip(groups, specs))]
    return ShieldedFleetState(*(tuple(parts) for parts in zip(*outs)))


def step_fleet_shielded(groups: List[ShieldedGroup], specs, state: ShieldedFleetState,
                        waypoints_list, n_waypoints_list, known_obs, n_steps: int = 1,
                        k_neighbors: int = 4,
                        prediction: str = "commitments") -> ShieldedFleetState:
    """Advance every group ``n_steps`` under per-robot gatekeeper shielding.

    ``waypoints_list[i]``: ``(count_i, W, 2)``; ``known_obs``: ``(Kk, 7)``
    padded static obstacles.  What a robot's validation assumes of its
    neighbours (``prediction``):

    - ``"commitments"``: they follow their committed trajectories, shared
      once a chunk as a ``(total, Ltab, 2)`` table (a braking neighbour is
      predicted parked).  Commitments adopted mid-chunk are checked against
      the chunk-start table; ``safety_margin`` and short chunks absorb that;
    - ``"constant_velocity"``: the reference's moving-obstacle model.
    """
    _check_prediction(prediction)
    Ltab = n_steps + max(g.gk.committed_len for g in groups)
    allrows = torch.cat(_snapshot_rows(groups, state, Ltab, prediction), dim=0)
    return _step_groups(groups, specs, state, allrows, _offsets(groups), waypoints_list,
                        n_waypoints_list, known_obs, n_steps, k_neighbors, Ltab)


def step_fleet_shielded_sharded(groups: List[ShieldedGroup], specs, state: ShieldedFleetState,
                                waypoints_list, n_waypoints_list, known_obs, mesh,
                                n_steps: int = 1, k_neighbors: int = 4,
                                prediction: str = "commitments") -> ShieldedFleetState:
    """``step_fleet_shielded`` with every group's robots split over the
    ranks of ``mesh`` (a ``parallel.mesh.ScenarioMesh``): ``state`` and
    ``waypoints_list`` hold this rank's contiguous block of each group
    (``mesh.shard_leading_axis``; each count must divide the world size).
    One all-gather a group rebuilds the fleet-wide snapshot on every rank,
    the only communication a chunk; the rest is the single-device step.
    Returns this rank's block of the new state."""
    _check_prediction(prediction)
    for g in groups:
        if g.count % mesh.size:
            raise ValueError(f"group count {g.count} must divide the world size {mesh.size}")
    Ltab = n_steps + max(g.gk.committed_len for g in groups)
    rows = _snapshot_rows(groups, state, Ltab, prediction)
    allrows = torch.cat([mesh_mod.gather_leading_axis(mesh, r) for r in rows], dim=0)
    starts = [int(o) + mesh.rank * (g.count // mesh.size)
              for o, g in zip(_offsets(groups), groups)]
    return _step_groups(groups, specs, state, allrows, starts, waypoints_list,
                        n_waypoints_list, known_obs, n_steps, k_neighbors, Ltab)


def shielded_fleet_stats(groups, state: ShieldedFleetState) -> Dict[str, float]:
    out: Dict[str, float] = dict(total=0, backup_steps=0, commits=0, mean_goal_idx=0.0)
    for g, gidx, bk, cm in zip(groups, state.goal_idx, state.backup_steps, state.commits):
        out["total"] += g.count
        out["backup_steps"] += int(bk.sum())
        out["commits"] += int(cm.sum())
        out["mean_goal_idx"] += float(gidx.sum())
    out["mean_goal_idx"] /= max(out["total"], 1)
    return out


def min_pairwise_clearance(groups, state: ShieldedFleetState) -> float:
    """Min over robot pairs of distance minus the radii sum; > 0 means no
    robot-robot collision now."""
    rows = []
    for g, st_x in zip(groups, state.x):
        pos = get_model(g.model_name).barrier_pos(st_x)
        rows.append(torch.cat([pos, torch.full((g.count, 1), g.robot_radius, dtype=pos.dtype,
                                               device=pos.device)], dim=1))
    allp = torch.cat(rows, dim=0)
    d = norm2(allp[None, :, :2] - allp[:, None, :2])
    clear = d - (allp[None, :, 2] + allp[:, None, 2])
    clear.fill_diagonal_(float("inf"))
    return float(clear.min())
