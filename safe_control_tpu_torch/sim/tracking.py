"""Waypoint tracking: the tracker's state machine, batched over robots.

Port of ``safe_control_tpu/sim/tracking.py``.  The idle / track / stop /
rotate state machine, waypoint advance, nearest-unpassed obstacle selection
with per-model angular windows, perception, the nominal input, the position
and attitude controllers, the collision oracle and the return-code contract
(-2 infeasible or collision, -1 all waypoints reached, 0 normal, 1 a
visibility violation).

Everything runs on a leading robot axis B: every field of ``TrackerState``
is ``(B, ...)``, and one ``step`` advances B independent robots, as
``jax.vmap`` of the JAX package's step does.  The ``TrackerConfig`` and the
robot spec (plain floats) are shared by the batch; waypoints and obstacle
sets are shared (``(W, 2)``, ``(K, 7)``) or per robot (``(B, W, 2)``,
``(B, K, 7)``).  ``step`` reads nothing back to the host.

Solver routing inside ``step``, one solver call for the whole batch:

- ``mpc_cbf`` / ``optimal_decay_mpc_cbf``: ``mpc_cbf.solve_dispatch`` for
  every robot and every step, and ``u = where(mode == TRACK, res.u,
  u_ref)``.  With ``cfg.mpc.use_fused_kernel`` (default False), float32
  states and a spec of plain floats it is one launch of the fused MPC
  kernel on CUDA tensors (its plain version on CPU tensors).  Optimal decay
  is the general solve with the two decay multipliers a stage (the fused
  kernel does not take it, in the JAX package as here).
- ``cbf_qp``: ``cbf_qp.solve_batch`` with ``backend="pallas"`` on CUDA
  float32 states, at every batch size: one launch of the QP kernel.
  Otherwise ``backend="xla"``, the general ``qp.solve_qp``, which is what
  the JAX package's ``cbf_qp.solve`` runs.  This is a dispatch rule, not a
  fallback: nothing catches a kernel's build or launch error.
- ``optimal_decay_cbf_qp``: ``optimal_decay_cbf_qp.solve`` on the nearest
  selected obstacle, with the softer nominal gains (k_omega 3, k_a 0.5,
  k_v 0.5) for the nominal input.

Every model of the registry has its initial state here; the drift models
(DynamicBicycle2D, DriftingCar) have no MPC weights and run under the
drift simulator's shielding (``sim/drift_sim.py``), not this tracker.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from safe_control_tpu_torch.attitude import gatekeeper_att as gk_att_mod
from safe_control_tpu_torch.attitude import visibility as vis_mod
from safe_control_tpu_torch.attitude.simple import velocity_tracking_yaw
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.core.types import (
    DUMMY_OBS_POS,
    OBS_DIM,
    OBS_FLAG,
    OBS_R,
    angle_normalize,
    is_dummy,
    norm2,
    per_robot,
    take_rows,
)
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.perception import fov as fov_mod
from safe_control_tpu_torch.perception import grid as grid_mod
from safe_control_tpu_torch.solvers import cbf_qp as cbf_qp_mod
from safe_control_tpu_torch.solvers import mpc_cbf as mpc_mod
from safe_control_tpu_torch.solvers import optimal_decay_cbf_qp as od_qp_mod
from safe_control_tpu_torch.utils.profiling import span

# State-machine codes.
IDLE, TRACK, STOP, ROTATE = 0, 1, 2, 3

# Step return codes.
RET_INFEASIBLE = -2
RET_DONE = -1
RET_OK = 0
RET_VISIBILITY = 1

_INTEGRATORS = (spec_mod.SINGLE_INTEGRATOR_2D, spec_mod.DOUBLE_INTEGRATOR_2D)
# Models that skip the 'rotate' state entirely.
_SKIP_ROTATE = (spec_mod.QUAD_2D, spec_mod.VTOL_2D, spec_mod.MANIPULATOR_2D)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static configuration, shared by every robot of a batch.

    ``pos_controller``: 'cbf_qp' | 'mpc_cbf' | 'optimal_decay_cbf_qp' |
    'optimal_decay_mpc_cbf'; ``att_controller`` (integrators only): 'none' |
    'simple' | 'velocity_tracking_yaw' | 'visibility_raycast' |
    'visibility_area' | 'gatekeeper'; ``detection_mode``: 'fov' | 'ray'.
    The fields, defaults and validation errors are the JAX package's.
    """

    model_name: str
    pos_controller: str = "cbf_qp"
    att_controller: str = "velocity_tracking_yaw"
    dt: float = 0.05
    num_obs: int = 10  # constraint slots fed to the controller
    mem_slots: int = 16  # persistent unknown-obstacle memory size
    reached_threshold: float = 0.3
    rotation_threshold: float = 0.1
    enable_rotation: bool = True
    use_sensor: bool = False
    detection_mode: str = "fov"
    # CBF-QP constraint form: 'cbf' = Lie-derivative rows with the class-K
    # terms; 'hard' = one-step invariance rows h(x_next) >= 0.
    cbf_mode: str = "cbf"
    mpc: mpc_mod.MPCConfig = mpc_mod.MPCConfig()
    qp_iters: int = 1600
    # With a GridSpec (and use_sensor) the footprint is updated every step
    # and a visibility violation returns RET_VISIBILITY.
    grid: object = None  # Optional[grid_mod.GridSpec]
    visibility_mode: str = "safety_area"  # or 'point_mass'
    # Braking decelerations for the safety area.
    max_decel: float = 3.0
    max_ang_decel: float = 3.0
    # VTOL pitch term of the collision oracle: 'reference' compares the
    # pitch against the raw spec value (in degrees); 'strict' converts it to
    # radians first.
    vtol_pitch_oracle: str = "reference"
    # MPC feasibility verdict: False never fails a step on the MPC's own
    # verdict (only a collision does); True feeds MPCResult.feasible in.
    strict_mpc_feasibility: bool = False
    gk_att: gk_att_mod.GatekeeperAttConfig = gk_att_mod.GatekeeperAttConfig()

    def __post_init__(self):
        if self.pos_controller not in (
            "cbf_qp", "mpc_cbf", "optimal_decay_cbf_qp", "optimal_decay_mpc_cbf",
        ):
            raise ValueError(f"Unknown controller type: {self.pos_controller}")
        if self.att_controller not in (
            "none", "simple", "velocity_tracking_yaw", "visibility_raycast",
            "visibility_area", "gatekeeper",
        ):
            raise ValueError(f"Unknown attitude controller type: {self.att_controller}")
        if self.pos_controller == "optimal_decay_mpc_cbf" and not self.mpc.optimal_decay:
            # The optimal-decay MPC is the same engine with the omega inputs
            # on: coerce the flag so that the two settings cannot disagree.
            object.__setattr__(self, "mpc", self.mpc._replace(optimal_decay=True))
        if self.detection_mode not in ("fov", "ray"):
            raise ValueError(f"Unsupported unknown_obs_detection mode: {self.detection_mode}")
        if self.cbf_mode not in ("cbf", "hard"):
            raise ValueError(f"Unsupported cbf_mode: {self.cbf_mode}")
        needs_grid = self.att_controller in (
            "visibility_raycast", "visibility_area", "gatekeeper",
        ) or self.detection_mode == "ray"
        if needs_grid and self.grid is None:
            raise ValueError(
                f"att_controller={self.att_controller!r} / detection_mode="
                f"{self.detection_mode!r} require a GridSpec (cfg.grid): they "
                "operate on the sensing footprint"
            )

    @property
    def uses_mpc(self) -> bool:
        return self.pos_controller in ("mpc_cbf", "optimal_decay_mpc_cbf")


class TrackerState(NamedTuple):
    x: torch.Tensor  # (B, n) dynamics state
    yaw: torch.Tensor  # (B,) yaw side channel (integrators)
    mode: torch.Tensor  # (B,) int64 state machine
    goal_idx: torch.Tensor  # (B,) int64 waypoint index
    u_prev: torch.Tensor  # (B, m) last applied control
    mpc: mpc_mod.MPCState
    mem: fov_mod.ObsMemory
    ret: torch.Tensor  # (B,) int64 last step's return code
    footprint: torch.Tensor  # (B, nx, ny) occupancy grid; (B, 1, 1) when unused
    att_gk: gk_att_mod.GatekeeperAttState  # yaw-gatekeeper commitment


class StepOutput(NamedTuple):
    state: TrackerState
    u: torch.Tensor  # (B, m)
    ret: torch.Tensor  # (B,) int64 return code of this step
    feasible: torch.Tensor  # (B,) bool
    goal: torch.Tensor  # (B, 2) active goal (or the last waypoint)
    # The safety-area mask checked this step: (B, nx, ny) with a grid in
    # 'safety_area' visibility mode, else a (B, 1, 1) placeholder.
    safety_mask: torch.Tensor


def orientation_of(cfg: TrackerConfig, x, yaw):
    """Robot heading: the theta state of heading models, the side-channel
    yaw of the integrators."""
    if cfg.model_name in _INTEGRATORS:
        return yaw
    return x[..., 2]


def angle_window(model_name: str) -> float:
    """Per-model 'unpassed' angular window."""
    if model_name in (spec_mod.UNICYCLE_2D, spec_mod.DYNAMIC_UNICYCLE_2D, spec_mod.VTOL_2D):
        return math.pi * 1.2
    return math.pi * 2.0


def _dummy_rows(shape, *, device, dtype):
    """Dummy obstacle rows ``shape + (7,)``, made on the device."""
    rows = torch.zeros(tuple(shape) + (OBS_DIM,), device=device, dtype=dtype)
    rows[..., :2].fill_(DUMMY_OBS_POS)  # a fill, no host-made scalar tensor
    return rows


def init_state(cfg: TrackerConfig, spec, x0, yaw0=0.0, first_goal=None, *, device=None,
               dtype=torch.float32) -> TrackerState:
    """Initial states of B robots from ``x0 (B, n)`` (or one ``(n,)``) and
    ``yaw0`` (a float or ``(B,)``).

    The mode is 'track' if the first goal lies inside the FoV cone, else
    'stop' (which converges through stop -> rotate -> track); Quad2D, VTOL2D
    and Manipulator2D always start in 'track'.  ``device``: that of ``x0``
    when it is a tensor, else the card.
    """
    if device is None:
        device = x0.device if isinstance(x0, torch.Tensor) else "cuda"
    model = get_model(cfg.model_name)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    x0 = x0.reshape(-1, model.N_STATES)
    B = x0.shape[0]
    yaw0 = torch.as_tensor(yaw0, dtype=dtype, device=device).expand(B).clone()
    if cfg.model_name in _SKIP_ROTATE or first_goal is None:
        mode0 = torch.full((B,), TRACK, dtype=torch.long, device=device)
    else:
        goal = torch.as_tensor(first_goal, dtype=dtype, device=device)
        in_fov = fov_mod.is_in_fov(model.barrier_pos(x0), orientation_of(cfg, x0, yaw0),
                                   goal, spec)
        mode0 = torch.where(in_fov, TRACK, STOP).long()
    if cfg.grid is not None:
        fp = grid_mod.init_footprint(cfg.grid, model.barrier_pos(x0), spec)
    else:
        fp = torch.zeros((B, 1, 1), dtype=torch.bool, device=device)
    zero = torch.zeros((B,), dtype=torch.long, device=device)
    return TrackerState(
        x=x0,
        yaw=yaw0,
        mode=mode0,
        goal_idx=zero,
        u_prev=torch.zeros((B, model.N_CONTROLS), dtype=dtype, device=device),
        mpc=mpc_mod.init_state(cfg.model_name, cfg.mpc, B, device=device, dtype=dtype),
        mem=fov_mod.init_memory(cfg.mem_slots, B, device=device, dtype=dtype),
        ret=torch.full((B,), RET_OK, dtype=torch.long, device=device),
        footprint=fp,
        att_gk=gk_att_mod.init_state(cfg.gk_att, B, device=device, dtype=dtype),
    )


def select_obstacles(cfg: TrackerConfig, spec, pos, heading, all_obs, speed=0.0):
    """Nearest-K unpassed obstacle selection: ``pos (B, 2)``, ``heading
    (B,)``, ``all_obs (B, Ka, 7)`` padded -> ``(B, num_obs, 7)`` padded.

    Preference: valid, then unpassed, then near.  A reversing robot
    (``speed < 0``) also keeps the obstacles unpassed with respect to its
    direction of motion (heading + pi).  Equal scores keep the lower index
    first, as ``lax.top_k`` does: a stable sort, and the first k.  The order
    of the selection is the order of the solver's constraint rows.
    """
    B, Ka = all_obs.shape[:2]
    dtype = all_obs.dtype
    half = angle_window(cfg.model_name) / 2.0
    valid = ~is_dummy(all_obs)
    to_obs = all_obs[..., :2] - pos[:, None, :]
    dist = norm2(to_obs)
    ang = torch.atan2(to_obs[..., 1], to_obs[..., 0])
    rel = ang - heading[:, None]
    unpassed = torch.abs(angle_normalize(rel)) <= half
    unpassed_rev = torch.abs(angle_normalize(rel - math.pi)) <= half
    if isinstance(speed, torch.Tensor):
        unpassed = unpassed | ((speed < -1e-3)[:, None] & unpassed_rev)
    elif speed < -1e-3:
        unpassed = unpassed | unpassed_rev
    any_unpassed = torch.any(unpassed & valid, dim=-1, keepdim=True)

    big = 1e6
    score = (dist + big * (~valid).to(dtype)
             + 0.5 * big * (~unpassed & any_unpassed).to(dtype))
    k = min(cfg.num_obs, Ka)
    idx = torch.sort(score, dim=-1, stable=True).indices[:, :k]
    sel = torch.gather(all_obs, 1, idx[..., None].expand(B, k, OBS_DIM))
    # Passed rows are dropped when unpassed ones exist.
    sel_valid = torch.gather(valid & ~(any_unpassed & ~unpassed), 1, idx)
    dummies = _dummy_rows((B, cfg.num_obs), device=all_obs.device, dtype=dtype)
    sel = torch.where(sel_valid[..., None], sel, dummies[:, :k])
    if k < cfg.num_obs:
        sel = torch.cat([sel, dummies[:, k:]], dim=1)
    return sel


def _collides(spec, pos, obs):
    """Circle / superellipsoid collision oracle: ``pos (B, 2)``, ``obs
    (B, K, 7)`` -> ``(B, K)``."""
    r = spec.radius
    p = pos[:, None, :]
    circle_hit = norm2(p - obs[..., :2]) < obs[..., OBS_R] + r

    # superellipsoid inside-test
    a = torch.clamp_min(torch.abs(obs[..., 2]), 1e-3)
    b = torch.clamp_min(torch.abs(obs[..., 3]), 1e-3)
    e = torch.clamp_min(torch.abs(obs[..., 4]), 2.0)
    th = obs[..., 5]
    ct, st = torch.cos(th), torch.sin(th)
    dx, dy = p[..., 0] - obs[..., 0], p[..., 1] - obs[..., 1]
    px = ct * dx + st * dy
    py = -st * dx + ct * dy
    h = torch.pow(torch.abs(px) / (a + r), e) + torch.pow(torch.abs(py) / (b + r), e) - 1.0
    se_hit = h <= 0.0

    is_se = (obs[..., OBS_FLAG] >= 0.5) & (obs[..., 4] >= 2.0)
    return ~is_dummy(obs) & torch.where(is_se, se_hit, circle_hit)


def collision_any(spec, pos, obs_sets):
    return torch.any(_collides(spec, pos, obs_sets), dim=-1)


def _keep(frozen, old, new):
    """``old`` where a robot is frozen, else ``new`` (any trailing shape)."""
    if new is old:
        return old
    return torch.where(frozen.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)


def step(cfg: TrackerConfig, spec, state: TrackerState, waypoints, n_waypoints, known_obs,
         unknown_obs=None) -> StepOutput:
    """One control step for the batch.

    ``waypoints (W, >=2)`` or ``(B, W, >=2)`` padded, ``n_waypoints`` the
    real count (an int, or ``(B,)``), ``known_obs`` and ``unknown_obs``
    padded ``(K, 7)`` or ``(B, K, 7)``.  Traced as the span
    ``tracking.step`` (the host's time to enqueue the step), with the MPC
    solve's call as ``tracking.solve``.
    """
    with span("tracking.step"):
        return _step(cfg, spec, state, waypoints, n_waypoints, known_obs, unknown_obs)


def _step(cfg: TrackerConfig, spec, state: TrackerState, waypoints, n_waypoints, known_obs,
          unknown_obs) -> StepOutput:
    model = get_model(cfg.model_name)
    x, yaw, mode, goal_idx = state.x, state.yaw, state.mode, state.goal_idx
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    pos = model.barrier_pos(x)
    heading = orientation_of(cfg, x, yaw)
    wps = per_robot(waypoints[..., :2], B).to(dtype)
    W = wps.shape[1]
    known = per_robot(known_obs, B)

    # ---- state machine + goal update --------------------------------------
    stopped = model.has_stopped(x, spec)
    mode = torch.where((mode == STOP) & stopped, ROTATE if cfg.enable_rotation else TRACK, mode)

    # waypoint advance
    wp = take_rows(wps, torch.clamp(goal_idx, 0, W - 1))
    reached = (norm2(pos - wp) < cfg.reached_threshold) & (goal_idx < n_waypoints) & (mode != STOP)
    goal_idx = torch.where(reached, goal_idx + 1, goal_idx)
    all_done = goal_idx >= n_waypoints
    mode = torch.where(all_done & (mode != STOP), IDLE, mode)
    wp = take_rows(wps, torch.clamp(goal_idx, 0, W - 1))

    # rotate-alignment check (on the normalized angle difference)
    goal_angle = torch.atan2(wp[:, 1] - pos[:, 1], wp[:, 0] - pos[:, 0])
    aligned = torch.abs(angle_normalize(heading - goal_angle)) <= cfg.rotation_threshold
    skip_rotate = cfg.model_name in _SKIP_ROTATE or not cfg.enable_rotation
    mode = torch.where((mode == ROTATE) & (aligned | skip_rotate) & ~all_done, TRACK, mode)

    # ---- perception --------------------------------------------------------
    mem = state.mem
    sensing = cfg.use_sensor and unknown_obs is not None
    if sensing:
        unknown = per_robot(unknown_obs, B)
        if cfg.detection_mode == "ray":
            # Obstacles are detected through the accumulated footprint, and
            # the controller sees only the current detections: the
            # persistent memory belongs to 'fov' mode.
            det, det_mask = fov_mod.detect_unknown_obs_ray(pos, unknown, state.footprint,
                                                           cfg.grid)
            detected = torch.where(det_mask[..., None], det,
                                   _dummy_rows(det_mask.shape, device=dev, dtype=dtype))
        else:
            det, det_mask = fov_mod.detect_unknown_obs_fov(pos, heading, unknown, spec)
            mem = fov_mod.merge_memory(mem, det, det_mask)
            detected = torch.where(mem.valid[..., None], mem.slots,
                                   _dummy_rows(mem.valid.shape, device=dev, dtype=dtype))
        all_obs = torch.cat([known, detected], dim=1)
    else:
        all_obs = known
    # Signed speed for the motion-aware window (x[3] on v-state models).
    if cfg.model_name not in _INTEGRATORS and model.N_STATES >= 4:
        speed = x[:, 3]
    else:
        speed = 0.0
    obs_sel = select_obstacles(cfg, spec, pos, heading, all_obs, speed)

    # ---- nominal input ------------------------------------------------------
    if cfg.pos_controller == "optimal_decay_cbf_qp":
        # Softer nominal gains for the optimal-decay QP.
        spec_nom = spec.replace(nominal_k_omega=3.0, nominal_k_a=0.5, nominal_k_v=0.5)
    else:
        spec_nom = spec
    u_track = model.nominal_input(x, wp, spec_nom)
    u_stop = model.stop(x, spec)
    if cfg.model_name in _INTEGRATORS:
        u_rotate = u_stop
    else:
        u_rotate = model.rotate_to(x, goal_angle, spec)
    u_ref = torch.where((mode == TRACK)[:, None], u_track,
                        torch.where((mode == ROTATE)[:, None], u_rotate, u_stop))

    # ---- position controller -------------------------------------------------
    mpc_xs = None  # (B, N+1, n) prediction, for the yaw gatekeeper
    mpc_state = state.mpc
    if cfg.pos_controller == "cbf_qp":
        backend = "pallas" if dev.type == "cuda" and dtype == torch.float32 else "xla"
        qp = cbf_qp_mod.solve_batch(cfg.model_name, spec, x, u_ref, obs_sel, cfg.dt,
                                    backend=backend, mode=cfg.cbf_mode, iters=cfg.qp_iters)
        u, feasible = qp.u, qp.feasible
    elif cfg.pos_controller == "optimal_decay_cbf_qp":
        # The nearest obstacle only.
        od = od_qp_mod.solve(cfg.model_name, spec, x, u_ref, obs_sel[:, 0], cfg.dt,
                             iters=cfg.qp_iters)
        u, feasible = od.u, od.feasible
    elif cfg.uses_mpc:
        goal_full = torch.zeros((B, model.N_STATES), dtype=dtype, device=dev)
        goal_full[:, :2] = wp
        with span("tracking.solve"):
            res = mpc_mod.solve_dispatch(
                cfg.model_name, spec, x, goal_full, obs_sel[:, : cfg.mpc.num_obs], state.u_prev,
                state.mpc, cfg.dt, cfg.mpc,
            )
        # The MPC acts only in 'track'; otherwise the reference passes through.
        u = torch.where((mode == TRACK)[:, None], res.u, u_ref)
        if cfg.strict_mpc_feasibility:
            feasible = res.feasible | (mode != TRACK)
        else:
            feasible = torch.ones((B,), dtype=torch.bool, device=dev)
        mpc_state = res.state
        mpc_xs = res.xs
    else:
        raise ValueError(f"unknown pos controller {cfg.pos_controller}")

    # ---- attitude controller (integrators) -----------------------------------
    gk_state = state.att_gk
    if cfg.model_name in _INTEGRATORS and cfg.att_controller != "none":
        if cfg.att_controller == "velocity_tracking_yaw":
            u_att_track = velocity_tracking_yaw(cfg.model_name, spec, x, yaw, u)
        elif cfg.att_controller == "simple":
            u_att_track = torch.full((B,), spec.w_max, dtype=dtype, device=dev)
        elif cfg.att_controller == "visibility_area":
            u_att_track = vis_mod.visibility_area_yaw(state.footprint, cfg.grid, pos, yaw, spec)
        elif cfg.att_controller == "visibility_raycast":
            u_att_track = vis_mod.visibility_raycast_yaw(state.footprint, cfg.grid, pos, yaw,
                                                         spec)
        elif cfg.att_controller == "gatekeeper":
            # Positional prediction: the MPC trajectory when there is one,
            # else a zero-control rollout from the current state.
            T = cfg.gk_att.total_steps
            x_pred = mpc_xs if mpc_xs is not None else x[:, None]
            x_pred = gk_att_mod.extend_prediction(model, spec, x_pred, cfg.dt, T)
            pos_traj = x_pred[..., :2]
            if model.N_STATES >= 4:
                vel_traj = x_pred[..., 2:4]
            else:  # SingleIntegrator2D: velocity from position differences
                dp = (pos_traj[:, 1:] - pos_traj[:, :-1]) / cfg.dt
                vel_traj = torch.cat([dp, dp[:, -1:]], dim=1)
            u_att_track, gk_new, _ = gk_att_mod.step(
                cfg.gk_att, spec, cfg.model_name, state.att_gk, state.footprint, cfg.grid,
                pos_traj, vel_traj, yaw,
            )
            # The attitude controller runs only in 'track': its commitment
            # is frozen otherwise.
            tracking = mode == TRACK
            gk_state = gk_att_mod.GatekeeperAttState(
                *(_keep(~tracking, old, new) for old, new in zip(state.att_gk, gk_new)))
        else:
            raise ValueError(f"unknown att controller {cfg.att_controller}")
        u_att_rotate = model.yaw_rate_to(yaw, goal_angle, spec)
        u_att = torch.where(mode == TRACK, u_att_track,
                            torch.where(mode == ROTATE, u_att_rotate, torch.zeros_like(yaw)))
        yaw_next = angle_normalize(yaw + u_att * cfg.dt)
    else:
        u_att = torch.zeros_like(yaw)
        yaw_next = yaw

    # ---- verdicts + integration ----------------------------------------------
    # The oracle checks the true obstacles (known + raw unknown), not the
    # detections the controller sees.
    oracle_obs = torch.cat([known, unknown], dim=1) if sensing else all_obs
    collide_pre = collision_any(spec, pos, oracle_obs)
    x_next = model.step(x, u, spec, cfg.dt)
    pos_next = model.barrier_pos(x_next)
    collide_post = collision_any(spec, pos_next, oracle_obs)
    if cfg.model_name == spec_mod.VTOL_2D:
        # Ground strike and pitch limit.  'reference' compares the pitch
        # (radians) with the spec's pitch_max as it stands (degrees), which
        # never fires at the default; 'strict' converts it to radians.
        if cfg.vtol_pitch_oracle == "strict":
            pitch_lim = torch.full((), spec.pitch_max, dtype=dtype, device=dev) * (math.pi / 180)
        else:
            pitch_lim = spec.pitch_max
        collide_pre = collide_pre | (x[:, 1] < 0.0) | (torch.abs(x[:, 2]) > pitch_lim)
        collide_post = collide_post | (x_next[:, 1] < 0.0) | (torch.abs(x_next[:, 2]) > pitch_lim)
    bad = ~feasible | collide_pre | collide_post

    # The yaw of heading models tracks theta.
    if cfg.model_name not in _INTEGRATORS:
        yaw_next = x_next[:, 2]

    # ---- sensing footprint + visibility violation -----------------------------
    footprint = state.footprint
    beyond = torch.zeros((B,), dtype=torch.bool, device=dev)
    safety_mask = torch.zeros((B, 1, 1), dtype=torch.bool, device=dev)
    if cfg.grid is not None and cfg.use_sensor:
        footprint = grid_mod.update_footprint(footprint, cfg.grid, pos_next, yaw_next, spec)
        if cfg.visibility_mode == "safety_area":
            # Speed and yaw rate per model; the decelerating-arc branch runs
            # whenever the live yaw rate is non-zero.
            vel = None
            if cfg.model_name == spec_mod.SINGLE_INTEGRATOR_2D:
                vel = u[:, :2]
                v_mag, yaw_rate = norm2(vel), u_att
            elif cfg.model_name == spec_mod.DOUBLE_INTEGRATOR_2D:
                vel = x_next[:, 2:4]
                v_mag, yaw_rate = norm2(vel), u_att
            elif cfg.model_name == spec_mod.UNICYCLE_2D:
                v_mag, yaw_rate = u[:, 0], u[:, 1]
            elif cfg.model_name in (spec_mod.QUAD_2D, spec_mod.VTOL_2D):
                v_mag, yaw_rate = norm2(x_next[:, 3:5]), x_next[:, 5]
            elif cfg.model_name == spec_mod.QUAD_3D:
                v = x_next[:, 6:9]
                v_mag = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
                yaw_rate = x_next[:, 11]
            else:  # DynamicUnicycle2D / KinematicBicycle2D family
                v_mag = x_next[:, 3] if model.N_STATES >= 4 else torch.zeros_like(yaw)
                yaw_rate = u[:, 1]
            tube = grid_mod.safety_area_mask(
                cfg.grid, pos_next, yaw_next, v_mag, yaw_rate, spec, cfg.dt,
                max_decel=cfg.max_decel, max_ang_decel=cfg.max_ang_decel,
                integrator=cfg.model_name in _INTEGRATORS, vel=vel,
            )
            safety_mask = tube
            beyond = grid_mod.is_beyond_footprint(footprint, cfg.grid, pos_next, safety_mask=tube)
        else:
            beyond = grid_mod.is_beyond_footprint(footprint, cfg.grid, pos_next)

    ret = torch.where(bad, RET_INFEASIBLE, torch.where(
        all_done & (mode != STOP), RET_DONE, torch.where(beyond, RET_VISIBILITY, RET_OK)))

    # Freeze the robots with terminal codes (-1/-2) so that the rest of the
    # batch runs on; a visibility violation (+1) does not stop a run.
    frozen = state.ret < 0
    new_state = TrackerState(
        x=_keep(frozen, state.x, x_next),
        yaw=_keep(frozen, state.yaw, yaw_next),
        mode=_keep(frozen, state.mode, mode),
        goal_idx=_keep(frozen, state.goal_idx, goal_idx),
        u_prev=_keep(frozen, state.u_prev, u),
        mpc=mpc_mod.MPCState(*(_keep(frozen, a, b) for a, b in zip(state.mpc, mpc_state))),
        mem=fov_mod.ObsMemory(*(_keep(frozen, a, b) for a, b in zip(state.mem, mem))),
        ret=_keep(frozen, state.ret, ret.long()),
        footprint=_keep(frozen, state.footprint, footprint),
        att_gk=gk_att_mod.GatekeeperAttState(
            *(_keep(frozen, a, b) for a, b in zip(state.att_gk, gk_state))),
    )
    return StepOutput(state=new_state, u=u, ret=new_state.ret, feasible=feasible, goal=wp,
                      safety_mask=safety_mask)


def run(cfg: TrackerConfig, spec, state: TrackerState, waypoints, n_waypoints, known_obs,
        n_steps: int, unknown_obs=None):
    """``n_steps`` steps of the batch.  Returns ``(final_state, traj)``,
    ``traj`` a dict of the per-step ``x (B, n_steps, n)``, ``u (B, n_steps,
    m)`` and ``ret (B, n_steps)``, stacked on the device: nothing is read
    back to the host."""
    xs, us, rets = [], [], []
    for _ in range(n_steps):
        out = step(cfg, spec, state, waypoints, n_waypoints, known_obs, unknown_obs)
        state = out.state
        xs.append(state.x)
        us.append(out.u)
        rets.append(out.ret)
    return state, dict(x=torch.stack(xs, dim=1), u=torch.stack(us, dim=1),
                       ret=torch.stack(rets, dim=1))


def step_dynamic_obstacles(obs, dt, x_range=None, y_range=None):
    """Advance constant-velocity obstacles ``(..., K, 7)`` one step, the
    velocity in columns 3:5.  With ``x_range``/``y_range``, a velocity
    component flips when the center leaves the workspace."""
    obs = torch.cat([obs[..., 0:2] + obs[..., 3:5] * dt, obs[..., 2:]], dim=-1)
    vx, vy = obs[..., 3], obs[..., 4]
    if x_range is not None:
        flip_x = (obs[..., 0] < x_range[0]) | (obs[..., 0] > x_range[1])
        vx = vx * torch.where(flip_x, -1.0, 1.0).to(obs.dtype)
    if y_range is not None:
        flip_y = (obs[..., 1] < y_range[0]) | (obs[..., 1] > y_range[1])
        vy = vy * torch.where(flip_y, -1.0, 1.0).to(obs.dtype)
    return torch.cat([obs[..., :3], vx[..., None], vy[..., None], obs[..., 5:]], dim=-1)


def run_dynamic(cfg: TrackerConfig, spec, state: TrackerState, waypoints, n_waypoints,
                moving_obs, n_steps: int, x_range=None, y_range=None):
    """Dynamic-environment run: the obstacles advance by their velocities
    every step (bouncing off the given ranges) and are the known set.
    Returns ``(final_state, final_obs, traj)``."""
    xs, us, rets = [], [], []
    obs = moving_obs
    for _ in range(n_steps):
        out = step(cfg, spec, state, waypoints, n_waypoints, obs)
        obs = step_dynamic_obstacles(obs, cfg.dt, x_range, y_range)
        state = out.state
        xs.append(state.x)
        us.append(out.u)
        rets.append(out.ret)
    return state, obs, dict(x=torch.stack(xs, dim=1), u=torch.stack(us, dim=1),
                            ret=torch.stack(rets, dim=1))
