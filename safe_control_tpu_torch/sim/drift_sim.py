"""DriftingCarSimulator: the collision-checked, shielded drift-car loop.

Port of ``safe_control_tpu/sim/drift_sim.py``.  One control step:

1. the puddle friction at the car's position (a host lookup): the PLANT
   runs at the local friction while the planner keeps its nominal ``mu``;
2. the MPCC solve on the nominal-friction model (``solvers/mpcc.py``);
3. shielding: the gatekeeper's backward search, MPS's single-step check or
   the backup CBF-QP, against the obstacle cars predicted at each step;
4. the plant step and the collision verdict (track boundary, obstacle cars
   at time t);
5. the statistics: nominal and backup step counts, h_min, the collision
   step, and the MPCC prediction of each step.

On a card the step is captured once per simulator as a
``torch.cuda.CUDAGraph`` (at the first ``step``, ``core.graphs.CapturedStep``)
and replayed every step: the state, the last input, the plant friction, the
step index and the obstacle cars are copied into the graph's static tensors
before a replay.  ``reset`` keeps the graph, as the JAX package keeps its
compiled program.
A capture that fails raises; ``graph=False`` (asked for explicitly) runs
the same step eagerly on the card.  On the CPU the step runs eagerly.  Each
step reads the device once: the new state, the flags, h_min and the
prediction, in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.core.graphs import CapturedStep
from safe_control_tpu_torch.core.spec import DRIFTING_CAR
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.shielding import backup as bk
from safe_control_tpu_torch.shielding import backup_cbf as bcbf
from safe_control_tpu_torch.shielding import gatekeeper as gk
from safe_control_tpu_torch.solvers import mpcc

ALGO_TYPES = ("gatekeeper", "mps", "backupcbf")
BACKUP_TYPES = ("lane_change", "stop")


@dataclasses.dataclass(frozen=True)
class DriftSimConfig:
    """Scenario knobs; the JAX package's fields, defaults and errors."""

    dt: float = 0.05
    algo: str = "gatekeeper"
    backup: str = "lane_change"
    nominal_steps: int = 40  # gatekeeper nominal horizon (steps)
    backup_steps: int = 60  # backup horizon (steps)
    event_offset_steps: int = 1
    discount_steps: int = 5
    safety_margin: float = 0.01
    target_velocity: float = 10.0

    def __post_init__(self):
        if self.algo not in ALGO_TYPES:
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.backup not in BACKUP_TYPES:
            raise ValueError(f"unknown backup {self.backup!r}")


class _Inputs(NamedTuple):
    """One step's inputs: the graph's static tensors on a card."""

    mstate: mpcc.MPCCState
    gstate: gk.GatekeeperState
    x: torch.Tensor  # (1, 8)
    u_prev: torch.Tensor  # (1, 2)
    mu: torch.Tensor  # () plant friction
    t_idx: torch.Tensor  # () int64 step index
    cars: torch.Tensor  # (M, 6) obstacle cars


def _same_device(a: torch.device, b: torch.device) -> bool:
    """The same device, an unindexed CUDA device meaning any of them."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


class DriftingCarSimulator:
    """Collision-checked shielded drift-car simulation.

    ``spec``: the DriftingCar spec (the PLANNER's friction ``spec.mu``);
    ``env``: a ``DriftingEnv`` on the same device; ``path``: the MPCC
    reference (an ``mpcc.Path`` on the device); ``x0``: the (8,) start;
    ``backup_target_y``: the lane-change target.  ``device``: the card
    unless ``"cpu"`` is asked for.  ``graph``: capture the step as a CUDA
    graph on a card (``False`` runs it eagerly there; it has no effect on
    the CPU).  ``capture_seconds`` is the capture's wall time (warm-up
    included) once it is made.
    """

    def __init__(self, spec, env, path, x0, mpcc_cfg: mpcc.MPCCConfig, cfg: DriftSimConfig,
                 backup_target_y: float = 0.0, *, device="cuda", graph: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DriftingCarSimulator: no CUDA device (pass device='cpu')")
        if not (_same_device(env.device, self.device) and _same_device(path.s.device,
                                                                        self.device)):
            raise ValueError("the environment and the path must be on the simulator's device")
        if mpcc_cfg.horizon < cfg.nominal_steps:
            raise ValueError("the MPCC horizon must cover the gatekeeper's nominal horizon")
        self.spec = spec
        self.env = env
        self.path = path
        self.cfg = cfg
        self.model = get_model(DRIFTING_CAR)
        self._step = CapturedStep(self._step_fn, graph and self.device.type == "cuda")
        self._gcfg = gk.GatekeeperConfig(
            model_name=DRIFTING_CAR, dt=cfg.dt, nominal_steps=cfg.nominal_steps,
            backup_steps=cfg.backup_steps, event_offset_steps=cfg.event_offset_steps,
            discount_steps=cfg.discount_steps, mps_mode=(cfg.algo == "mps"))
        self._bcfg = bcbf.BackupCBFConfig(model_name=DRIFTING_CAR, dt=cfg.dt,
                                          backup_steps=cfg.backup_steps)
        self._mpcc_cfg = mpcc_cfg
        self._gains = bk.LaneChangeGains(
            target_velocity=cfg.target_velocity, delta_max=float(spec.delta_max),
            delta_dot_max=float(spec.delta_dot_max), tau_max=float(spec.tau_max),
            tau_dot_max=float(spec.tau_dot_max))
        self._sgains = bk.StoppingGains(
            delta_max=float(spec.delta_max), delta_dot_max=float(spec.delta_dot_max),
            tau_max=float(spec.tau_max), tau_dot_max=float(spec.tau_dot_max))
        self._target_y = float(backup_target_y)
        self.reset(x0)

    # ------------------------------------------------------------ the step
    def _backup_policy(self, plant):
        if self.cfg.backup == "stop":
            return lambda xx: bk.stopping(xx, plant, self._sgains)
        return lambda xx: bk.lane_change(xx, self._target_y, plant, self._gains)

    def collision_fn(self, xx, t_idx, cars):
        """Boundary and time-synchronized obstacle-car check of states
        ``xx (..., 8)`` at step indices ``t_idx`` (broadcasting)."""
        radius, margin, dt = float(self.spec.radius), self.cfg.safety_margin, self.cfg.dt
        t = (t_idx * dt)[..., None]
        cx = cars[:, 0] + cars[:, 3] * t
        cy = cars[:, 1] + cars[:, 4] * t
        dx = xx[..., 0, None] - cx
        dy = xx[..., 1, None] - cy
        d = torch.sqrt(dx * dx + dy * dy)
        hit = torch.any((d < radius + margin + cars[:, 5]) & (cars[:, 5] > 0), dim=-1)
        return self.env.check_collision(xx[..., :2], radius) | hit

    def h_safety(self, xx, t, cars):
        """Track half-spaces and obstacle cars at time ``t``."""
        radius, margin = float(self.spec.radius), self.cfg.safety_margin
        half = self.env.track_width / 2.0
        h = torch.minimum(half - xx[..., 1] - radius, xx[..., 1] + half - radius)
        t = torch.as_tensor(t, dtype=xx.dtype, device=xx.device)[..., None]
        cx = cars[:, 0] + cars[:, 3] * t
        cy = cars[:, 1] + cars[:, 4] * t
        dx = xx[..., 0, None] - cx
        dy = xx[..., 1, None] - cy
        d = torch.sqrt(dx * dx + dy * dy)
        h_cars = torch.where(cars[:, 5] > 0, d - radius - cars[:, 5] - margin,
                             torch.full_like(d, float("inf")))
        return torch.minimum(h, h_cars.amin(-1))

    def h_terminal(self, xx, cars):
        """Safe at the horizon's end and nearly stopped (stopping backup) or
        in the backup lane (lane change)."""
        t_end = torch.full((), self.cfg.backup_steps * self.cfg.dt, dtype=xx.dtype,
                           device=xx.device)
        base = self.h_safety(xx, t_end, cars)
        if self.cfg.backup == "stop":
            return torch.minimum(base, 1.0 - xx[..., 5] / 5.0)
        return torch.minimum(base, 1.0 - torch.abs(xx[..., 1] - self._target_y))

    def _step_fn(self, inp: _Inputs):
        """One control step on tensors; returns the next ``_Inputs``' state
        parts and the host report ``[x_next (8), u (2), using_backup,
        collided, h_min, prediction (2 (N+1))]``."""
        cfg, dt = self.cfg, self.cfg.dt
        plant = self.spec.replace(mu=inp.mu)
        backup_policy = self._backup_policy(plant)
        mres = mpcc.solve(self.spec, inp.x, self.path, inp.mstate, inp.u_prev, dt,
                          self._mpcc_cfg)
        cars, t_idx = inp.cars, inp.t_idx
        if cfg.algo in ("gatekeeper", "mps"):
            n = cfg.nominal_steps
            out = gk.step(self._gcfg, plant, inp.gstate, inp.x, backup_policy,
                          lambda xx, k: self.collision_fn(xx, t_idx + k, cars),
                          nominal_traj=(mres.xs[:, :n + 1, :8], mres.us[:, :n, :2]))
            u, gstate, using_backup = out.u, out.state, out.using_backup
            h_min = torch.full((1,), float("inf"), dtype=inp.x.dtype, device=inp.x.device)
        else:
            t_now = t_idx * dt
            res = bcbf.solve(self._bcfg, plant, inp.x, mres.u, backup_policy,
                             lambda xx, tt: self.h_safety(xx, t_now + tt, cars),
                             lambda xx: self.h_terminal(xx, cars))
            u, gstate, using_backup, h_min = res.u, inp.gstate, res.using_backup, res.h_min
        x_next = self.model.step(inp.x, u, plant, dt)
        collided = self.collision_fn(x_next, t_idx + 1, cars)
        report = torch.cat([x_next[0], u[0], using_backup.to(u.dtype), collided.to(u.dtype),
                            h_min.to(u.dtype), mres.xs[0, :, :2].reshape(-1)])
        return mres.state, gstate, x_next, u, report

    # ------------------------------------------------------------------ API
    def reset(self, x0, env=None) -> None:
        """Re-arm for a fresh run (optionally with a new env of the same track
        width).  The captured graph is kept: the obstacle cars enter as
        inputs and the puddle friction is a host lookup."""
        if env is not None:
            if env.track_width != self.env.track_width or not _same_device(env.device,
                                                                            self.device):
                raise ValueError("a new environment must share the track width and device")
            self.env = env
        dev = self.device
        x = torch.as_tensor(np.asarray(x0, dtype=np.float32), device=dev).reshape(1, 8)
        fresh = _Inputs(
            mstate=mpcc.init_state(self._mpcc_cfg, 1, device=dev),
            gstate=gk.init_state(self._gcfg, 1, device=dev),
            x=x, u_prev=torch.zeros((1, 2), device=dev),
            mu=torch.zeros((), device=dev), t_idx=torch.zeros((), dtype=torch.long, device=dev),
            cars=torch.as_tensor(self.env.obstacle_cars_np, device=dev))
        self._inputs = fresh
        self._cars_host = self.env.obstacle_cars_np
        self.t_idx = 0
        self._x_host = np.asarray(x0, dtype=np.float32).reshape(8)
        self.stats = dict(nominal_steps=0, backup_steps=0, collision=False,
                          collision_step=None, global_min_h=np.inf)
        self.trajectory = []
        self.predictions = []

    @property
    def x(self) -> torch.Tensor:
        """The current (8,) state on the device."""
        return self._inputs.x[0]

    @property
    def mstate(self) -> mpcc.MPCCState:
        return self._inputs.mstate

    @property
    def gstate(self) -> gk.GatekeeperState:
        return self._inputs.gstate

    @property
    def capture_seconds(self):
        """The capture's wall time (warm-up included) once it is made."""
        return self._step.capture_seconds

    def graph_nodes(self):
        """Nodes of the captured graph, or None (see ``CapturedStep``)."""
        return self._step.graph_nodes()

    def step(self) -> bool:
        """Advance one control step; returns True if a collision occurred."""
        inp = self._inputs
        pos = torch.as_tensor(self._x_host[:2])
        mu = float(self.env.get_friction_at_position(pos, default_friction=float(self.spec.mu)))
        cars_now = self.env.obstacle_cars_np
        if not np.array_equal(cars_now, self._cars_host):
            inp.cars.copy_(torch.as_tensor(cars_now))
            self._cars_host = cars_now
        inp.mu.fill_(mu)
        inp.t_idx.fill_(self.t_idx)
        mstate, gstate, x_next, u, report = self._step(inp)
        self._inputs = inp._replace(mstate=mstate, gstate=gstate, x=x_next, u_prev=u)
        rep = report.cpu().numpy()
        self.t_idx += 1
        self._x_host = rep[:8].copy()
        self.trajectory.append(self._x_host)
        self.predictions.append(rep[13:].reshape(-1, 2))
        if rep[10] != 0.0:
            self.stats["backup_steps"] += 1
        else:
            self.stats["nominal_steps"] += 1
        hm = float(rep[12])
        if np.isfinite(hm):
            self.stats["global_min_h"] = min(self.stats["global_min_h"], hm)
        collided = bool(rep[11] != 0.0)
        if collided:
            self.stats["collision"] = True
            if self.stats["collision_step"] is None:
                self.stats["collision_step"] = self.t_idx
        return collided

    def run(self, tf: float) -> dict:
        """Run until ``tf`` seconds or the first collision."""
        n = int(round(tf / self.cfg.dt))
        for _ in range(n):
            if self.step():
                break
        out = dict(self.stats)
        out["x_final"] = self._x_host.copy()
        out["trajectory"] = np.asarray(self.trajectory)
        return out
