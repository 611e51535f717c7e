"""Host-side controller with the reference tracker's imperative API.

Port of ``safe_control_tpu/sim/controller.py``: the same constructor
(``X0, robot_spec dict, controller_type dict, dt, env``), the same methods
(``set_waypoints``, ``set_unknown_obs``, ``control_step``,
``get_control_input``, ``run_all_steps``) and the same return codes.  It
drives one robot through ``sim/tracking.py`` (a batch of one) on
``device``, the card unless the caller asks for ``device="cpu"``.

Waypoints and obstacles stay resident on the device, re-uploaded only when
their content changes; ``control_step`` makes one device-to-host copy.

On the card the control step (``tracking.step``) is captured as one CUDA
graph at the first ``control_step`` and replayed after, the counterpart of
the JAX controller's ``jax.jit``: every configuration of the tracker, since
its step reads nothing back to the host and makes every constant once
(``core.types.device_constant``).  Each step copies the state, the
waypoints, their count and the obstacles into the graph's fixed-shape
inputs, and the new state out of its outputs.  The graph is kept for the
process, one per configuration (tracker config, robot spec, device), so
that a later controller of the same configuration replays it too, as a
jitted function's compiled program is reused.  The one device-to-host copy
stays outside the graph.  On the CPU the step runs eagerly.  Which of the
two a controller does is decided from its device at construction and
logged once.  Nothing catches a failed capture.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from safe_control_tpu_torch.attitude.gatekeeper_att import GatekeeperAttConfig
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.core.graphs import CapturedStep
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.perception.grid import GridSpec
from safe_control_tpu_torch.sim import tracking
from safe_control_tpu_torch.solvers import mpc_cbf as mpc_mod
from safe_control_tpu_torch.utils.profiling import span

_tree = torch.utils._pytree

MAX_WAYPOINTS = 32
MAX_KNOWN_OBS = 32
MAX_UNKNOWN_OBS = 16


class InfeasibleError(Exception):
    """Raised when the QP is infeasible or the robot collides."""


_SPEC_KEYS = {
    "v_max", "v_min", "w_max", "a_max", "ax_max", "ay_max", "radius",
    "wheel_base", "body_width", "front_ax_dist", "rear_ax_dist", "delta_max",
    "beta_max", "f_min", "f_max", "u_min", "u_max", "mass", "inertia",
    "throttle_min", "throttle_max", "elevator_min", "elevator_max",
    "descent_speed_max", "pitch_max", "nominal_k_v", "nominal_k_a",
    "nominal_k_omega", "cbf_alpha", "cbf_alpha1", "cbf_alpha2",
    "mpc_cbf_alpha", "mpc_cbf_alpha1", "mpc_cbf_alpha2", "reached_threshold",
    "cam_range",
}


def spec_from_dict(robot_spec: Dict) -> spec_mod.RobotSpec:
    """A :class:`RobotSpec` from a reference-style robot_spec dict."""
    model = robot_spec["model"]
    overrides = {k: float(v) for k, v in robot_spec.items() if k in _SPEC_KEYS}
    if "fov_angle" in robot_spec:
        # The dict holds fov_angle in degrees.
        overrides["fov_angle"] = math.radians(float(robot_spec["fov_angle"]))
    if "Kp" in robot_spec:  # the manipulator's gain key
        overrides["kp"] = float(robot_spec["Kp"])
    return spec_mod.make_spec(model, **overrides)


_MODES_LOGGED: set = set()
# (tracker config, spec, device) -> the control step
_STEPS: Dict[tuple, CapturedStep] = {}


def _log_mode_once(model_name, pos, att, captured) -> None:
    """Log once per configuration whether its control step is captured."""
    key = (model_name, pos, att, captured)
    if key in _MODES_LOGGED:
        return
    _MODES_LOGGED.add(key)
    how = "captured as one CUDA graph" if captured else "eager (the CPU)"
    logging.getLogger("safe_control_tpu_torch.sim").info(
        "LocalTrackingController %s %s/%s: control step %s", model_name, pos, att, how)


class LocalTrackingController:
    def __init__(
        self,
        X0,
        robot_spec: Dict,
        controller_type: Optional[Dict] = None,
        dt: float = 0.05,
        show_animation: bool = False,
        save_animation: bool = False,
        enable_rotation: bool = True,
        raise_error: bool = False,
        env=None,
        ax=None,
        fig=None,
        device="cuda",
        **_ignored,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LocalTrackingController runs on the card by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        controller_type = controller_type or {}
        self.robot_spec = dict(robot_spec)
        self.model_name = robot_spec["model"]
        self.dt = dt
        self.raise_error = raise_error
        self.spec = spec_from_dict(robot_spec)
        model = get_model(self.model_name)

        X0 = np.asarray(X0, dtype=float).reshape(-1)
        X0, yaw0 = self._pad_x0(X0, model)
        self._x0 = X0
        self._yaw0 = yaw0

        # N=30 for VTOL2D and 10 otherwise, unless the dict says.
        default_horizon = 30 if self.model_name == spec_mod.VTOL_2D else 10
        horizon = int(robot_spec.get("mpc_horizon", default_horizon))
        # Manipulator2D defaults to 150 constraint slots (5 obstacles x 30
        # link circles); everyone else to 10.
        default_constraints = 150 if self.model_name == spec_mod.MANIPULATOR_2D else 10
        num_constraints = int(robot_spec.get("num_constraints", default_constraints))
        if self.model_name == spec_mod.MANIPULATOR_2D:
            # The CBF-QP expands the link-circle rows itself, so num_obs is
            # the obstacle count, not the row count.
            num_constraints = max(num_constraints // 30, 1)

        use_sensor = robot_spec.get("sensor") == "rgbd"
        pos_type = controller_type.get("pos", "cbf_qp")
        att_type = controller_type.get("att", "velocity_tracking_yaw")
        detection = str(robot_spec.get("unknown_obs_detection", "fov")).lower()

        # The sensing footprint grid, sized from the env's workspace.
        grid = None
        needs_grid = (
            use_sensor
            or detection == "ray"
            or att_type in ("visibility_raycast", "visibility_area", "gatekeeper")
        )
        if needs_grid:
            if env is not None:
                grid = GridSpec(
                    width=float(getattr(env, "width", 20.0)),
                    height=float(getattr(env, "height", 20.0)),
                    resolution=float(getattr(env, "resolution", 0.1)),
                )
            else:
                grid = GridSpec(width=20.0, height=20.0)

        gk_att = GatekeeperAttConfig(
            dt=dt,
            nominal_horizon=float(robot_spec.get("gatekeeper_nominal_horizon", 1.0)),
            backup_horizon=float(robot_spec.get("gatekeeper_backup_horizon", 2.0)),
            event_offset=float(robot_spec.get("gatekeeper_event_offset", 0.5)),
            horizon_discount=float(
                robot_spec.get("gatekeeper_horizon_discount", max(5 * dt, dt))
            ),
            validation_slack=float(robot_spec.get("gatekeeper_validation_slack", 0.05)),
            tube_margin=float(robot_spec.get("gatekeeper_validation_tube_margin", 0.0)),
            braking_distance_scale=float(
                robot_spec.get("gatekeeper_braking_distance_scale", 1.0)
            ),
            braking_distance_margin=float(
                robot_spec.get(
                    "gatekeeper_braking_distance_margin", float(self.spec.radius) + 0.10
                )
            ),
        )
        self.cfg = tracking.TrackerConfig(
            model_name=self.model_name,
            pos_controller=pos_type,
            att_controller=att_type,
            dt=dt,
            num_obs=num_constraints,
            enable_rotation=enable_rotation,
            use_sensor=use_sensor,
            detection_mode=detection,
            cbf_mode=str(robot_spec.get("cbf_mode", "cbf")),
            reached_threshold=float(robot_spec.get("reached_threshold", 0.3)),
            mpc=self._build_mpc_cfg(robot_spec, horizon, pos_type),
            grid=grid,
            visibility_mode=str(
                robot_spec.get("visibility_violation_mode", "safety_area")
            ).lower(),
            strict_mpc_feasibility=bool(robot_spec.get("strict_mpc_feasibility", False)),
            gk_att=gk_att,
        )

        env_obs = np.zeros((0, 7))
        if env is not None and getattr(env, "obs_circle", None) is not None:
            oc = np.asarray(env.obs_circle, dtype=float)
            if oc.size:
                env_obs = np.hstack([oc, np.zeros((oc.shape[0], 7 - oc.shape[1]))])
        self.obs = env_obs  # user-assignable, and may be mutated in place
        self.unknown_obs = np.zeros((0, 7))

        self.waypoints = np.zeros((0, 2))
        self.state = None
        self.u_pos = np.zeros(model.N_CONTROLS)
        self.last_safety_mask = None
        self._dev_key = None
        self._dev_cache = None
        self.captured = self.device.type == "cuda"
        _log_mode_once(self.model_name, pos_type, att_type, self.captured)

    @staticmethod
    def _build_mpc_cfg(robot_spec, horizon, pos_type):
        """MPC configuration from robot_spec keys.

        - ``use_fused_kernel``: opt-in fused MPC kernel (one launch a step).
        - ``mpc_outer_iters`` / ``mpc_newton_iters``: the iteration budget.
        - ``mpc_scan_unroll`` / ``mpc_loop_unroll``: accepted; they steer
          XLA's unrolling in the JAX package and have no effect here.
        - ``mpc_rti``: True selects the real-time-iteration budget
          (``MPCConfig.rti``, 2 outer x 2 Newton); ``mpc_outer_iters`` /
          ``mpc_newton_iters`` override either preset.
        """
        kw = dict(
            horizon=horizon,
            num_obs=5,
            optimal_decay=(pos_type == "optimal_decay_mpc_cbf"),
            use_fused_kernel=bool(robot_spec.get("use_fused_kernel", False)),
        )
        if "mpc_scan_unroll" in robot_spec:
            kw["scan_unroll"] = int(robot_spec["mpc_scan_unroll"])
        base = mpc_mod.MPCConfig.rti if robot_spec.get("mpc_rti") else mpc_mod.MPCConfig
        if "mpc_outer_iters" in robot_spec:
            kw["outer_iters"] = int(robot_spec["mpc_outer_iters"])
        if "mpc_newton_iters" in robot_spec:
            kw["newton_iters"] = int(robot_spec["mpc_newton_iters"])
        if "mpc_loop_unroll" in robot_spec:
            kw["loop_unroll"] = bool(robot_spec["mpc_loop_unroll"])
        return base(**kw)

    @staticmethod
    def _pad_x0(X0, model):
        """Model-specific initial-state padding."""
        n = model.N_STATES
        yaw0 = 0.0
        if X0.shape[0] == n:
            return X0, (X0[2] if n >= 3 else 0.0)
        if X0.shape[0] == 2:
            x = np.zeros(n)
            x[:2] = X0
            return x, 0.0
        if X0.shape[0] == 3:
            x = np.zeros(n)
            x[:2] = X0[:2]
            if n >= 3:
                x[2] = X0[2]
            yaw0 = X0[2]
            return x, yaw0
        raise ValueError(f"Invalid initial state dim {X0.shape[0]} for {model}")

    # ------------------------------------------------------------------ API
    def set_waypoints(self, waypoints):
        wps = np.asarray(waypoints, dtype=float)
        self.waypoints = self._filter_waypoints(wps)
        first_goal = self.waypoints[0][:2] if len(self.waypoints) else None
        self.state = tracking.init_state(
            self.cfg, self.spec, self._x0, self._yaw0, first_goal=first_goal,
            device=self.device,
        )

    def _filter_waypoints(self, waypoints):
        """Drop leading waypoints closer than reached_threshold."""
        if len(waypoints) < 2:
            return waypoints
        robot_pos = np.asarray(self._x0[:2])
        aug = np.vstack([robot_pos, waypoints[:, :2]])
        dists = np.linalg.norm(np.diff(aug, axis=0), axis=1)
        mask = np.concatenate(([False], dists >= self.cfg.reached_threshold))
        out = aug[mask]
        return out if len(out) else waypoints[-1:, :2]

    def set_unknown_obs(self, unknown_obs):
        uo = np.asarray(unknown_obs, dtype=float)
        if uo.ndim == 1 and uo.size:
            uo = uo.reshape(1, -1)
        if uo.size == 0:
            uo = np.zeros((0, 7))
        elif uo.shape[1] < 7:
            uo = np.hstack([uo, np.zeros((uo.shape[0], 7 - uo.shape[1]))])
        self.unknown_obs = uo[:, :7]

    def _device_inputs(self):
        """Device-resident waypoints and obstacles, re-uploaded only when the
        host arrays change.

        Invalidation is by content, not by identity: ``obs`` is
        user-assignable and a dynamic environment mutates it in place every
        step, so ``id()`` would serve stale positions.  The arrays are tiny
        (at most 32 x 7), so comparing their bytes each step costs
        microseconds.
        """
        key = (self.obs.tobytes(), self.obs.shape,
               self.unknown_obs.tobytes(), self.unknown_obs.shape,
               self.waypoints.tobytes(), self.waypoints.shape)
        if self._dev_key != key:
            dev = self.device
            known = pad_obstacles(self.obs, MAX_KNOWN_OBS, device=dev)
            unknown = pad_obstacles(self.unknown_obs, MAX_UNKNOWN_OBS, device=dev)
            wps = np.zeros((MAX_WAYPOINTS, 2))
            n = min(len(self.waypoints), MAX_WAYPOINTS)
            wps[:n] = self.waypoints[:n, :2]
            wps = torch.as_tensor(wps, dtype=torch.float32, device=dev)
            n_wps = torch.full((1,), len(self.waypoints), dtype=torch.long, device=dev)
            self._dev_cache = (wps, n_wps, known, unknown)
            self._dev_key = key
        return self._dev_cache

    def step_object(self) -> CapturedStep:
        """The control step, captured on the card: ``(state, waypoints,
        n_waypoints (1,), known, unknown) -> tracking.StepOutput``."""
        key = (self.cfg, self.spec, self.device)
        step = _STEPS.get(key)
        if step is None:
            cfg, spec = self.cfg, self.spec
            step = _STEPS[key] = CapturedStep(
                lambda *a: tracking.step(cfg, spec, *a), self.captured)
        return step

    def control_step(self) -> int:
        """One control step; returns the tracker's return code.  Traced as
        the span ``controller.step``, with ``controller.inputs`` (the device
        inputs), ``controller.replay`` (the copy into the graph's inputs and
        its replay, or the eager step), ``controller.keep`` (the state's
        copy) and ``controller.read`` (the one host read, which waits for
        the device)."""
        with span("controller.step"):
            return self._control_step()

    def _control_step(self) -> int:
        step = self.step_object()
        with span("controller.inputs"):
            inputs = self._device_inputs()
        with span("controller.replay"):
            out = step(self.state, *inputs)
        # A replay overwrites the graph's outputs: the controller keeps a copy,
        # so that a state read earlier stays as it was.
        with span("controller.keep"):
            self.state = _tree.tree_map(torch.clone, out.state) if step.use_graph else out.state
        # One device-to-host copy for everything the host needs this step.
        u = out.u[0]
        mask = out.safety_mask[0]
        with span("controller.read"):
            host = torch.cat([u, out.ret.to(u.dtype), mask.flatten().to(u.dtype)]).cpu().numpy()
        m = u.shape[0]
        self.u_pos = host[:m]
        self.last_safety_mask = host[m + 1:].reshape(mask.shape) > 0.5
        ret = int(host[m])
        if ret == tracking.RET_INFEASIBLE and self.raise_error:
            raise InfeasibleError("Infeasible or collision detected !!")
        return ret

    def get_control_input(self):
        return self.u_pos.reshape(-1, 1)

    @property
    def robot_state(self):
        return self.state.x[0].cpu().numpy()

    def has_reached_goal(self) -> bool:
        return int(self.state.goal_idx[0]) >= len(self.waypoints)

    def run_all_steps(self, tf=30, write_csv: bool = False) -> int:
        """Run up to ``tf`` seconds, stopping at a terminal code; returns the
        sum of the return codes.  ``write_csv`` logs each step's state,
        control and CBF gains to ``output.csv``."""
        unexpected_beh = 0
        writer = None
        csvfile = None
        if write_csv:
            import csv

            csvfile = open("output.csv", "w", newline="")
            writer = csv.writer(csvfile)
            writer.writerow(["states", "control_inputs", "alpha1", "alpha2"])
        try:
            for _ in range(int(tf / self.dt)):
                ret = self.control_step()
                unexpected_beh += ret
                if writer is not None:
                    writer.writerow(
                        np.concatenate(
                            [
                                self.robot_state,
                                self.u_pos,
                                [float(self.spec.cbf_alpha1), float(self.spec.cbf_alpha2)],
                            ]
                        )
                    )
                if ret in (tracking.RET_DONE, tracking.RET_INFEASIBLE):
                    break
        finally:
            if csvfile is not None:
                csvfile.close()
        return unexpected_beh
