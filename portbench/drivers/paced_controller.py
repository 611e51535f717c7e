"""One robot through ``sim.controller.LocalTrackingController.control_step``,
paced open loop: step k is due at k periods after the window opens and is
timed from then to when its control is on the host.  A robot that finishes
or collides starts again from the next start drawn from the seed, with a new
controller of the same configuration.  Every step of the window is checked,
and every controller's initial state."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import generate
from portbench.drivers import common

_SPEC_DEGREES = {"fov_angle"}


class Driver:
    def __init__(self, config, traffic, seed, device):
        from safe_control_tpu_torch.sim import controller
        from safe_control_tpu_torch.solvers import mpc_fused

        self.controller, self.counter = controller, mpc_fused
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = getattr(torch, config["dtype"])
        if self.dtype != torch.float32:
            raise ValueError("LocalTrackingController runs in float32")
        scene = config["scene"]
        self.route = np.asarray(scene["waypoints"], dtype=float)[:, :2]
        self.obstacles = np.asarray([list(o) + [0.0] * (7 - len(o)) for o in scene["obstacles"]])
        self.robot_spec = {"model": config["model"], "mpc_horizon": config["mpc"]["horizon"],
                           "mpc_outer_iters": config["mpc"]["outer_iters"],
                           "mpc_newton_iters": config["mpc"]["newton_iters"],
                           "use_fused_kernel": True,
                           "num_constraints": config["tracker"]["num_obs"],
                           "reached_threshold": config["tracker"]["reached_threshold"]}
        for k, v in config["spec"].items():
            self.robot_spec[k] = math.degrees(v) if k in _SPEC_DEGREES else v
        self.gen = generate.generator(seed)
        self.starts = []
        self.first = self._draw()

    def _draw(self):
        x0, nxt = generate.route_starts(self.config["scene"], self.config["spec"]["radius"],
                                        self.traffic, self.gen, 1)
        return x0[0].double().numpy(), int(nxt[0])

    def _first_goal(self, start):
        """The controller's first goal: the route from the next waypoint, less
        each waypoint within the reached threshold of the one before it (the
        start first)."""
        x0, nxt = start
        wps = self.route[nxt:]
        aug = np.vstack([x0[:2], wps])
        keep = np.linalg.norm(np.diff(aug, axis=0), axis=1) >= \
            self.config["tracker"]["reached_threshold"]
        return (wps[keep] if keep.any() else wps[-1:])[0]

    def _new(self, start):
        x0, nxt = start
        ctrl = self.controller.LocalTrackingController(
            x0, self.robot_spec, controller_type={"pos": self.config["tracker"]["controller"]},
            dt=self.config["tracker"]["dt"], device=self.device)
        common.check_spec(ctrl.spec, self.config)
        ctrl.obs = self.obstacles.copy()
        ctrl.set_waypoints(self.route[nxt:])
        self.starts.append(dict(state=ctrl.state, x0=x0, goal=self._first_goal(start)))
        return ctrl

    def warmup(self):
        """The first control step captures the step as one CUDA graph; the
        controllers of the window replay it."""
        ctrl = self._new(self.first)
        for _ in range(self.traffic["warmup_steps"]):
            ctrl.control_step()
        common.sync(self.device)
        self.step_object = ctrl.step_object()
        self.starts = []

    def _paced(self, ctrl, n_due, t0, capture=False):
        """``n_due`` paced steps from ``t0``: (the controller in use, the
        latencies in ms, the generator's largest lateness in s, the steps
        whose control is not finite, with ``capture`` every step's states
        and inputs, copied outside the timed span)."""
        period = self.traffic["period_s"]
        lat, late, bad, captures, ends = [], 0.0, 0, [], {-1: 0, -2: 0}
        for k in range(n_due):
            due = t0 + k * period
            before = (common.clone_state(ctrl.state), ctrl._device_inputs()) if capture else None
            common.wait_until(due)
            late = max(late, time.perf_counter() - due)
            ret = ctrl.control_step()
            lat.append((time.perf_counter() - due) * 1e3)
            bad += int(not np.all(np.isfinite(ctrl.u_pos)))
            if capture:
                wps, n, known, _ = before[1]
                captures.append(dict(before=before[0], after=common.clone_state(ctrl.state),
                                     u=ctrl.u_pos.copy(), wps=wps, n=n, known=known))
            if ret in ends:
                ends[ret] += 1
                ctrl = self._new(self._draw())
        self.ends = ends
        return ctrl, lat, late, bad, captures

    def window(self, seconds):
        period = self.traffic["period_s"]
        n_due = max(int(math.ceil(seconds / period - 1e-9)), 1)
        ctrl = self._new(self.first)
        launches0 = self.counter.LAUNCH_COUNT
        t0 = time.perf_counter() + period
        ctrl, lat, late, bad, captures = self._paced(ctrl, n_due, t0, capture=True)
        elapsed = time.perf_counter() - t0
        self.ctrl = ctrl
        outcomes = (f"robots ended: {self.ends[-1]} done, {self.ends[-2]} collided or "
                    "infeasible")
        return dict(window_s=elapsed, steps=n_due, attempted=n_due, failed=bad,
                    outcomes=outcomes,
                    latencies_ms=lat, lateness_s=late, captures=captures,
                    launches=self.counter.LAUNCH_COUNT - launches0, launch_name="B3",
                    graph_nodes=self.step_object.graph_nodes())

    def traced_slice(self, record_function):
        n = self.traffic["trace_steps"]
        t0 = time.perf_counter() + self.traffic["period_s"]
        with record_function():
            self.ctrl = self._paced(self.ctrl, n, t0)[0]
            common.sync(self.device)
        return n

    def blocks(self, captures):
        """Every step of the window, in batches of rows."""
        out = []
        for cs in common.blocks_of(captures, self.traffic["check_rows"]):
            out.append(common.Block(
                before=common.cat_trees([c["before"] for c in cs]),
                after=common.cat_trees([c["after"] for c in cs]),
                u=torch.as_tensor(np.stack([c["u"] for c in cs]), dtype=torch.float32,
                                  device=self.device),
                wps=torch.stack([c["wps"] for c in cs]), n=torch.cat([c["n"] for c in cs]),
                obs=cs[0]["known"]))
        return out

    def check(self, captures):
        model, tcfg, st = common.ref_setup(self.config)
        acc, active = common.check_blocks(model, tcfg, st, self.blocks(captures))
        rows = torch.arange(1, device=self.device)
        acc["start_mismatch"] = sum(
            common.compare_start(s["state"], torch.as_tensor(s["x0"][None], dtype=torch.float32,
                                                             device=self.device),
                                 torch.as_tensor(s["goal"][None], dtype=torch.float32,
                                                 device=self.device),
                                 self.config["spec"]["fov_angle"], rows)
            for s in self.starts)
        return acc, active, len(captures)
