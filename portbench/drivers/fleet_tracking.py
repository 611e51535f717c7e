"""A fleet of robots through ``sim.tracking.run``, in chunks, with
episodes of fresh starts drawn from the seed inside the window."""

from __future__ import annotations

import torch

from portbench import generate
from portbench.drivers import common


class Driver:
    def __init__(self, config, traffic, seed, device):
        from safe_control_tpu_torch.core.types import pad_obstacles
        from safe_control_tpu_torch.sim import tracking
        from safe_control_tpu_torch.solvers import mpc_fused

        self.tracking, self.counter = tracking, mpc_fused
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = getattr(torch, config["dtype"])
        self.spec = common.port_spec(config)
        self.cfg = common.port_tracker_config(config)
        scene = config["scene"]
        self.known = pad_obstacles(scene["obstacles"], scene["obstacle_slots"], device=device,
                                   dtype=self.dtype)
        self.gen = generate.generator(seed)
        self.B = traffic["batch"]
        self.episode = self.draw()

    def draw(self):
        x0, nxt = generate.route_starts(self.config["scene"], self.config["spec"]["radius"],
                                        self.traffic, self.gen, self.B)
        wps, n = generate.route_waypoints(self.config["scene"], nxt)
        dev, dt = self.device, self.dtype
        st = self.tracking.init_state(self.cfg, self.spec, x0.to(dev, dt), x0[:, 2].to(dev, dt),
                                      first_goal=wps[:, 0].to(dev, dt), device=dev, dtype=dt)
        return dict(state=st, wps=wps.to(dev, dt), n=n.to(dev), x0=x0, first_goal=wps[:, 0])

    def _run(self, state, ep, steps):
        return self.tracking.run(self.cfg, self.spec, state, ep["wps"], ep["n"], self.known,
                                 steps)

    def advance(self, ep, state, steps, last_u):
        state, traj = self._run(state, ep, steps)
        bad = (~torch.isfinite(traj["u"])).any(-1).sum()
        return state, (traj["u"][:, -1] if last_u else None), bad

    @staticmethod
    def tracker(state):
        return state

    def warmup(self):
        """A chunk from a copy of the first episode's starts."""
        ep = self.episode
        self._run(common.clone_state(ep["state"]), ep, self.traffic["warmup_steps"])
        common.sync(self.device)

    def window(self, seconds):
        return dict(common.chunked_window(self, seconds), launch_name="B3")

    def traced_slice(self, record_function):
        n = self.traffic["trace_steps"]
        with record_function():
            self.state, _ = self._run(self.state, self.ep, n)
            common.sync(self.device)
        return n

    def blocks(self, captures):
        """The chosen captures as batches of rows."""
        per = self.traffic["check_rows"] // self.B
        return [common.Block(before=common.cat_trees([c["before"] for c in cs]),
                             after=common.cat_trees([c["after"] for c in cs]),
                             u=torch.cat([c["u"] for c in cs]),
                             wps=torch.cat([c["ep"]["wps"] for c in cs]),
                             n=torch.cat([c["ep"]["n"] for c in cs]), obs=self.known)
                for cs in common.blocks_of(captures, per)]

    def starts(self, captures):
        """Each episode's initial states against its generated starts."""
        got = 0.0
        for c in captures:
            if c["offset"] == 0:
                rows = torch.arange(self.B, device=self.device)
                got += common.compare_start(
                    c["before"], c["ep"]["x0"].to(self.device, self.dtype),
                    c["ep"]["first_goal"].to(self.device, self.dtype),
                    self.config["spec"]["fov_angle"], rows)
        return got

    def check(self, captures):
        model, tcfg, st = common.ref_setup(self.config)
        chosen = common.choose(self.seed, captures, self.traffic["samples"])
        acc, active = common.check_blocks(model, tcfg, st, self.blocks(chosen))
        acc["start_mismatch"] = self.starts(captures)
        return acc, active, len(chosen)
