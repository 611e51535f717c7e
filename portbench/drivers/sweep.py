"""A Monte Carlo sweep of moving-obstacle scenarios through
``parallel.monte_carlo.run_sweep_chunk``, in chunks, with episodes of fresh
scenarios drawn from the seed inside the window."""

from __future__ import annotations

import torch

from portbench import generate
from portbench.drivers import common
from portbench.reference.tracking import move_obstacles


class Driver:
    def __init__(self, config, traffic, seed, device):
        from safe_control_tpu_torch.parallel import monte_carlo
        from safe_control_tpu_torch.sim import tracking
        from safe_control_tpu_torch.solvers import qp_kernel

        self.mc, self.tracking, self.counter = monte_carlo, tracking, qp_kernel
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = getattr(torch, config["dtype"])
        self.spec = common.port_spec(config)
        self.cfg = common.port_tracker_config(config)
        scene = config["scene"]
        self.wps = torch.tensor(scene["waypoints"], dtype=self.dtype, device=device)
        self.n_wps = len(scene["waypoints"])
        self.y_range = tuple(scene["y_range"])
        self.gen = generate.generator(seed)
        self.B = traffic["batch"]
        self.episode = self.draw()

    def draw(self):
        obs, x0 = generate.dpcbf_scenarios(self.config["scene"], self.traffic, self.gen, self.B)
        dev, dt = self.device, self.dtype
        st = self.tracking.init_state(self.cfg, self.spec, x0.to(dev, dt), 0.0,
                                      first_goal=self.wps[0, :2], device=dev, dtype=dt)
        state = self.mc.SweepState(tracker=st, obs=obs.to(dev, dt),
                                   steps_done=torch.zeros((), dtype=torch.long, device=dev))
        return dict(state=state, x0=x0)

    def _run(self, state, steps, with_trajectory=False):
        return self.mc.run_sweep_chunk(self.cfg, self.spec, state, self.wps, self.n_wps, steps,
                                       y_range=self.y_range, with_trajectory=with_trajectory)

    def advance(self, ep, state, steps, last_u):
        if last_u:
            state, traj = self._run(state, steps, with_trajectory=True)
            u = traj["u"][:, -1]
        else:
            state, u = self._run(state, steps), None
        tr = state.tracker
        # scenarios whose state or last applied input is not finite
        bad = ((~torch.isfinite(tr.x)).any(-1) | (~torch.isfinite(tr.u_prev)).any(-1)).sum()
        return state, u, bad * steps

    @staticmethod
    def tracker(state):
        return state.tracker

    def warmup(self):
        self._run(common.clone_state(self.episode["state"]), self.traffic["warmup_steps"])
        common.sync(self.device)

    def window(self, seconds):
        return dict(common.chunked_window(self, seconds), launch_name="B2")

    def traced_slice(self, record_function):
        n = self.traffic["trace_steps"]
        with record_function():
            self.state = self._run(self.state, n)
            common.sync(self.device)
        return n

    def blocks(self, captures):
        """The chosen captures as batches of rows."""
        out = []
        for cs in common.blocks_of(captures, self.traffic["check_rows"] // self.B):
            before = common.cat_trees([c["before"] for c in cs])
            after = common.cat_trees([c["after"] for c in cs])
            out.append(common.Block(before=before.tracker, after=after.tracker,
                                    u=torch.cat([c["u"] for c in cs]), wps=self.wps,
                                    n=self.n_wps, obs=before.obs, obs_after=after.obs))
        return out

    def starts(self, captures):
        """Each episode's initial states against its generated starts."""
        got = 0.0
        first = self.wps[0, :2].expand(self.B, 2)
        rows = torch.arange(self.B, device=self.device)
        for c in captures:
            if c["offset"] == 0:
                got += common.compare_start(c["before"].tracker,
                                            c["ep"]["x0"].to(self.device, self.dtype), first,
                                            self.config["spec"]["fov_angle"], rows)
        return got

    def check(self, captures):
        model, tcfg, st = common.ref_setup(self.config)
        chosen = common.choose(self.seed, captures, self.traffic["samples"])

        def obstacles(b):
            moved = move_obstacles(b.obs, tcfg["dt"], self.y_range)
            return {"obs_gap": common.max_abs(b.obs_after - moved)}

        acc, _ = common.check_blocks(model, tcfg, st, self.blocks(chosen), obstacles)
        acc["start_mismatch"] = self.starts(captures)
        return acc, None, len(chosen)
