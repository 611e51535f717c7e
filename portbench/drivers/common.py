"""What the drivers share: the port's objects built from a configuration
file, the reference's settings from the same file, timing helpers and the
comparison of a sampled step with the reference."""

from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from portbench.reference import mpc as mpc_ref
from portbench.reference import tracking as ref_tracking
from portbench.reference.geometry import angle_normalize
from portbench.reference.models import is_in_fov, make_model


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_spec(config):
    """The port's robot spec, every value of the configuration's ``spec``
    given explicitly; raises if the port holds another value."""
    from safe_control_tpu_torch.core.spec import make_spec

    spec = make_spec(config["model"], **config["spec"])
    check_spec(spec, config)
    return spec


def check_spec(spec, config):
    for k, v in config["spec"].items():
        if float(getattr(spec, k)) != float(v):
            raise RuntimeError(f"the port's spec holds {k}={getattr(spec, k)!r}, the "
                               f"configuration {v!r}")


def port_tracker_config(config):
    """The port's ``TrackerConfig`` of the configuration."""
    from safe_control_tpu_torch.sim import tracking
    from safe_control_tpu_torch.solvers import mpc_cbf

    t = config["tracker"]
    kw = dict(model_name=config["model"], pos_controller=t["controller"], dt=t["dt"],
              num_obs=t["num_obs"], reached_threshold=t["reached_threshold"],
              rotation_threshold=t["rotation_threshold"], enable_rotation=True)
    if t["controller"] == "cbf_qp":
        kw["qp_iters"] = t["qp_iters"]
    else:
        m = config["mpc"]
        kw["mpc"] = mpc_cbf.MPCConfig(
            horizon=m["horizon"], num_obs=m["num_obs"], outer_iters=m["outer_iters"],
            newton_iters=m["newton_iters"], rho0=m["rho0"], rho_growth=m["rho_growth"],
            rho_max=m["rho_max"], reg=m["reg"], viol_tol=m["viol_tol"], use_fused_kernel=True)
    return tracking.TrackerConfig(**kw)


def ref_setup(config):
    """(model, tracker settings, MPC settings) of the reference."""
    spec = SimpleNamespace(**config["spec"])
    model = make_model(config["model"], spec)
    st = mpc_ref.settings_from(config["mpc"]) if "mpc" in config else None
    return model, config["tracker"], st


def clone_state(state):
    """A copy of a tracker state (a tuple tree of tensors)."""
    return torch.utils._pytree.tree_map(torch.clone, state)


def ref_state(tracker_state, rows):
    """The reference's view of the port's ``TrackerState`` at ``rows``."""
    s = tracker_state
    out = dict(x=s.x[rows], mode=s.mode[rows], goal_idx=s.goal_idx[rows], ret=s.ret[rows],
               u_prev=s.u_prev[rows])
    if s.mpc is not None:
        out["U"] = s.mpc.U[rows]
    return out


def wait_until(t_due):
    """Spin until ``t_due`` (perf_counter): a sleeping generator wakes late by
    up to milliseconds, which would count in the steps' latencies."""
    while time.perf_counter() < t_due:
        pass


def outcomes(ret) -> str:
    """The shares of the last episode's robots done and collided or
    infeasible: scenario outcomes, not failures."""
    done = float((ret == ref_tracking.RET_DONE).float().mean())
    bad = float((ret == ref_tracking.RET_INFEASIBLE).float().mean())
    return f"last episode: {100 * done:.2f}% done, {100 * bad:.2f}% collided or infeasible"


def max_of(t, finite_only=False):
    """The largest entry; inf when one is not finite, unless
    ``finite_only``, which takes the largest of the finite entries."""
    t = t.float()
    if finite_only:
        t = t[torch.isfinite(t)]
    if t.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(t.max())


def max_abs(t, finite_only=False):
    return max_of(t.abs(), finite_only)


def _angle_gap(a, b):
    d = a - b
    return torch.cat([d[:, :2], angle_normalize(d[:, 2:3]), d[:, 3:]], dim=-1).abs()


def compare_step(model, tcfg, st, inp, out_port, rows, waypoints, n_waypoints, obs,
                 finite_only=False):
    """Run the reference's step on the port's input state at ``rows`` and
    compare the port's answers with it.  ``inp``/``out_port``: the port's
    tracker states before and after the step, ``out_port.u`` the applied
    inputs.  Returns the numbers and (the reference's active rows, B).

    - ``u_gap``, ``x_gap``: the port's inputs and next states against the
      reference's own solve;
    - ``integration_gap``, ``ret_mismatch``: the port's next states and
      return codes against the reference's integration, oracle and freeze
      of the port's answer: the inputs it applied (CBF-QP), or the first
      stage of its own solution on 'track' and the nominal input elsewhere
      (MPC), so that an input applied other than the solver answered shows;
    - ``mode_mismatch``, ``goal_mismatch``: the state machine;
    - MPC only: ``cost_gap``, the port's solution's cost above the
      reference's, as a share of 1 + that cost, and ``viol_gap``, its
      scaled constraint violation above the reference's, over the robots
      the MPC drove.

    ``finite_only`` takes each largest gap over the finite entries alone
    (for the readings of a control whose answers hold NaN).
    """
    B_all = inp.x.shape[0]
    # per-robot inputs ((B,) counts, (B, L, d) sets) at ``rows``; shared ones whole
    sel = lambda t: t[rows] if torch.is_tensor(t) and t.dim() in (1, 3) \
        and t.shape[0] == B_all else t
    ri = ref_state(inp, rows)
    ref = ref_tracking.step(model, tcfg, st, ri, sel(waypoints), sel(n_waypoints), sel(obs))
    dtype = ref["x"].dtype
    u_p = out_port.u[rows].to(dtype)
    x_p = out_port.x[rows].to(dtype)
    answer, got, active = u_p, {}, None
    if "solution" in ref:
        live = ri["ret"] >= 0
        track = ref["pre"][0] == ref_tracking.TRACK
        B = x_p.shape[0]
        U_p = out_port.mpc.U[rows].to(dtype)
        answer = torch.where(track[:, None], U_p[:, 0], ref["u_ref"])
        pb = mpc_ref.Problem(model, st, tcfg["dt"], *ref["problem"][:4])
        _, cs = pb.warm(ref["problem"][4])
        j_p, v_p = pb.objective(U_p.reshape(B, -1), cs)
        j_r, v_r = pb.objective(ref["solution"].U.reshape(B, -1), cs)
        solved = live & track
        got["cost_gap"] = max_of(torch.clamp_min((j_p - j_r) / (1.0 + j_r), 0.0)[solved],
                                 finite_only)
        got["viol_gap"] = max_of(torch.clamp_min(v_p - v_r, 0.0)[solved], finite_only)
        active = (float(ref["solution"].active_rows), B)
    fin = ref_tracking.finish(model, tcfg, ri, ref["known"], answer, ref["feasible"],
                              *ref["pre"])
    got = dict(
        u_gap=max_abs(u_p - ref["u"], finite_only),
        x_gap=max_of(_angle_gap(x_p, ref["x"]), finite_only),
        integration_gap=max_of(_angle_gap(x_p, fin["x"]), finite_only),
        mode_mismatch=float((out_port.mode[rows] != ref["mode"]).sum()),
        goal_mismatch=float((out_port.goal_idx[rows] != ref["goal_idx"]).sum()),
        ret_mismatch=float((out_port.ret[rows] != fin["ret"]).sum()),
        **got,
    )
    return got, active


def compare_start(inp, x0, first_goal, fov_angle, rows):
    """The port's initial tracker state against the generated start:
    states, modes (track when the first goal is in the field of view, else
    stop), goal indices, controls and warm starts."""
    x = inp.x[rows]
    mode = torch.where(is_in_fov(x0[rows, :2], x0[rows, 2], first_goal[rows], fov_angle),
                       ref_tracking.TRACK, ref_tracking.STOP)
    bad = ((x != x0[rows]).any(-1) | (inp.mode[rows] != mode) | (inp.goal_idx[rows] != 0)
           | (inp.u_prev[rows] != 0).any(-1) | (inp.ret[rows] != 0))
    if inp.mpc is not None:
        bad = bad | (inp.mpc.U[rows] != 0).flatten(1).any(-1)
    return float(bad.sum())


def merge_max(acc: dict, got: dict):
    for k, v in got.items():
        acc[k] = max(acc.get(k, 0.0), v) if not (isinstance(v, float) and math.isnan(v)) \
            else math.inf
    return acc


class StepOut:
    """A tracker state after a step, with the step's applied inputs ``u``."""

    def __init__(self, state, u):
        self.__dict__.update(state._asdict())
        self.u = u


# ---------------------------------------------------------------- captures

def capture_offsets(seed: int, episode: int, length: int) -> list:
    """The steps of episode ``episode`` (``length`` steps) whose answers are
    captured: its first, just after the draw, and one more drawn from the
    seed."""
    if length < 2:
        return [0]
    rng = np.random.default_rng([int(seed) % (2**63), 7, int(episode)])
    return [0, int(rng.integers(1, length))]


def choose(seed: int, captures: list, count: int) -> list:
    """``count`` of the captured steps, drawn from the seed, the first step
    of the first episode drawn inside the window among them: the steps that
    the reference checks.  All of them where there are no more."""
    if count >= len(captures):
        return list(captures)
    forced = [i for i, c in enumerate(captures) if c["episode"] == 1 and c["offset"] == 0][:1]
    rest = [i for i in range(len(captures)) if i not in forced]
    rng = np.random.default_rng([int(seed) % (2**63), 11])
    picked = forced + [int(i) for i in rng.choice(rest, size=count - len(forced),
                                                   replace=False)]
    return [captures[i] for i in sorted(picked)]


def cat_trees(trees: list):
    """Trees of tensors of several steps as one batch: each leaf with a
    batch axis concatenated, a scalar leaf taken from the first."""
    flat = [tree_flatten(t) for t in trees]
    leaves = [torch.cat(ls) if torch.is_tensor(ls[0]) and ls[0].dim() else ls[0]
              for ls in zip(*(f[0] for f in flat))]
    return tree_unflatten(leaves, flat[0][1])


def blocks_of(items: list, per_block: int) -> list:
    per_block = max(1, per_block)
    return [items[i:i + per_block] for i in range(0, len(items), per_block)]


def chunked_window(drv, seconds: float) -> dict:
    """The window of a closed-loop cell run in chunks: episodes of
    ``traffic['episode']`` steps, each drawn anew inside the window; the
    first step of every episode and one more an episode drawn from the seed
    are captured for the check.  ``drv`` gives ``episode`` (the first,
    drawn in set-up), ``draw()``, ``advance(ep, state, n, last_u) -> (state,
    the last step's inputs or None, steps whose input is not finite)`` and
    ``tracker(state)``."""
    tr = drv.traffic
    length = tr["episode"]
    ep = drv.episode
    state, e = ep["state"], 0
    offsets = capture_offsets(drv.seed, e, length)
    bad = torch.zeros((), dtype=torch.long, device=drv.device)
    captures, host_s, launches0 = [], 0.0, drv.counter.LAUNCH_COUNT
    steps, chunk_ms = 0, []
    t0 = t_chunk = time.perf_counter()
    while True:
        at = steps % length
        if steps and at == 0:
            e += 1
            ep = drv.draw()
            state = ep["state"]
            offsets = capture_offsets(drv.seed, e, length)
        n_chunk = min(tr["chunk"], length - at)
        done = 0
        for off in [o for o in offsets if at <= o < at + n_chunk] + [None]:
            n_run = (off - at - done) if off is not None else n_chunk - done
            if n_run:
                h0 = time.perf_counter()
                state, _, b = drv.advance(ep, state, n_run, False)
                host_s += time.perf_counter() - h0
                bad += b
                done += n_run
            if off is None:
                break
            before = clone_state(state)
            h0 = time.perf_counter()
            after, u, b = drv.advance(ep, state, 1, True)
            host_s += time.perf_counter() - h0
            bad += b
            captures.append(dict(episode=e, offset=off, ep=ep, before=before,
                                 after=clone_state(after), u=u.clone()))
            state = after
            done += 1
        sync(drv.device)
        steps += n_chunk
        now = time.perf_counter()
        chunk_ms.append((now - t_chunk) * 1e3 / n_chunk)
        t_chunk = now
        # at least into the second episode: a step just after a draw inside
        # the window is always among those checked
        if now - t0 >= seconds and e >= 1:
            break
    elapsed = time.perf_counter() - t0
    drv.state, drv.ep = state, ep
    B = drv.B
    return dict(window_s=elapsed, steps=steps, robot_steps=steps * B, attempted=steps * B,
                failed=int(bad), captures=captures, episodes=e + 1,
                outcomes=outcomes(drv.tracker(state).ret), host_s=host_s, host_steps=steps,
                chunk_ms_per_step=chunk_ms,
                launches=drv.counter.LAUNCH_COUNT - launches0)


class Block(NamedTuple):
    """Several captured steps as one batch of rows: the port's tracker
    states before and after, the applied inputs, each row's waypoints and
    their count, and the obstacles (one set for all rows, or one a row);
    moving obstacles also after the step."""

    before: object
    after: object
    u: torch.Tensor
    wps: torch.Tensor
    n: object
    obs: torch.Tensor
    obs_after: object = None


def check_blocks(model, tcfg, st, blocks: list, extra=None):
    """The numbers of ``compare_step`` over every block, the largest of
    each; the reference's active rows a problem; ``extra(block)`` adds a
    block's own numbers."""
    acc, active = {}, [0.0, 0]
    for b in blocks:
        rows = torch.arange(b.u.shape[0], device=b.u.device)
        got, act = compare_step(model, tcfg, st, b.before, StepOut(b.after, b.u), rows, b.wps,
                                b.n, b.obs)
        if extra is not None:
            got.update(extra(b))
        merge_max(acc, got)
        if act is not None:
            active[0] += act[0]
            active[1] += act[1]
    return acc, (active[0] / active[1] if active[1] else None)
