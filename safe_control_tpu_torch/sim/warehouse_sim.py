"""The warehouse case study: BackupCBF and gatekeeper shielding runs.

Port of ``safe_control_tpu/sim/warehouse_sim.py``: closed-loop harnesses
over ``envs.warehouse_env.WarehouseEnv`` for a DoubleIntegrator2D robot
driving the zig-zag route through leveled ghost traffic.

- ``run_backup_cbf_level``: BackupCBF with the stop backup (the backup CBF-QP
  of ``shielding/backup_cbf.py``, its QP the general ``qp.solve_qp`` at 800
  iterations).  Survives light traffic only (level 1).
- ``run_gatekeeper_level``: gatekeeper commitments with the
  evade-to-safe-spot backup, validated against bounce-exact ghost
  predictions (``fold_position``) with a terminal invariant-set gate.

On a card each strategy's control step (the controller and ``MODEL.step``)
is captured once a CUDA stream as a ``torch.cuda.CUDAGraph`` at its first
call (``core.graphs.CapturedStep``) and replayed at every step of every
level run on that stream (the inputs are the state, the goal,
the ghost table and, for the gatekeeper, its commitment and the level's
padded safe spots); ``graph=False`` runs the same step eagerly on the card,
and on the CPU it always runs eagerly.  Each step reads the device once
(the new state and the step's flags in one copy); the ghosts step on the
host.  The result dicts and the ``record`` list (the state after each
step) are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_tpu_torch.core.graphs import CapturedStep
from safe_control_tpu_torch.core.spec import DOUBLE_INTEGRATOR_2D, make_spec
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.envs.warehouse_env import WarehouseEnv, fold_position
from safe_control_tpu_torch.shielding import backup_cbf as bcbf
from safe_control_tpu_torch.shielding import gatekeeper as gk

DT = 0.1
SPEC = make_spec(DOUBLE_INTEGRATOR_2D, v_max=3.0, a_max=3.0, ax_max=3.0, ay_max=3.0,
                 radius=0.8)
MODEL = get_model(DOUBLE_INTEGRATOR_2D)
R = float(SPEC.radius)
MAX_SPOTS = 1024
# The fold prediction is exact at the sample times; the margin covers the
# motion between samples, ~(|v_ghost| + |v_robot|) dt / 2 = 0.35 m at most.
GHOST_MARGIN = 0.4

GK_CFG = gk.GatekeeperConfig(
    model_name=DOUBLE_INTEGRATOR_2D, dt=DT, nominal_steps=30, backup_steps=60,
    event_offset_steps=3, discount_steps=3,
)
BCBF_CFG = bcbf.BackupCBFConfig(model_name=DOUBLE_INTEGRATOR_2D, dt=DT, backup_steps=25,
                                alpha=1.5)

# One step object per strategy, device and graph mode, and on a card per
# CUDA stream: its captured graph serves every level run on that stream, as
# the JAX package's compiled controller does; runs on other streams (run at
# the same time) capture their own.
_STEPS: dict = {}


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _true_min_h(env, x):
    """Least clearance of the robot at ``x`` (host NumPy) to the statics and
    the current ghosts."""
    p = np.asarray(x[:2])
    d_static = np.min(np.linalg.norm(p - env.static_obstacles[:, :2], axis=1)
                      - env.static_obstacles[:, 2])
    g = env.ghosts_np
    act = g[:, 4] > 0
    d_ghost = np.min(np.linalg.norm(p - g[act, :2], axis=1) - g[act, 4]) if act.any() else np.inf
    return min(d_static - R, d_ghost - R)


def _static(env) -> torch.Tensor:
    return torch.as_tensor(env.static_obstacles, dtype=torch.float32, device=env.device)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("warehouse_sim: no CUDA device (pass device='cpu')")
    return device


def _cached_step(name, device, graph, build):
    use_graph = bool(graph and device.type == "cuda")
    stream = torch.cuda.current_stream(device).cuda_stream if use_graph else None
    key = (name, str(device), use_graph, stream)
    if key not in _STEPS:
        _STEPS[key] = CapturedStep(build(), use_graph)
    return _STEPS[key]


def _make_bcbf_ctrl(env):
    """The BackupCBF controller ``ctrl(x (1, 4), goal (1, 2), ghosts0
    (MAX_GHOSTS, 5)) -> BackupCBFResult`` with the stop backup.  The minima
    over obstacles are ``amin``/``minimum`` (ties split the gradient, as
    JAX's ``min``), the speed norm a square root of a sum of squares (its
    NaN derivative at rest makes the QP fail there, as in JAX)."""
    static = _static(env)
    width, height = env.width, env.height

    def backup_policy(x):
        return torch.minimum(torch.maximum(-2.0 * x[..., 2:4], torch.full_like(x[..., 2:4], -3.0)),
                             torch.full_like(x[..., 2:4], 3.0))

    def h_safety_at(ghosts0):
        def h_safety(x, t):
            p0, p1 = x[..., 0], x[..., 1]
            h_bnd = torch.stack([p0 - R, width - p0 - R, p1 - R, height - p1 - R], -1).amin(-1)
            dx = p0[..., None] - static[:, 0]
            dy = p1[..., None] - static[:, 1]
            h_static = (torch.sqrt(dx * dx + dy * dy) - R - static[:, 2]).amin(-1)
            t = t[..., None]
            gx = ghosts0[:, 0] + ghosts0[:, 2] * t
            gy = ghosts0[:, 1] + ghosts0[:, 3] * t
            ex, ey = p0[..., None] - gx, p1[..., None] - gy
            d_g = torch.sqrt(ex * ex + ey * ey)
            h_ghost = torch.where(ghosts0[:, 4] > 0, d_g - R - ghosts0[:, 4],
                                  torch.full_like(d_g, float("inf"))).amin(-1)
            return torch.minimum(torch.minimum(h_bnd, h_static), h_ghost)

        return h_safety

    def ctrl(x, goal, ghosts0):
        u_ref = MODEL.nominal_input(x, goal, SPEC)
        h_s = h_safety_at(ghosts0)
        t_end = torch.full((), BCBF_CFG.backup_steps * DT, dtype=x.dtype, device=x.device)

        def h_t(xx):
            return torch.minimum(h_s(xx, t_end), 1.0 - _norm2(xx[..., 2:4]) / 0.5)

        return bcbf.solve(BCBF_CFG, SPEC, x, u_ref, backup_policy, h_s, h_t)

    return ctrl


def _bcbf_step(env):
    ctrl = _make_bcbf_ctrl(env)

    def step(x, goal, ghosts0):
        res = ctrl(x, goal, ghosts0)
        x1 = MODEL.step(x, res.u, SPEC, DT)
        flags = torch.stack([res.h_min[0], res.qp_ok[0].to(x.dtype),
                             res.using_backup[0].to(x.dtype)])
        return x1, torch.cat([x1[0], res.u[0], flags])  # the host report

    return step


def _gatekeeper_step(env):
    """The gatekeeper step ``(gst, x, goal, ghosts0, spots) -> (gst, x1,
    report)``: the evade-to-spot backup, the bounce-exact collision check and
    the parked-at-a-spot terminal gate."""
    static = _static(env)
    width, height = env.width, env.height

    def step(gst, x, goal, g0, spots):
        def backup_policy(xx):
            # evade to the nearest ghost-path-free spot, with a mild static
            # repulsion
            p, v = xx[..., :2], xx[..., 2:4]
            d = _norm2(spots - p[..., None, :])
            tgt = spots[torch.argmin(d, dim=-1)]
            a = 2.0 * (tgt - p) - 2.8 * v
            diff = p[..., None, :] - static[:, :2]
            dist = _norm2(diff)
            surf = dist - static[:, 2] - R
            push = 3.0 * torch.clamp_min(1.0 - surf / 2.0, 0.0) ** 2
            a = a + (diff / torch.clamp_min(dist, 1e-6)[..., None] * push[..., None]).sum(-2)
            mag = _norm2(a)
            scale = torch.where(mag > 3.0, 3.0 / torch.clamp_min(mag, 1e-9), torch.ones_like(mag))
            return a * scale[..., None]

        def collision_fn(xx, t_idx):
            p0, p1 = xx[..., 0], xx[..., 1]
            t = (t_idx.to(xx.dtype) * DT)[..., None]
            oob = (p0 < R) | (p0 > width - R) | (p1 < R) | (p1 > height - R)
            d_s = _norm2(xx[..., None, :2] - static[:, :2])
            hit_s = torch.any(d_s < static[:, 2] + R + 0.15, dim=-1)
            gx = fold_position(g0[:, 0] + g0[:, 2] * t)
            gy = fold_position(g0[:, 1] + g0[:, 3] * t)
            ex, ey = p0[..., None] - gx, p1[..., None] - gy
            d_g = torch.sqrt(ex * ex + ey * ey)
            hit_g = torch.any((d_g < g0[:, 4] + R + GHOST_MARGIN) & (g0[:, 4] > 0), dim=-1)
            return oob | hit_s | hit_g

        def terminal_fn(xx):
            # the invariant set: parked (slow) at a ghost-path-free spot
            d = _norm2(spots - xx[..., None, :2]).amin(-1)
            return (d < 0.8) & (_norm2(xx[..., 2:4]) < 0.3)

        out = gk.step(GK_CFG, SPEC, gst, x, backup_policy, collision_fn,
                      nominal_policy=lambda xx: MODEL.nominal_input(xx, goal, SPEC),
                      terminal_fn=terminal_fn)
        x1 = MODEL.step(x, out.u, SPEC, DT)
        return out.state, x1, torch.cat([x1[0], out.using_backup.to(x.dtype)])

    return step


def step_object(strategy: str, device="cuda", graph: bool = True) -> CapturedStep:
    """The cached step of ``strategy`` ('backup_cbf' or 'gatekeeper') on
    ``device`` and, on a card, the current CUDA stream (``capture_seconds``
    once it is captured)."""
    device = _device(device)
    env = WarehouseEnv(level=0, dt=DT, device=device)
    build = {"backup_cbf": lambda: _bcbf_step(env),
             "gatekeeper": lambda: _gatekeeper_step(env)}[strategy]
    return _cached_step(strategy, device, graph, build)


def run_backup_cbf_level(level, max_steps=1200, record=None, *, device="cuda",
                         graph: bool = True):
    """BackupCBF zig-zag drive; dict(outcome='reached'|'collision'|'stalled',
    min_h, steps, min_rollout_h, wp_i)."""
    device = _device(device)
    env = WarehouseEnv(level=level, dt=DT, device=device)
    wps = env.get_nominal_waypoints()
    step = step_object("backup_cbf", device, graph)
    goals = torch.as_tensor(wps, dtype=torch.float32, device=device)[:, None]

    x = torch.tensor([[10.0, 10.0, 0.0, 0.0]], device=device)
    wp_i = 1  # waypoint 0 is the start
    min_h = np.inf
    min_rollout_h = np.inf
    for k in range(max_steps):
        x, report = step(x, goals[wp_i], env.ghosts)
        env.step()
        rep = report.cpu().numpy()
        xh = rep[:4]
        if record is not None:
            record.append(xh.copy())
        min_rollout_h = min(min_rollout_h, float(rep[6]))
        min_h = min(min_h, _true_min_h(env, xh))
        if min_h < -0.05:
            return dict(outcome="collision", min_h=min_h, steps=k,
                        min_rollout_h=min_rollout_h, wp_i=wp_i)
        if np.linalg.norm(xh[:2] - wps[wp_i]) < 2.0:
            wp_i += 1
            if wp_i == len(wps):
                return dict(outcome="reached", min_h=min_h, steps=k,
                            min_rollout_h=min_rollout_h, wp_i=wp_i)
    return dict(outcome="stalled", min_h=min_h, steps=max_steps,
                min_rollout_h=min_rollout_h, wp_i=wp_i)


def padded_spots(env) -> torch.Tensor:
    """The level's safe spots padded to ``(MAX_SPOTS, 2)`` with the last one."""
    sp = env.safe_spots(robot_radius=R)
    if not len(sp):
        raise RuntimeError(f"no safe spots at level {env.level}")
    pad = np.tile(sp[-1:], (MAX_SPOTS - len(sp), 1))
    return torch.as_tensor(np.vstack([sp, pad])[:MAX_SPOTS], dtype=torch.float32,
                           device=env.device)


def run_gatekeeper_level(level, max_steps=1200, record=None, *, device="cuda",
                         graph: bool = True):
    """Gatekeeper-shielded drive; dict(outcome, min_h, steps, backup_steps,
    wp_i)."""
    device = _device(device)
    env = WarehouseEnv(level=level, dt=DT, device=device)
    wps = env.get_nominal_waypoints()
    spots = padded_spots(env)
    step = step_object("gatekeeper", device, graph)
    goals = torch.as_tensor(wps, dtype=torch.float32, device=device)[:, None]

    gst = gk.init_state(GK_CFG, 1, device=device)
    x = torch.tensor([[10.0, 10.0, 0.0, 0.0]], device=device)
    wp_i = 1
    min_h = np.inf
    bk_steps = 0
    for k in range(max_steps):
        gst, x, report = step(gst, x, goals[wp_i], env.ghosts, spots)
        env.step()
        rep = report.cpu().numpy()
        xh = rep[:4]
        if record is not None:
            record.append(xh.copy())
        bk_steps += int(rep[4] != 0.0)
        min_h = min(min_h, _true_min_h(env, xh))
        if min_h < -0.05:
            return dict(outcome="collision", min_h=float(min_h), steps=k,
                        backup_steps=bk_steps, wp_i=wp_i)
        if np.linalg.norm(xh[:2] - wps[wp_i]) < 4.0:
            wp_i += 1
            if wp_i == len(wps):
                return dict(outcome="reached", min_h=float(min_h), steps=k,
                            backup_steps=bk_steps, wp_i=wp_i)
    return dict(outcome="stalled", min_h=float(min_h), steps=max_steps,
                backup_steps=bk_steps, wp_i=wp_i)
