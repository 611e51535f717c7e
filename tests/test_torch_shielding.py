"""Port parity: the backup policies, the backup CBF-QP and the gatekeeper.

- ``lane_change``, ``stopping`` (DriftingCar) and ``evade``
  (DoubleIntegrator2D) against JAX on random float64 states, values and
  ``jacfwd`` derivatives: 1e-12 (relative to the magnitude: torques reach
  1e4);
- ``backup_cbf.solve`` on ``tests/test_backup_cbf.py``'s evade geometry
  (DoubleIntegrator2D, the bullet's rectangle distance and the pocket's
  terminal set) at four states, one of them with the QP active: u and
  h_min within 1e-6 in float64 and 2e-3 in float32, the flags equal;
- the gatekeeper's commitment sequences EQUAL to JAX's over
  ``tests/test_gatekeeper_parity.py``'s DoubleIntegrator2D script (120
  steps, a constant-velocity obstacle crossing the lane): the gatekeeper,
  MPS, and the gatekeeper with ``revalidate``; the applied inputs and the
  states within 1e-5;
- the evade closed loop of ``tests/test_gatekeeper_evade.py`` (a hallway,
  a bullet, a pocket): the port's outcome equals JAX's (collision, goal,
  backup and nominal step counts) for the gatekeeper to the goal, and for
  MPS over its first 30 s; the environment's collision semantics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_backup_cbf as jbcbf_case
import test_gatekeeper_evade as jevade
import test_gatekeeper_parity as jgp
from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec
from safe_control_tpu.shielding import backup as jbk
from safe_control_tpu.shielding import backup_cbf as jbcbf
from safe_control_tpu.shielding import gatekeeper as jgk
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.envs.evade_env import EvadeEnv
from safe_control_tpu_torch.shielding import backup as tbk
from safe_control_tpu_torch.shielding import backup_cbf as tbcbf
from safe_control_tpu_torch.shielding import gatekeeper as tgk

torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=tol, atol=tol)


# --------------------------------------------------------- backup policies
def _drift_states(B=128, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-5, 50, (B, 1)), rng.uniform(-8, 8, (B, 1)), rng.uniform(-1, 1, (B, 1)),
        rng.uniform(-1.5, 1.5, (B, 1)), rng.uniform(-0.5, 0.5, (B, 1)),
        rng.uniform(-0.5, 15, (B, 1)), rng.uniform(-0.4, 0.4, (B, 1)),
        rng.uniform(-4000, 4000, (B, 1))], axis=1)


@pytest.mark.parametrize("policy", ["lane_change", "stopping"])
def test_drift_backup_policies_match_jax(policy):
    js = make_spec(DRIFTING_CAR)
    ts = interop.spec_from_jax(js, dtype=torch.float64)
    x = _drift_states()
    if policy == "lane_change":
        g = jbk.LaneChangeGains(target_velocity=10.0)
        tg = tbk.LaneChangeGains(*g)
        jf = lambda z: jbk.lane_change(z, 2.0, js, g)
        tf = lambda z: tbk.lane_change(z, 2.0, ts, tg)
    else:
        g = jbk.StoppingGains()
        tg = tbk.StoppingGains(*g)
        jf = lambda z: jbk.stopping(z, js, g)
        tf = lambda z: tbk.stopping(z, ts, tg)
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        _close(jax.vmap(jf)(xj), tf(torch.tensor(x)))
        _close(jax.vmap(jax.jacfwd(jf))(xj),
               torch.func.vmap(torch.func.jacfwd(tf))(torch.tensor(x)))


def test_evade_policy_matches_jax():
    ts = interop.spec_from_jax(jevade.SPEC, dtype=torch.float64)
    cfg = tbk.EvadeConfig(*jevade.EVADE_CFG)
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-2, 62, (256, 1)), rng.uniform(-2.5, 6.5, (256, 1)),
                        rng.uniform(-1.5, 1.5, (256, 2))], axis=1)
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        _close(jax.vmap(jevade.backup_policy)(xj), tbk.evade(torch.tensor(x), cfg, ts))
        _close(jax.vmap(jax.jacfwd(jevade.backup_policy))(xj),
               torch.func.vmap(torch.func.jacfwd(lambda z: tbk.evade(z, cfg, ts)))(
                   torch.tensor(x)))


# --------------------------------------------------------------- backup CBF
ENV = EvadeEnv(**dataclasses.asdict(jevade.ENV))


def _h_safety_factory(spec, bullet_x0):
    """The port's counterpart of ``test_backup_cbf._h_safety_factory``."""

    def h_safety(x, t):
        px, py = x[..., 0], x[..., 1]
        r, hw = spec.radius, ENV.half_width
        in_px = (px >= ENV.pocket_x_min) & (px <= ENV.pocket_x_max)
        h_top = torch.where(in_px, ENV.pocket_y_max - py - r, hw - py - r)
        bx = bullet_x0 + ENV.bullet_speed * torch.as_tensor(t, dtype=x.dtype)
        dx = torch.clamp_min(torch.abs(px - bx) - ENV.bullet_length * (1 + 1 / 3) / 2, 0.0)
        dy = torch.clamp_min(torch.abs(py - 0.0) - ENV.bullet_width / 2, 0.0)
        hb = torch.sqrt(dx * dx + dy * dy + 1e-9) - r - 0.5
        hs = torch.broadcast_tensors(py + hw - r, px - r, ENV.hallway_length - px - r, h_top, hb)
        return torch.stack(hs, dim=-1).amin(-1)

    return h_safety


def _h_terminal(spec):
    def h_terminal(x):
        margin = spec.radius + 0.2
        return torch.stack([
            x[..., 0] - ENV.pocket_x_min - margin, ENV.pocket_x_max - x[..., 0] - margin,
            x[..., 1] - ENV.pocket_y_min - margin, ENV.pocket_y_max - x[..., 1] - margin,
            spec.v_max - torch.sqrt(x[..., 2] * x[..., 2] + x[..., 3] * x[..., 3]),
        ], dim=-1).amin(-1)

    return h_terminal


BCBF_CASES = [  # x0, bullet x at t=0, backup steps, u_ref
    ([22.0, 0.5, 1.0, 0.0], -10.0, 10, [0.5, 0.1]),
    ([28.0, 0.0, 0.5, 0.0], -100.0, 30, [0.5, 0.1]),
    ([30.0, 2.5, 0.0, 0.5], 15.0, 40, [0.5, 0.0]),
    ([29.0, 3.5, 0.0, 0.8], 15.0, 40, [1.5, 1.5]),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6), (torch.float32, 2e-3)],
                         ids=["f64", "f32"])
def test_backup_cbf_solve_matches_jax(dtype, tol):
    ts = interop.spec_from_jax(jbcbf_case.SPEC)
    ecfg = tbk.EvadeConfig(*jbcbf_case.EVADE_CFG)
    active = 0
    with jax.enable_x64(dtype == torch.float64):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        for x0, bx0, N, u_ref in BCBF_CASES:
            jcfg = jbcbf.BackupCBFConfig(model_name="DoubleIntegrator2D", dt=jbcbf_case.DT,
                                         backup_steps=N)
            rj = jax.jit(lambda x, u: jbcbf.solve(
                jcfg, jbcbf_case.SPEC, x, u, jbcbf_case.backup_policy,
                jbcbf_case._h_safety_factory(bx0), jbcbf_case.h_terminal))(
                    jnp.asarray(x0, jdt), jnp.asarray(u_ref, jdt))
            rt = tbcbf.solve(interop.backup_cbf_config_from_jax(jcfg), ts,
                             torch.tensor([x0], dtype=dtype), torch.tensor([u_ref], dtype=dtype),
                             lambda x: tbk.evade(x, ecfg, ts), _h_safety_factory(ts, bx0),
                             _h_terminal(ts))
            np.testing.assert_allclose(rt.u[0].numpy(), np.asarray(rj.u), atol=tol, rtol=0)
            assert float(rt.h_min[0]) == pytest.approx(float(rj.h_min), abs=tol)
            np.testing.assert_allclose(rt.phi[0].numpy(), np.asarray(rj.phi), atol=tol, rtol=0)
            assert bool(rt.qp_ok[0]) == bool(rj.qp_ok)
            assert bool(rt.using_backup[0]) == bool(rj.using_backup)
            active += int(bool(rj.qp_ok) and bool(rj.using_backup))
    assert active == 2  # the QP changed the input in the last two cases


# --------------------------------------------------------------- gatekeeper
def _port_di_script(cfg, terminal=False):
    """``test_gatekeeper_parity._run_repo``'s script through the port."""
    spec = interop.spec_from_jax(jgp.SPEC)
    model = get_model("DoubleIntegrator2D")
    obs0 = torch.tensor(jgp.OBS0, dtype=torch.float32)
    obs_v = torch.tensor(jgp.OBS_V, dtype=torch.float32)
    goal = torch.tensor(jgp.GOAL, dtype=torch.float32)

    def backup(x):
        a = -x[..., 2:4] / jgp.DT
        mag = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
        return a * torch.where(mag > 1.0, 1.0 / torch.clamp_min(mag, 1e-9),
                               torch.ones_like(mag))[..., None]

    def nominal(x):
        return model.nominal_input(x, goal.expand(x.shape[:-1] + (2,)), spec)

    gst = tgk.init_state(cfg, 1, device="cpu")
    x = torch.zeros((1, 4))
    recs, xs = [], [x[0].double().numpy()]
    for k in range(jgp.N_STEPS):
        def collision_fn(s, off, k=k):
            t = (k + off).to(torch.float32) * jgp.DT
            d = s[..., :2] - (obs0 + obs_v * t[..., None])
            return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) < \
                jgp.OBS_R + jgp.ROBOT_R + jgp.MARGIN

        out = tgk.step(cfg, spec, gst, x, backup, collision_fn, nominal_policy=nominal)
        x = model.step(x, out.u, spec, jgp.DT)
        recs.append(dict(event=bool(out.event_fired[0]), found=bool(out.candidate_found[0]),
                         nominal_committed=int(out.state.nominal_steps_committed[0]),
                         using_backup=bool(out.using_backup[0]), u=out.u[0].double().numpy()))
        gst = out.state
        xs.append(x[0].double().numpy())
    return recs, np.stack(xs)


@pytest.mark.parametrize("mode", ["gatekeeper", "mps", "revalidate"])
def test_gatekeeper_commitment_sequences_equal_jax(mode):
    nn, nb, disc = 12, 12, 4
    cfg = jgk.GatekeeperConfig(model_name="DoubleIntegrator2D", dt=jgp.DT, nominal_steps=nn,
                               backup_steps=nb, event_offset_steps=1 if mode == "mps" else 3,
                               discount_steps=disc, mps_mode=mode == "mps",
                               revalidate=mode == "revalidate")
    recs_j, xs_j = jgp._run_repo(cfg)
    recs_t, xs_t = _port_di_script(interop.gatekeeper_config_from_jax(cfg))
    for k, (a, b) in enumerate(zip(recs_j, recs_t)):
        for f in ("event", "found", "nominal_committed", "using_backup"):
            assert a[f] == b[f], (k, f, a, b)
        np.testing.assert_allclose(b["u"], a["u"], atol=1e-5, err_msg=f"step {k}")
    assert np.abs(xs_j - xs_t).max() < 1e-5
    assert sum(r["found"] for r in recs_t) > 3
    if mode != "mps":
        assert min(r["nominal_committed"] for r in recs_t if r["found"]) < nn


def test_gatekeeper_state_and_config_from_jax():
    cfg = jgk.GatekeeperConfig(model_name="DoubleIntegrator2D", nominal_steps=7, backup_steps=5,
                               discount_steps=3)
    tcfg = interop.gatekeeper_config_from_jax(cfg)
    assert tcfg.num_candidates == cfg.num_candidates == 4
    assert tcfg.committed_len == cfg.committed_len == 13
    assert tcfg.candidate_lengths() == [7, 4, 1, 0]
    st = interop.gatekeeper_state_from_numpy(jgk.init_state(cfg), device="cpu")
    ref = tgk.init_state(tcfg, 1, device="cpu")
    for a, b in zip(st, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------- evade closed loop
def _port_evade(algo, tf):
    """``test_gatekeeper_evade._run`` through the port."""
    spec = interop.spec_from_jax(jevade.SPEC)
    model = get_model("DoubleIntegrator2D")
    ecfg = tbk.EvadeConfig(*jevade.EVADE_CFG)
    dt = jevade.DT
    cfg = tgk.GatekeeperConfig(model_name="DoubleIntegrator2D", dt=dt,
                               nominal_steps=int(10.0 / dt), backup_steps=int(12.0 / dt),
                               event_offset_steps=1, discount_steps=5, mps_mode=algo == "mps")

    def nominal(x):
        ax = 2.0 * (spec.v_max - x[..., 2])
        ay = 2.0 * (0.0 - x[..., 1]) + 2.0 * (0.0 - x[..., 3])
        mag = torch.sqrt(ax * ax + ay * ay)
        scale = torch.where(mag > spec.a_max, spec.a_max / torch.clamp_min(mag, 1e-9),
                            torch.ones_like(mag))
        return torch.stack([ax, ay], dim=-1) * scale[..., None]

    gst = tgk.init_state(cfg, 1, device="cpu")
    x = torch.tensor([[20.0, 0.0, 0.0, 0.0]])
    bullet_x = ENV.bullet_start_x
    collided = goal = False
    backup_steps = nominal_steps = 0
    for _ in range(int(tf / dt)):
        bx = torch.tensor(bullet_x, dtype=torch.float32)

        def collision_fn(s, off, bx=bx):
            b_x = bx + ENV.bullet_speed * off.to(torch.float32) * dt
            return ENV.check_collision(s[..., :2], spec.radius) | \
                ENV.check_bullet_collision(s[..., :2], spec.radius + jevade.SAFETY_MARGIN, b_x)

        out = tgk.step(cfg, spec, gst, x, lambda s: tbk.evade(s, ecfg, spec), collision_fn,
                       nominal_policy=nominal)
        x = model.step(x, out.u, spec, dt)
        gst = out.state
        backup_steps += int(out.using_backup[0])
        nominal_steps += 1 - int(out.using_backup[0])
        bullet_x += ENV.bullet_speed * dt
        if bullet_x > ENV.hallway_length + ENV.bullet_length:
            bullet_x = ENV.bullet_start_x
        if bool(ENV.check_bullet_collision(x[0, :2], spec.radius, bullet_x)):
            collided = True
            break
        if bool(ENV.check_goal_reached(x[0, :2])):
            goal = True
            break
    return dict(collided=collided, goal=goal, pos=x[0, :2].numpy(), backup_steps=backup_steps,
                nominal_steps=nominal_steps)


@pytest.mark.parametrize("algo,tf", [("gatekeeper", 60.0), ("mps", 30.0)])
def test_evade_closed_loop_outcome_equals_jax(algo, tf):
    port = _port_evade(algo, tf)
    ref = jevade._run(algo, tf=tf)
    assert not port["collided"] and not ref["collided"]
    for k in ("goal", "backup_steps", "nominal_steps"):
        assert port[k] == ref[k], (k, port, ref)
    np.testing.assert_allclose(port["pos"], np.asarray(ref["pos"]), atol=1e-3)
    if algo == "gatekeeper":
        assert port["goal"] and port["backup_steps"] > 0


def test_evade_env_collision_semantics_and_pocket():
    r = 0.5
    p = lambda *v: torch.tensor(v)
    assert not bool(ENV.check_collision(p(10.0, 0.0), r))
    assert bool(ENV.check_collision(p(10.0, 2.2), r))
    assert not bool(ENV.check_collision(p(30.0, 3.0), r))
    assert bool(ENV.check_collision(p(30.0, 6.2), r))
    assert bool(ENV.check_bullet_collision(p(12.3, 0.0), r, 10.0))
    assert not bool(ENV.check_bullet_collision(p(13.5, 0.0), r, 10.0))
    t = torch.tensor([0.0, 10.0, 30.0])
    np.testing.assert_allclose(ENV.bullet_x_at(t).numpy(),
                               np.asarray(jevade.ENV.bullet_x_at(jnp.asarray(t.numpy()))),
                               atol=1e-5)
    spec = interop.spec_from_jax(jevade.SPEC)
    model = get_model("DoubleIntegrator2D")
    ecfg = tbk.EvadeConfig(*jevade.EVADE_CFG)
    x = torch.tensor([26.0, 0.0, 1.0, 0.0])
    for _ in range(200):
        x = model.step(x, tbk.evade(x, ecfg, spec), spec, jevade.DT)
    assert bool(ENV.is_in_safe_pocket(x[:2], margin=0.2))
