"""The benchmark's frozen reference held to the JAX package on seeded
problems, on the CPU in float64: an independent check of the yardstick.
This file imports JAX; nothing that runs on the card does."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import mpc as mpc_ref
from portbench.reference import qp as qp_ref
from portbench.reference import tracking as ref_tracking
from portbench.reference.geometry import pad_obstacles
from portbench.reference.models import make_model
from safe_control_tpu.core import spec as jspec
from safe_control_tpu.dynamics import get_model as jget_model
from safe_control_tpu.sim import tracking as jtracking
from safe_control_tpu.solvers import cbf_qp as jcbf_qp
from safe_control_tpu.solvers import mpc_cbf as jmpc

jax.config.update("jax_platforms", "cpu")
CONFIGS = Path(__file__).resolve().parent.parent / "configs"
F64 = torch.float64


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def jax_spec(c):
    return jspec.make_spec(c["model"], **c["spec"])


def ref_model(c):
    return make_model(c["model"], SimpleNamespace(**c["spec"]))


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def du_problems(B=4, seed=3):
    """Route starts of the DU scene, each with its next waypoint as goal and
    the first five obstacles of the scene by distance."""
    c = config("du_mpc_cbf")
    x0, nxt = generate.route_starts(c["scene"], c["spec"]["radius"],
                                    {"lateral_m": 0.3, "speed_range": [0.0, 0.8],
                                     "clearance_m": 0.1}, generate.generator(seed), B)
    wps = torch.tensor(c["scene"]["waypoints"], dtype=torch.float32)
    goal = torch.zeros((B, 4))
    goal[:, :2] = wps[nxt]
    obs = pad_obstacles(c["scene"]["obstacles"], 16)
    d = torch.linalg.vector_norm(obs[None, :, :2] - x0[:, None, :2], dim=-1)
    sel = obs[torch.argsort(d, dim=-1)[:, :5]]
    return [a.double().numpy() for a in (x0, goal, sel, torch.zeros((B, 2)),
                                         torch.zeros((B, 10, 2)))]


@pytest.mark.parametrize("name", ["du_mpc_cbf", "dpcbf_cbf_qp"])
def test_model_step_and_nominal_input_match_jax(name):
    c = config(name)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 10, (16, 2)), rng.uniform(-3, 3, (16, 1)),
                        rng.uniform(0.3, 1.5, (16, 1))], axis=1)
    u = rng.uniform(-0.5, 0.5, (16, 2))
    goal = rng.uniform(0, 12, (16, 2))
    model, jm, js = ref_model(c), jget_model(c["model"]), jax_spec(c)
    with jax.enable_x64(True):
        want_x = np.asarray(jax.vmap(lambda a, b: jm.step(a, b, js, 0.05))(jnp.asarray(x),
                                                                         jnp.asarray(u)))
        want_u = np.asarray(jax.vmap(lambda a, g: jm.nominal_input(a, g, js))(
            jnp.asarray(x), jnp.asarray(goal)))
    np.testing.assert_allclose(model.step(t64(x), t64(u), 0.05).numpy(), want_x, atol=1e-12)
    np.testing.assert_allclose(model.nominal_input(t64(x), t64(goal)).numpy(), want_u,
                               atol=1e-12)


def sweep_problems(B=8, seed=5):
    c = config("dpcbf_cbf_qp")
    obs, x0 = generate.dpcbf_scenarios(c["scene"], {}, generate.generator(seed), B)
    rng = np.random.default_rng(seed)
    x = x0.double().numpy()
    x[:, 0] = rng.uniform(4.0, 12.0, B)
    x[:, 1] = rng.uniform(5.0, 10.0, B)
    x[:, 2] = rng.uniform(-0.5, 0.5, B)
    u_ref = rng.uniform(-2.0, 2.0, (B, 2))
    u_ref[:, 1] = rng.uniform(-0.2, 0.2, B)
    return c, x, u_ref, obs.double().numpy()


def test_dpcbf_rows_match_jax():
    from safe_control_tpu.barriers.hocbf import ct_cbf_row

    c, x, _, obs = sweep_problems()
    model, jm, js = ref_model(c), jget_model(c["model"]), jax_spec(c)
    a_row, b = qp_ref.cbf_rows(model, t64(x), t64(obs))
    row = lambda xx, oo: ct_cbf_row(jm, c["model"], xx, oo, js, 0.05)
    with jax.enable_x64(True):
        want_a, want_b = jax.vmap(jax.vmap(row, (None, 0)))(jnp.asarray(x), jnp.asarray(obs))
    np.testing.assert_allclose(a_row.numpy(), np.asarray(want_a), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(b.numpy(), np.asarray(want_b), rtol=1e-10, atol=1e-10)


def test_cbf_qp_matches_jax():
    """The CBF-QP with the ADMM sweep, polish and residuals at the sweep's
    400 iterations, float64."""
    c, x, u_ref, obs = sweep_problems()
    model, js = ref_model(c), jax_spec(c)
    got = qp_ref.cbf_qp(model, t64(x), t64(u_ref), t64(obs), 400)
    with jax.enable_x64(True):
        res = jax.jit(jax.vmap(lambda a, b, o: jcbf_qp.solve(
            c["model"], js, a, b, o, 0.05, iters=400)))(jnp.asarray(x), jnp.asarray(u_ref),
                                                       jnp.asarray(obs))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(res.u), atol=1e-6)
    assert (got.feasible.numpy() == np.asarray(res.feasible)).all()


def test_mpc_solve_matches_jax():
    """The augmented-Lagrangian Gauss-Newton MPC-CBF solve at the
    configuration's N=10, K=5 and 8x3 budget, float64, on route starts."""
    c = config("du_mpc_cbf")
    inputs = du_problems()
    st = mpc_ref.settings_from(c["mpc"])
    got = mpc_ref.solve(ref_model(c), st, 0.05, *(t64(a) for a in inputs))
    js = jax_spec(c)
    m = c["mpc"]
    cfg = jmpc.MPCConfig(horizon=m["horizon"], num_obs=m["num_obs"],
                         outer_iters=m["outer_iters"], newton_iters=m["newton_iters"])
    n_con = jmpc._num_constraints(jmpc.get_model(c["model"]), cfg)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(c["model"], js, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), jnp.float64)), 0.05, cfg)
        return r.u, r.viol, r.xs

    with jax.enable_x64(True):
        u, viol, xs = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
            *(jnp.asarray(a) for a in inputs)))
    assert np.abs(got.u.numpy() - u).max() <= 1e-6
    assert np.abs(got.viol.numpy() - viol).max() <= 1e-6
    assert np.abs(got.xs.numpy() - xs).max() <= 1e-6
    assert float(got.active_rows) > 0


def test_select_obstacles_and_moving_obstacles_match_jax():
    c = config("du_mpc_cbf")
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 14, (32, 2))
    heading = rng.uniform(-math.pi, math.pi, 32)
    speed = rng.uniform(-0.2, 1.0, 32)
    obs = pad_obstacles(c["scene"]["obstacles"], 16, dtype=F64).numpy()
    got = ref_tracking.select_obstacles(10, 1.2 * math.pi, t64(pos), t64(heading),
                                        t64(obs).expand(32, 16, 7), t64(speed))
    jcfg = jtracking.TrackerConfig(model_name=c["model"], pos_controller="mpc_cbf", num_obs=10)
    js = jax_spec(c)
    with jax.enable_x64(True):
        want = jax.vmap(lambda p, h, s: jtracking.select_obstacles(
            jcfg, js, p, h, jnp.asarray(obs), s))(jnp.asarray(pos), jnp.asarray(heading),
                                                  jnp.asarray(speed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    d = config("dpcbf_cbf_qp")
    moving, _ = generate.dpcbf_scenarios(d["scene"], {}, generate.generator(2), 6)
    moving = moving.double()
    moving[:, :, 1] = torch.linspace(-0.5, 15.5, 8, dtype=F64)
    got = ref_tracking.move_obstacles(moving, 0.05, d["scene"]["y_range"])
    with jax.enable_x64(True):
        want = jax.vmap(lambda o: jtracking.step_dynamic_obstacles(
            o, 0.05, y_range=tuple(d["scene"]["y_range"])))(jnp.asarray(moving.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
