"""Port parity: DynamicUnicycle2D, DoubleIntegrator2D, SingleIntegrator2D,
Quad3D and VTOL2D dynamics and the model registry.

Random float64 states and inputs from a numpy seed go through the JAX
model (vmapped) and the port (batched over the leading axis); ``f``, ``g``,
``step`` and ``dt_h`` must agree to 1e-12, i.e. to float64 rounding.
Quad3D's ``nominal_input``, ``stop`` and ``rotate_to`` go through a
pseudo-inverse, which numpy and JAX compute by different routes: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    QUAD_3D,
    SINGLE_INTEGRATOR_2D,
    VTOL_2D,
    make_spec,
)
from safe_control_tpu.dynamics import get_model as jget_model
from safe_control_tpu_torch.core import spec as tspec
from safe_control_tpu_torch.dynamics import base, get_model

torch.set_num_threads(1)

DT = 0.05


def _states(B=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate(
        [rng.uniform(-5, 5, (B, 2)), rng.uniform(-4, 4, (B, 1)), rng.uniform(-1.5, 1.5, (B, 1))],
        axis=1,
    )
    u = rng.uniform(-1.5, 1.5, (B, 2))
    goal = np.concatenate([rng.uniform(-5, 5, (B, 2)), np.zeros((B, 2))], axis=1)
    return x, u, goal


def test_du_f_g_step_match_jax_f64():
    x, u, goal = _states()
    jspec_ = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    tspec_ = tspec.make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    jm, tm = jget_model(DYNAMIC_UNICYCLE_2D), get_model(DYNAMIC_UNICYCLE_2D)
    with jax.enable_x64(True):
        jx, ju, jg = (jnp.asarray(a, jnp.float64) for a in (x, u, goal))
        want_f = np.asarray(jax.vmap(lambda s: jm.f(s, jspec_))(jx))
        want_g = np.asarray(jax.vmap(lambda s: jm.g(s, jspec_))(jx))
        want_step = np.asarray(jax.vmap(lambda s, a: jm.step(s, a, jspec_, DT))(jx, ju))
        want_nom = np.asarray(jax.vmap(lambda s, gl: jm.nominal_input(s, gl, jspec_))(jx, jg))
    tx, tu, tg = (torch.as_tensor(a, dtype=torch.float64) for a in (x, u, goal))
    np.testing.assert_allclose(tm.f(tx, tspec_).numpy(), want_f, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.g(tx, tspec_).numpy(), want_g, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.step(tx, tu, tspec_, DT).numpy(), want_step, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.nominal_input(tx, tg, tspec_).numpy(), want_nom,
                               rtol=0, atol=1e-12)
    # one unbatched state works too (the solver's torch.func path)
    np.testing.assert_allclose(tm.step(tx[0], tu[0], tspec_, DT).numpy(), want_step[0],
                               rtol=0, atol=1e-12)


def test_du_bounds_and_barrier_pos():
    js = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    ts = tspec.make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    jm, tm = jget_model(DYNAMIC_UNICYCLE_2D), get_model(DYNAMIC_UNICYCLE_2D)
    np.testing.assert_array_equal(tm.u_lb(ts).numpy(), np.asarray(jm.u_lb(js)))
    np.testing.assert_array_equal(tm.u_ub(ts).numpy(), np.asarray(jm.u_ub(js)))
    for got, want in zip(tm.state_bounds(ts), jm.state_bounds(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.arange(8.0).reshape(2, 4)
    np.testing.assert_array_equal(tm.barrier_pos(x).numpy(), x[:, :2].numpy())
    assert (tm.N_STATES, tm.N_CONTROLS, tm.REL_DEG) == (jm.N_STATES, jm.N_CONTROLS, jm.REL_DEG)


def test_masked_apply_and_free_bounds():
    x = torch.tensor([[1.0, 2.0, 7.0, 4.0]], requires_grad=False)
    out = base.masked_apply(x, lambda t: -t, 2, 3)
    np.testing.assert_array_equal(out.numpy(), [[1.0, 2.0, -7.0, 4.0]])
    lo, hi = base.free_bounds(3)
    assert torch.isinf(lo).all() and (lo < 0).all() and torch.isinf(hi).all() and (hi > 0).all()


@pytest.mark.parametrize("name", ["Unicycle2D", "Manipulator2D", "NoSuchModel"])
def test_get_model_raises_for_models_not_ported(name):
    with pytest.raises(ValueError, match="not yet ported"):
        get_model(name)


def _integrator_inputs(n, B=64, seed=3):
    """States with speeds up to 2 (above v_max = 1, so DI's clamp acts)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-5, 5, (B, 2)), rng.uniform(-2, 2, (B, n - 2))], axis=1)
    u = rng.uniform(-1.5, 1.5, (B, 2))
    goal = np.concatenate([rng.uniform(-5, 5, (B, 2)), np.zeros((B, n - 2))], axis=1)
    return x, u, goal


@pytest.mark.parametrize("name,n", [(DOUBLE_INTEGRATOR_2D, 4), (SINGLE_INTEGRATOR_2D, 2)])
def test_integrators_match_jax_f64(name, n):
    x, u, goal = _integrator_inputs(n)
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    with jax.enable_x64(True):
        jx, ju, jg = (jnp.asarray(a, jnp.float64) for a in (x, u, goal))
        want = {
            "f": jax.vmap(lambda s: jm.f(s, js))(jx),
            "g": jax.vmap(lambda s: jm.g(s, js))(jx),
            "step": jax.vmap(lambda s, a: jm.step(s, a, js, DT))(jx, ju),
            "nominal_input": jax.vmap(lambda s, gl: jm.nominal_input(s, gl, js))(jx, jg),
            "stop": jax.vmap(lambda s: jm.stop(s, js))(jx),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    tx, tu, tg = (torch.as_tensor(a, dtype=torch.float64) for a in (x, u, goal))
    got = {
        "f": tm.f(tx, ts), "g": tm.g(tx, ts), "step": tm.step(tx, tu, ts, DT),
        "nominal_input": tm.nominal_input(tx, tg, ts), "stop": tm.stop(tx, ts),
    }
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tm.step(tx[0], tu[0], ts, DT).numpy(), want["step"][0],
                               rtol=0, atol=1e-12)
    if name == DOUBLE_INTEGRATOR_2D:  # the velocity clamp acted on some states
        speed = np.linalg.norm(want["step"][:, 2:4], axis=1)
        assert (np.abs(speed - js.v_max) < 1e-12).sum() >= 10
        assert speed.max() <= js.v_max + 1e-12


@pytest.mark.parametrize("name", [DOUBLE_INTEGRATOR_2D, SINGLE_INTEGRATOR_2D])
def test_integrator_bounds_and_barrier_pos(name):
    js, ts = make_spec(name, a_max=1.7), tspec.make_spec(name, a_max=1.7)
    jm, tm = jget_model(name), get_model(name)
    np.testing.assert_array_equal(tm.u_lb(ts).numpy(), np.asarray(jm.u_lb(js)))
    np.testing.assert_array_equal(tm.u_ub(ts).numpy(), np.asarray(jm.u_ub(js)))
    for got, want in zip(tm.state_bounds(ts), jm.state_bounds(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.arange(3.0 * tm.N_STATES).reshape(3, tm.N_STATES)
    np.testing.assert_array_equal(tm.barrier_pos(x).numpy(), x[:, :2].numpy())
    assert (tm.N_STATES, tm.N_CONTROLS, tm.REL_DEG) == (jm.N_STATES, jm.N_CONTROLS, jm.REL_DEG)
    assert get_model(name) is tm


def test_input_bounds_of_a_batched_spec():
    """The (B,) tensor fields of a batched spec give (B, m) input bounds."""
    ts = tspec.make_spec(DOUBLE_INTEGRATOR_2D).replace(
        ax_max=torch.tensor([1.0, 2.0]), ay_max=torch.tensor([0.5, 3.0]))
    tm = get_model(DOUBLE_INTEGRATOR_2D)
    np.testing.assert_array_equal(tm.u_lb(ts).numpy(), [[-1.0, -0.5], [-2.0, -3.0]])
    np.testing.assert_array_equal(tm.u_ub(ts).numpy(), [[1.0, 0.5], [2.0, 3.0]])


def _wide_inputs(name, B=64, seed=5):
    """Random states and inputs for the 12- and 6-state models: VTOL2D flies
    at 2..15 m/s with pitch and angle of attack up to about 1 rad, so both
    lift regimes and the +-40 exponent clamp are reached."""
    rng = np.random.default_rng(seed)
    if name == QUAD_3D:
        x = rng.uniform(-2, 2, (B, 12))
        x[:, 3:6] = rng.uniform(-4, 4, (B, 3))  # angles beyond pi: the wrap acts
        u = rng.uniform(-10, 10, (B, 4))
        goal = np.concatenate([rng.uniform(-5, 5, (B, 3)), np.zeros((B, 9))], axis=1)
    else:
        x = np.concatenate([rng.uniform(-5, 5, (B, 2)), rng.uniform(-1, 1, (B, 1)),
                            rng.uniform(2, 15, (B, 1)), rng.uniform(-3, 3, (B, 1)),
                            rng.uniform(-1, 1, (B, 1))], axis=1)
        u = np.concatenate([rng.uniform(0, 1, (B, 3)), rng.uniform(-0.5, 0.5, (B, 1))], axis=1)
        goal = np.concatenate([rng.uniform(-5, 5, (B, 2)), np.zeros((B, 4))], axis=1)
    obs = np.stack([rng.uniform(-3, 3, B), rng.uniform(-3, 3, B), rng.uniform(0.2, 1.0, B)]
                   + [np.zeros(B)] * 4, axis=1)
    return x, u, goal, obs


@pytest.mark.parametrize("name", [QUAD_3D, VTOL_2D])
def test_quad3d_vtol2d_match_jax_f64(name):
    x, u, goal, obs = _wide_inputs(name)
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    with jax.enable_x64(True):
        jx, ju, jg, jo = (jnp.asarray(a, jnp.float64) for a in (x, u, goal, obs))
        want = {
            "f": jax.vmap(lambda s: jm.f(s, js))(jx),
            "g": jax.vmap(lambda s: jm.g(s, js))(jx),
            "step": jax.vmap(lambda s, a: jm.step(s, a, js, DT))(jx, ju),
            "dt_h": jax.vmap(lambda s, o: jm.dt_h(s, o, js))(jx, jo),
        }
        slow = {
            "nominal_input": jax.vmap(lambda s, gl: jm.nominal_input(s, gl, js))(jx, jg),
            "stop": jax.vmap(lambda s: jm.stop(s, js))(jx),
            "rotate_to": jax.vmap(lambda s: jm.rotate_to(s, 0.7, js))(jx),
            "has_stopped": jax.vmap(lambda s: jm.has_stopped(s, js))(jx * 0.01),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
        slow = {k: np.asarray(v) for k, v in slow.items()}
    tx, tu, tg, to = (torch.as_tensor(a, dtype=torch.float64) for a in (x, u, goal, obs))
    got = {"f": tm.f(tx, ts), "g": tm.g(tx, ts), "step": tm.step(tx, tu, ts, DT),
           "dt_h": tm.dt_h(tx, to, ts)}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)
    got_slow = {"nominal_input": tm.nominal_input(tx, tg, ts), "stop": tm.stop(tx, ts),
                "rotate_to": tm.rotate_to(tx, 0.7, ts), "has_stopped": tm.has_stopped(tx * 0.01, ts)}
    for k in slow:
        assert got_slow[k].shape == slow[k].shape, k
        np.testing.assert_allclose(got_slow[k].numpy(), slow[k], rtol=0, atol=1e-6, err_msg=k)
    # one unbatched state works too (the solver's torch.func path)
    np.testing.assert_allclose(tm.step(tx[0], tu[0], ts, DT).numpy(), want["step"][0],
                               rtol=0, atol=1e-12)
    if name == QUAD_3D:  # the angle wrap acted
        assert (np.abs(x[:, 3:6]) > np.pi).any()
        assert np.abs(want["step"][:, 3:6]).max() <= np.pi
    else:  # both lift regimes: small and large angles of attack
        u_b = np.cos(x[:, 2]) * x[:, 3] + np.sin(x[:, 2]) * x[:, 4]
        w_b = -np.sin(x[:, 2]) * x[:, 3] + np.cos(x[:, 2]) * x[:, 4]
        alpha = np.arctan2(-w_b, u_b)
        assert (np.abs(alpha) < 0.2).any() and (np.abs(alpha) > 0.5).any()


@pytest.mark.parametrize("name", [QUAD_3D, VTOL_2D])
def test_quad3d_vtol2d_bounds_and_structure(name):
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    np.testing.assert_array_equal(tm.u_lb(ts).numpy(), np.asarray(jm.u_lb(js)))
    np.testing.assert_array_equal(tm.u_ub(ts).numpy(), np.asarray(jm.u_ub(js)))
    for got, want in zip(tm.state_bounds(ts, dtype=torch.float64), jm.state_bounds(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=0)
    x = torch.arange(3.0 * tm.N_STATES).reshape(3, tm.N_STATES)
    np.testing.assert_array_equal(tm.barrier_pos(x).numpy(), x[:, :2].numpy())
    assert (tm.N_STATES, tm.N_CONTROLS, tm.REL_DEG) == (jm.N_STATES, jm.N_CONTROLS, jm.REL_DEG)
    assert get_model(name) is tm
