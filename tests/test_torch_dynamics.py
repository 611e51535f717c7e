"""Port parity: DynamicUnicycle2D, DoubleIntegrator2D and SingleIntegrator2D
dynamics and the model registry.

Random float64 states and inputs from a numpy seed go through the JAX
model (vmapped) and the port (batched over the leading axis); ``f``, ``g``
and ``step`` must agree to 1e-12, i.e. to float64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    SINGLE_INTEGRATOR_2D,
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


@pytest.mark.parametrize("name", ["Unicycle2D", "Quad3D", "NoSuchModel"])
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
