"""Port parity: DynamicUnicycle2D dynamics and the model registry.

Random float64 states and inputs from a numpy seed go through the JAX
model (vmapped) and the port (batched over the leading axis); ``f``, ``g``
and ``step`` must agree to 1e-12, i.e. to float64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
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


@pytest.mark.parametrize("name", ["DoubleIntegrator2D", "Quad3D", "NoSuchModel"])
def test_get_model_raises_for_models_not_ported(name):
    with pytest.raises(ValueError, match="not yet ported"):
        get_model(name)
