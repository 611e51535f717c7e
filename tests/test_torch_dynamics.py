"""Port parity: the dynamics models and the model registry.

Random float64 states and inputs from a numpy seed go through the JAX
model (vmapped) and the port (batched over the leading axis); ``f``, ``g``,
``step`` and ``dt_h`` must agree to 1e-12, i.e. to float64 rounding.
Quad3D's ``nominal_input``, ``stop`` and ``rotate_to`` go through a
pseudo-inverse, which numpy and JAX compute by different routes: 1e-6.

Unicycle2D, the KinematicBicycle2D family (with the C3BF and DPCBF
barriers), Quad2D and Manipulator2D are held to 1e-12 in every function,
and their derivatives at the two ties where PyTorch's and JAX's rules could
part: the bicycle's speed clip at v = v_max (0.5 of the tangent, as
``jnp.clip``) and the C3BF / DPCBF norms at a zero relative velocity (NaN,
as ``jnp.linalg.norm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    KINEMATIC_BICYCLE_2D,
    KINEMATIC_BICYCLE_2D_C3BF,
    KINEMATIC_BICYCLE_2D_DPCBF,
    MANIPULATOR_2D,
    QUAD_2D,
    QUAD_3D,
    SINGLE_INTEGRATOR_2D,
    UNICYCLE_2D,
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


@pytest.mark.parametrize("name", ["DynamicBicycle2D", "DriftingCar", "NoSuchModel"])
def test_get_model_raises_for_models_not_ported(name):
    with pytest.raises(ValueError, match="not yet ported"):
        get_model(name)


def test_registry_holds_every_model_but_two():
    from safe_control_tpu.dynamics import MODEL_REGISTRY as JREG
    from safe_control_tpu_torch.dynamics import MODEL_REGISTRY

    assert set(MODEL_REGISTRY) == set(JREG) - {"DynamicBicycle2D", "DriftingCar"}
    assert len(MODEL_REGISTRY) == 11


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


@pytest.mark.parametrize("name,n", [(DOUBLE_INTEGRATOR_2D, 4), (SINGLE_INTEGRATOR_2D, 2),
                                    (DYNAMIC_UNICYCLE_2D, 4)])
def test_tracking_helpers_match_jax_f64(name, n):
    """The tracking loop's model helpers: ``stop``, ``has_stopped`` and
    ``rotate_to`` (and ``yaw_rate_to`` for the integrators' yaw side
    channel), with a few states at rest so that ``has_stopped`` is mixed."""
    x, _, _ = _integrator_inputs(n, seed=3)
    x[:8, 2:] = 0.01
    rng = np.random.default_rng(4)
    theta = rng.uniform(-4, 4, x.shape[0])
    yaw = rng.uniform(-4, 4, x.shape[0])
    js, ts = make_spec(name, w_max=0.7), tspec.make_spec(name, w_max=0.7)
    jm, tm = jget_model(name), get_model(name)
    with jax.enable_x64(True):
        jx, jth, jyaw = (jnp.asarray(a, jnp.float64) for a in (x, theta, yaw))
        want = {
            "stop": jax.vmap(lambda s: jm.stop(s, js))(jx),
            "has_stopped": jax.vmap(lambda s: jm.has_stopped(s, js))(jx),
            "rotate_to": jax.vmap(lambda s, t: jm.rotate_to(s, t, js))(jx, jth),
        }
        if name != DYNAMIC_UNICYCLE_2D:
            want["yaw_rate_to"] = jax.vmap(lambda y, t: jm.yaw_rate_to(y, t, js))(jyaw, jth)
        want = {k: np.asarray(v) for k, v in want.items()}
    tx, tth, tyaw = (torch.as_tensor(a, dtype=torch.float64) for a in (x, theta, yaw))
    got = {"stop": tm.stop(tx, ts), "has_stopped": tm.has_stopped(tx, ts),
           "rotate_to": tm.rotate_to(tx, tth, ts)}
    if name != DYNAMIC_UNICYCLE_2D:
        got["yaw_rate_to"] = tm.yaw_rate_to(tyaw, tth, ts)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)
    stopped = got["has_stopped"].numpy()
    assert stopped.all() if name == SINGLE_INTEGRATOR_2D else (stopped.any() and not stopped.all())
    if "yaw_rate_to" in got:  # saturates at w_max for large errors
        assert np.abs(got["yaw_rate_to"].numpy()).max() == pytest.approx(0.7)


NEW_MODELS = [UNICYCLE_2D, KINEMATIC_BICYCLE_2D, KINEMATIC_BICYCLE_2D_C3BF,
              KINEMATIC_BICYCLE_2D_DPCBF, QUAD_2D, MANIPULATOR_2D]


def _new_model_inputs(name, B=64, seed=9):
    """States, inputs, goals and moving circle obstacles: the bicycles at
    speeds that reach both ends of the clip, Quad2D at thrusts that can
    lift it."""
    rng = np.random.default_rng(seed)
    n = jget_model(name).N_STATES
    x = rng.uniform(-3, 3, (B, n))
    u = rng.uniform(-1.5, 1.5, (B, jget_model(name).N_CONTROLS))
    if name.startswith("KinematicBicycle2D"):
        x[:, 3] = rng.uniform(-0.5, 4.0, B)
        u[:, 0] = rng.uniform(-6, 6, B)
    if name == QUAD_2D:
        x[:, 2] = rng.uniform(-4, 4, B)  # the wrap acts
        u = rng.uniform(2, 11, (B, 2))
    goal = np.concatenate([rng.uniform(-5, 5, (B, 2)), np.zeros((B, n - 2))], axis=1)
    obs = np.stack([rng.uniform(-3, 3, B), rng.uniform(-3, 3, B), rng.uniform(0.2, 1.0, B),
                    rng.uniform(-1, 1, B), rng.uniform(-1, 1, B), np.zeros(B), np.zeros(B)],
                   axis=1)
    return x, u, goal, obs


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_models_match_jax_f64(name):
    from safe_control_tpu.barriers import hocbf as jh
    from safe_control_tpu_torch.barriers import hocbf as th

    x, u, goal, obs = _new_model_inputs(name)
    th_des = np.random.default_rng(2).uniform(-4, 4, x.shape[0])
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    fns = {
        "f": lambda m, s, xx, uu, gg, oo, tt: m.f(xx, s),
        "g": lambda m, s, xx, uu, gg, oo, tt: m.g(xx, s),
        "step": lambda m, s, xx, uu, gg, oo, tt: m.step(xx, uu, s, DT),
        "nominal_input": lambda m, s, xx, uu, gg, oo, tt: m.nominal_input(xx, gg, s),
        "stop": lambda m, s, xx, uu, gg, oo, tt: m.stop(xx, s),
        "has_stopped": lambda m, s, xx, uu, gg, oo, tt: m.has_stopped(xx * 0.02, s),
        "rotate_to": lambda m, s, xx, uu, gg, oo, tt: m.rotate_to(xx, tt, s),
        "barrier_pos": lambda m, s, xx, uu, gg, oo, tt: m.barrier_pos(xx),
    }
    barriers = {
        "ct_h": lambda h, m, s, xx, oo: h.ct_h(m, name, xx, oo, s),
        "dt_h": lambda h, m, s, xx, oo: h.dt_h(m, name, xx, oo, s),
    }
    with jax.enable_x64(True):
        ja = [jnp.asarray(a, jnp.float64) for a in (x, u, goal, obs, th_des)]
        want = {k: np.asarray(jax.vmap(lambda *a, fn=fn: fn(jm, js, *a))(*ja))
                for k, fn in fns.items()}
        if name != MANIPULATOR_2D:
            for k, fn in barriers.items():
                want[k] = np.asarray(jax.vmap(lambda xx, oo, fn=fn: fn(jh, jm, js, xx, oo))(
                    ja[0], ja[3]))
        else:
            for k in ("joint_positions", "link_circle_centers", "end_effector"):
                want[k] = np.asarray(jax.vmap(lambda xx, k=k: getattr(jm, k)(xx, js))(ja[0]))
            want["ct_multi_h"] = np.asarray(jax.vmap(lambda xx, oo: jm.ct_multi_h(xx, oo, js))(
                ja[0], ja[3]))
    ta = [torch.as_tensor(a, dtype=torch.float64) for a in (x, u, goal, obs, th_des)]
    got = {k: fn(tm, ts, *ta) for k, fn in fns.items()}
    if name != MANIPULATOR_2D:
        got.update({k: fn(th, tm, ts, ta[0], ta[3]) for k, fn in barriers.items()})
    else:
        got.update({k: getattr(tm, k)(ta[0], ts)
                    for k in ("joint_positions", "link_circle_centers", "end_effector")})
        got["ct_multi_h"] = tm.ct_multi_h(ta[0], ta[3], ts)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)
    for lo_hi in zip(tm.state_bounds(ts, dtype=torch.float64), jm.state_bounds(js)):
        np.testing.assert_array_equal(lo_hi[0].numpy(), np.asarray(lo_hi[1]))
    np.testing.assert_allclose(tm.u_lb(ts).numpy(), np.asarray(jm.u_lb(js)), rtol=1e-7)
    np.testing.assert_allclose(tm.u_ub(ts).numpy(), np.asarray(jm.u_ub(js)), rtol=1e-7)
    assert (tm.N_STATES, tm.N_CONTROLS, tm.REL_DEG) == (jm.N_STATES, jm.N_CONTROLS, jm.REL_DEG)
    # one unbatched state works too (the solver's torch.func path)
    np.testing.assert_allclose(tm.step(ta[0][0], ta[1][0], ts, DT).numpy(), want["step"][0],
                               rtol=0, atol=1e-12)
    if name.startswith("KinematicBicycle2D"):  # the clip acted at both ends
        v1 = want["step"][:, 3]
        assert (v1 == js.v_max).any() and (v1 == js.v_min).any()
    if name == UNICYCLE_2D:  # the heading sigmoid is in ct_h, not in dt_h
        assert np.abs(want["ct_h"] - want["dt_h"]).max() > 0.1
    if name in (KINEMATIC_BICYCLE_2D, QUAD_2D):
        assert got["has_stopped"].any() or name == QUAD_2D


def test_bicycle_speed_clip_derivative_at_a_tie():
    """At v = v_max with a = 0 (a cruising robot, a cold warm start) the
    clip's derivative is 0.5, as JAX's, in float64 and float32."""
    name = KINEMATIC_BICYCLE_2D
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    x = np.array([[0.0, 0.0, 0.3, js.v_max], [0.0, 0.0, 0.3, js.v_min], [0.0, 0.0, 0.3, 1.0]])
    u = np.zeros((3, 2))
    t_u = np.array([1.0, 0.0])
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        with jax.enable_x64(jdt == jnp.float64):
            want = np.asarray(jax.vmap(lambda xx, uu: jax.jvp(
                lambda a: jm.step(xx, a, js, DT), (uu,), (jnp.asarray(t_u, jdt),))[1])(
                jnp.asarray(x, jdt), jnp.asarray(u, jdt)))
        tx, tu = torch.as_tensor(x, dtype=tdt), torch.as_tensor(u, dtype=tdt)
        got = torch.func.vmap(lambda xx, uu: torch.func.jvp(
            lambda a: tm.step(xx, a, ts, DT), (uu,), (torch.as_tensor(t_u, dtype=tdt),))[1])(tx, tu)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal((got[:, 3] / got[2, 3]).numpy(), [0.5, 0.5, 1.0])


@pytest.mark.parametrize("name", [KINEMATIC_BICYCLE_2D_C3BF, KINEMATIC_BICYCLE_2D_DPCBF])
def test_moving_obstacle_barrier_derivative_at_zero_relative_velocity(name):
    """A robot at rest beside a static obstacle: the derivative of h is NaN
    in the speed and heading directions, as in JAX; a moving robot's is
    finite and equal."""
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    x = np.array([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.4, 1.2]])
    obs = np.array([[2.0, 0.5, 0.3, 0.0, 0.0, 0.0, 0.0], [1000.0, 1000.0, 0, 0, 0, 0, 0]])
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jax.vmap(lambda xx: jax.grad(
            lambda z: jm.dt_h(z, jnp.asarray(o), js))(xx))(jnp.asarray(x))) for o in obs])
    got = torch.stack([torch.func.vmap(torch.func.grad(
        lambda z, o=o: tm.dt_h(z, torch.as_tensor(o), ts)))(torch.as_tensor(x)) for o in obs])
    assert np.isnan(want[:, 0, 2:]).all() and np.isfinite(want[:, 1]).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
