"""Port parity: the general MPC-CBF solve (``solvers/mpc_cbf.solve``).

Relative degree 1 (Quad3D, RK4, the dh + alpha h row) is held to the JAX
float64 solve at 1e-6 on four spread starts with a random warm start, N=5,
the full budget.  Relative degree 2 is the DynamicUnicycle2D batch below.

Sixteen DynamicUnicycle2D problems at N=8, K=5 and the full 8 outer x 3
Newton budget, with a circle obstacle close enough to be active, a
superellipsoid row and dummy rows, and a non-zero warm start; made from a
numpy seed and handed to the JAX ``mpc_cbf.solve`` (vmapped) and to the
port's natively batched ``solve``.

- float64: the same algorithm with the same order of operations up to
  summation order, so first controls and violations agree to 1e-6 (measured
  ~3e-14: no line-search or noise-phase decision flips on this batch).
- float32: the kernel-class envelope of the JAX package,
  ``tests/test_mpc_du_kernel.py``: |du| < 5e-3 and viol atol 1e-3, on that
  test's batch form (zero u_prev and warm start).  With a random warm start
  two float32 solves of one problem drift apart in cost-flat directions by
  as much as either lies from the float64 answer: the JAX float32 solve
  itself lies up to 2.8e-2 from JAX float64 on ``problems(seed=1)``.  So
  the warm-started batch is held to the float64 gate, and the float32 gate
  runs on the cold batch.

The variants: ``optimal_decay`` (r=2 here, r=1 on Unicycle2D), the KKT
polish (``polish_iters``) and ``newton_f64`` are held to the JAX float64
solve at 1e-6; ``newton_f64`` also in float32 against the JAX float32 run
(eager: under ``jax.jit`` the JAX package's float64 Newton system does not
trace in this JAX version), within the float32 envelope 5e-3.  The new
models' general solves (r=1: Unicycle2D, C3BF, DPCBF; r=2:
KinematicBicycle2D, Quad2D) are held to 1e-6 in float64; Manipulator2D has
no MPC cost weights in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DYNAMIC_UNICYCLE_2D,
    KINEMATIC_BICYCLE_2D,
    KINEMATIC_BICYCLE_2D_C3BF,
    KINEMATIC_BICYCLE_2D_DPCBF,
    MANIPULATOR_2D,
    QUAD_2D,
    QUAD_3D,
    UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.solvers import mpc_cbf as tmpc

torch.set_num_threads(1)

B, N, DT = 16, 8, 0.05
JSPEC = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
TSPEC = interop.spec_from_jax(JSPEC)
JCFG = jmpc.MPCConfig(horizon=N, num_obs=5)
TCFG = interop.config_from_jax(JCFG)


def problems(seed=0, warm=True):
    """16 problems; ``warm=False`` zeroes u_prev and the warm start, the form
    of the JAX package's own kernel-parity batch."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(0, 3, (B, 2)), rng.uniform(-1, 1, (B, 1)),
                         rng.uniform(0, 0.8, (B, 1))], axis=1)
    goals = np.tile(np.array([5.0, 1.0, 0.0, 0.0]), (B, 1))
    obs1 = np.asarray(pad_obstacles(jnp.asarray(
        [[2.5, 0.8, 0.4, 0, 0, 0, 0],
         [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], jnp.float32), 5))  # superellipsoid row
    obs = np.tile(obs1[None], (B, 1, 1))
    u_prevs = rng.uniform(-0.2, 0.2, (B, 2)) * warm
    Uw = rng.uniform(-0.3, 0.3, (B, N, 2)) * warm
    return xs, goals, obs, u_prevs, Uw


def jax_solve(inputs, dtype):
    n_con = jmpc._num_constraints(jmpc.get_model(DYNAMIC_UNICYCLE_2D), JCFG)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(DYNAMIC_UNICYCLE_2D, JSPEC, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), dtype)), DT, JCFG)
        return r.u, r.viol, r.state.U

    with jax.enable_x64(dtype == jnp.float64):
        args = [jnp.asarray(a, dtype) for a in inputs]
        return [np.asarray(a) for a in jax.jit(jax.vmap(one))(*args)]


def torch_solve(inputs, dtype, fn=tmpc.solve, cfg=TCFG):
    xs, goals, obs, ups, Uw = (torch.as_tensor(a, dtype=dtype) for a in inputs)
    st = tmpc.init_state(DYNAMIC_UNICYCLE_2D, cfg, B, dtype=dtype)
    st = st._replace(U=Uw)
    return fn(DYNAMIC_UNICYCLE_2D, TSPEC, xs, goals, obs, ups, st, DT, cfg)


def test_solve_f64_matches_jax_f64():
    inputs = problems()
    u_ref, viol_ref, U_ref = jax_solve(inputs, jnp.float64)
    res = torch_solve(inputs, torch.float64)
    assert np.abs(res.u.numpy() - u_ref).max() <= 1e-6
    assert np.abs(res.viol.numpy() - viol_ref).max() <= 1e-6
    assert np.abs(res.state.U.numpy() - U_ref).max() <= 1e-6
    # the batch exercises active CBF rows and infeasible starts
    assert (res.state.lam[:, : N * 5] > 0).any()
    assert (res.viol > 0.01).any() and (res.viol == 0).any()
    assert res.xs.shape == (B, N + 1, 4) and res.feasible.dtype == torch.bool


def test_solve_f32_within_kernel_envelope_of_jax_f32():
    inputs = [a.astype(np.float32) for a in problems(warm=False)]
    u_ref, viol_ref, _ = jax_solve(inputs, jnp.float32)
    res = torch_solve(inputs, torch.float32)
    assert np.abs(res.u.numpy() - u_ref).max() < 5e-3
    np.testing.assert_allclose(res.viol.numpy(), viol_ref, atol=1e-3)
    assert torch.isfinite(res.xs).all()


def test_solve_batch_without_kernel_is_solve():
    inputs = [a.astype(np.float32) for a in problems(seed=1)]
    a = torch_solve(inputs, torch.float32)
    b = torch_solve(inputs, torch.float32, fn=tmpc.solve_batch)
    for x, y in zip((a.u, a.state.U, a.state.lam, a.xs, a.viol),
                    (b.u, b.state.U, b.state.lam, b.xs, b.viol)):
        assert torch.equal(x, y)


def test_fused_kernel_available_agrees_with_jax():
    cfg = jmpc.MPCConfig(horizon=8, num_obs=5, use_fused_kernel=True)
    cases = [
        (DYNAMIC_UNICYCLE_2D, cfg),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(horizon=10)),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(optimal_decay=True)),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(polish_iters=2)),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(newton_f64=True)),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(outer_iters=4)),
        (DYNAMIC_UNICYCLE_2D, cfg._replace(rho_growth=2.0)),
        ("DoubleIntegrator2D", cfg),
    ]
    for name, c in cases:
        assert tmpc.fused_kernel_available(name, interop.config_from_jax(c)) == \
            jmpc.fused_kernel_available(name, c), (name, c)
    assert tmpc.fused_kernel_available(DYNAMIC_UNICYCLE_2D, interop.config_from_jax(cfg))


def _decay_inputs(inputs):
    """The batch with the two decay multipliers a stage appended to the warm
    start, spread around omega_ref."""
    xs, goals, obs, ups, Uw = inputs
    om = 1.0 + np.random.default_rng(5).uniform(-0.3, 0.3, Uw.shape[:2] + (2,))
    return xs, goals, obs, ups, np.concatenate([Uw, om], axis=-1)


@pytest.mark.parametrize("option", [dict(optimal_decay=True), dict(polish_iters=2),
                                    dict(newton_f64=True)])
def test_unported_options_raise(option):
    """The three options that the first slices left out, each now held to the
    JAX package: float64 at 1e-6 (``newton_f64`` changes nothing there),
    and ``newton_f64`` in float32 as well.  The polish and ``newton_f64``
    run at N=4 (28 constraint rows), which keeps the JAX compile of the
    polish's Schur solves short."""
    jcfg = JCFG._replace(**option)
    inputs = problems()
    if option.get("optimal_decay"):
        inputs = _decay_inputs(inputs)
    else:
        jcfg = jcfg._replace(horizon=4)
        inputs = inputs[:4] + (inputs[4][:, :4],)
    tcfg = interop.config_from_jax(jcfg)
    n_con = jmpc._num_constraints(jmpc.get_model(DYNAMIC_UNICYCLE_2D), jcfg)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(DYNAMIC_UNICYCLE_2D, JSPEC, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), x.dtype)), DT, jcfg)
        return r.u, r.viol, r.state.U, r.state.lam

    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jax.jit(jax.vmap(one))(
            *(jnp.asarray(a, jnp.float64) for a in inputs))]
    res = torch_solve(inputs, torch.float64, cfg=tcfg)
    for got, w in zip((res.u, res.viol, res.state.U), want):
        assert np.abs(got.numpy() - w).max() <= 1e-6
    assert np.abs(res.state.lam.numpy() - want[3]).max() <= 1e-6 * max(1.0, np.abs(want[3]).max())
    if option.get("optimal_decay"):
        assert res.state.U.shape == (B, N, 4) and res.u.shape == (B, 2)
    if option.get("polish_iters"):  # the polish moved the solution
        plain = torch_solve(inputs, torch.float64, cfg=tcfg._replace(polish_iters=0))
        assert (plain.state.U - res.state.U).abs().max() > 1e-9
    if option.get("newton_f64"):
        small = [a[:1].astype(np.float32) for a in problems(warm=False)]
        small_cfg = jcfg._replace(outer_iters=1, newton_iters=2)  # eager JAX is slow
        n_con = jmpc._num_constraints(jmpc.get_model(DYNAMIC_UNICYCLE_2D), small_cfg)

        def one32(x, goal, ob, up, U):
            r = jmpc.solve(DYNAMIC_UNICYCLE_2D, JSPEC, x, goal, ob, up,
                           jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), jnp.float32)), DT,
                           small_cfg)
            return r.u, r.viol

        with jax.disable_jit():
            u32, v32 = (np.asarray(a) for a in jax.vmap(one32)(
                *(jnp.asarray(a) for a in small[:4]), jnp.asarray(small[4][:, :4])))
        t = [torch.as_tensor(a) for a in small]
        cfg32 = interop.config_from_jax(small_cfg)
        st = tmpc.init_state(DYNAMIC_UNICYCLE_2D, cfg32, 1)._replace(U=t[4][:, :4])
        r32 = tmpc.solve(DYNAMIC_UNICYCLE_2D, TSPEC, *t[:4], st, DT, cfg32)
        assert r32.u.dtype == torch.float32 and torch.isfinite(r32.u).all()
        assert np.abs(r32.u.numpy() - u32).max() < 5e-3
        np.testing.assert_allclose(r32.viol.numpy(), v32, atol=1e-3)


def test_rti_preset_matches_jax():
    assert tuple(tmpc.MPCConfig.rti()) == tuple(jmpc.MPCConfig.rti())
    assert tuple(tmpc.MPCConfig.rti(horizon=30, newton_iters=3)) == \
        tuple(jmpc.MPCConfig.rti(horizon=30, newton_iters=3))
    assert (tmpc.MPCConfig.rti().outer_iters, tmpc.MPCConfig.rti().newton_iters) == (2, 2)


def test_optimal_decay_init_state_matches_jax():
    cfg = JCFG._replace(optimal_decay=True)
    want = jmpc.init_state(DYNAMIC_UNICYCLE_2D, cfg)
    got = tmpc.init_state(DYNAMIC_UNICYCLE_2D, interop.config_from_jax(cfg), 3)
    assert got.U.shape == (3,) + want.U.shape and got.lam.shape == (3,) + want.lam.shape
    assert (got.U.numpy() == np.asarray(want.U)[None]).all()


def test_optimal_decay_feasible_in_tight_scene():
    """``tests/test_optimal_decay.py``'s tight scene: the plain MPC cannot
    keep the row (viol > 0.1); the optimal-decay MPC can, with the omegas
    relaxed above 1, braking at full authority."""
    obs = pad_obstacles(jnp.asarray([[1.2, 0.0, 0.5, 0, 0, 0, 0]]), 5)
    ins = [torch.as_tensor(np.asarray(a))[None] for a in (
        [0.0, 0.0, 0.0, 1.0], [4.0, 0.0, 0.0, 0.0], obs, [0.0, 0.0])]
    plain_cfg = tmpc.MPCConfig(horizon=8, num_obs=5)
    r_plain = tmpc.solve(DYNAMIC_UNICYCLE_2D, TSPEC, *ins,
                         tmpc.init_state(DYNAMIC_UNICYCLE_2D, plain_cfg, 1), DT, plain_cfg)
    assert float(r_plain.viol) > 0.1
    od_cfg = plain_cfg._replace(optimal_decay=True)
    r_od = tmpc.solve(DYNAMIC_UNICYCLE_2D, TSPEC, *ins,
                      tmpc.init_state(DYNAMIC_UNICYCLE_2D, od_cfg, 1), DT, od_cfg)
    assert bool(r_od.feasible) and float(r_od.viol) < 1e-3
    assert r_od.state.U[0, :, 2:].max().item() > 1.05
    assert float(r_od.u[0, 0]) == -1.0


NEW_MPC = {  # model: (state sampler, relative degree)
    UNICYCLE_2D: 1, KINEMATIC_BICYCLE_2D: 2, KINEMATIC_BICYCLE_2D_C3BF: 1,
    KINEMATIC_BICYCLE_2D_DPCBF: 1, QUAD_2D: 2,
}


def new_model_problems(name, Bn=4, n_h=5, seed=6):
    """Spread starts near a circle (moving for C3BF / DPCBF), goal (4, 1.5),
    a random warm start inside the input box."""
    rng = np.random.default_rng(seed)
    jm = jmpc.get_model(name)
    n, m = jm.N_STATES, jm.N_CONTROLS
    xs = np.zeros((Bn, n))
    xs[:, :2] = rng.uniform(0, 2, (Bn, 2))
    if name == QUAD_2D:
        xs[:, 3:5] = rng.uniform(-0.3, 0.3, (Bn, 2))
    else:
        xs[:, 2] = rng.uniform(-0.5, 0.5, Bn)
    if n == 4:
        xs[:, 3] = rng.uniform(0.5, 1.5, Bn)
    goals = np.zeros((Bn, n))
    goals[:, :2] = [4.0, 1.5]
    vel = [-0.4, 0.2] if name in (KINEMATIC_BICYCLE_2D_C3BF, KINEMATIC_BICYCLE_2D_DPCBF) else [0, 0]
    obs = np.tile(np.asarray(pad_obstacles(jnp.asarray(
        [[2.5, 1.2, 0.4, *vel, 0, 0], [1.5, 2.5, 0.3, 0, 0, 0, 0]], jnp.float32), 5))[None],
        (Bn, 1, 1))
    js = make_spec(name)
    lo, hi = np.asarray(jm.u_lb(js)), np.asarray(jm.u_ub(js))
    ups = rng.uniform(lo, hi, (Bn, m)) * 0.5 + (lo + hi) / 4
    Uw = rng.uniform(lo, hi, (Bn, n_h, m)) * 0.5 + (lo + hi) / 4
    return xs, goals, obs, ups, Uw


@pytest.mark.parametrize("name", list(NEW_MPC))
def test_new_model_solve_f64_matches_jax_f64(name):
    n_h = 5
    jcfg = jmpc.MPCConfig(horizon=n_h, num_obs=5)
    jspec = make_spec(name)
    inputs = new_model_problems(name, n_h=n_h)
    n_con = jmpc._num_constraints(jmpc.get_model(name), jcfg)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(name, jspec, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), jnp.float64)), DT, jcfg)
        return r.u, r.viol, r.xs

    with jax.enable_x64(True):
        u_ref, viol_ref, xs_ref = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
            *(jnp.asarray(a, jnp.float64) for a in inputs)))
    tcfg = interop.config_from_jax(jcfg)
    targs = [torch.as_tensor(a, dtype=torch.float64) for a in inputs]
    st = tmpc.init_state(name, tcfg, targs[0].shape[0], dtype=torch.float64)._replace(U=targs[4])
    res = tmpc.solve(name, interop.spec_from_jax(jspec), *targs[:4], st, DT, tcfg)
    assert tmpc.get_model(name).REL_DEG == NEW_MPC[name]
    assert np.isfinite(u_ref).all()
    assert np.abs(res.u.numpy() - u_ref).max() <= 1e-6
    assert np.abs(res.viol.numpy() - viol_ref).max() <= 1e-6
    assert np.abs(res.xs.numpy() - xs_ref).max() <= 1e-6


def test_manipulator_has_no_mpc_weights_in_either_package():
    cfg = tmpc.MPCConfig(horizon=4, num_obs=5)
    with pytest.raises(KeyError):
        jmpc.mpc_weights(MANIPULATOR_2D)
    with pytest.raises(KeyError):
        tmpc.solve(MANIPULATOR_2D, interop.spec_from_jax(make_spec(MANIPULATOR_2D)),
                   torch.zeros(1, 3), torch.zeros(1, 3), torch.zeros(1, 5, 7), torch.zeros(1, 3),
                   tmpc.init_state(MANIPULATOR_2D, cfg, 1), DT, cfg)


@pytest.mark.parametrize("name", [KINEMATIC_BICYCLE_2D_C3BF, KINEMATIC_BICYCLE_2D_DPCBF])
def test_moving_obstacle_solve_at_rest_is_nan_as_in_jax(name):
    """A robot at rest with a static circle and dummies: v_rel = 0 makes the
    barrier's derivative NaN, and the JAX solve returns NaN; so does the
    port's (the port repeats the reference, it does not repair it)."""
    cfg = jmpc.MPCConfig(horizon=4, num_obs=3, outer_iters=2, newton_iters=2)
    jspec = make_spec(name)
    obs = np.asarray(pad_obstacles(jnp.asarray([[2.0, 0.3, 0.4, 0, 0, 0, 0]]), 3))
    n_con = jmpc._num_constraints(jmpc.get_model(name), cfg)
    with jax.enable_x64(True):
        r = jax.jit(lambda: jmpc.solve(name, jspec, jnp.zeros(4), jnp.asarray([4.0, 0, 0, 0]),
                                       jnp.asarray(obs), jnp.zeros(2),
                                       jmpc.MPCState(U=jnp.zeros((4, 2)), lam=jnp.zeros(n_con)),
                                       DT, cfg))()
    tcfg = interop.config_from_jax(cfg)
    got = tmpc.solve(name, interop.spec_from_jax(jspec), torch.zeros(1, 4, dtype=torch.float64),
                     torch.tensor([[4.0, 0, 0, 0]], dtype=torch.float64),
                     torch.as_tensor(obs)[None], torch.zeros(1, 2, dtype=torch.float64),
                     tmpc.init_state(name, tcfg, 1, dtype=torch.float64), DT, tcfg)
    assert np.isnan(np.asarray(r.u)).all() and np.isnan(float(r.viol))
    assert torch.isnan(got.u).all() and torch.isnan(got.viol).all()
    np.testing.assert_array_equal(torch.isnan(got.xs[0]).numpy(), np.isnan(np.asarray(r.xs)))


def test_structure_queries_match_jax():
    jm = jmpc.get_model(DYNAMIC_UNICYCLE_2D)
    tm = tmpc.get_model(DYNAMIC_UNICYCLE_2D)
    np.testing.assert_array_equal(tmpc._bounded_mask(tm), jmpc._bounded_mask(jm))
    assert tmpc._num_constraints(tm, TCFG) == jmpc._num_constraints(jm, JCFG) == 56
    for got, want in zip(tmpc.mpc_weights(DYNAMIC_UNICYCLE_2D), jmpc.mpc_weights(DYNAMIC_UNICYCLE_2D)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_solve_relative_degree_1_quad3d_f64_matches_jax_f64():
    n5 = 5
    rng = np.random.default_rng(3)
    Bq = 4
    xs = np.zeros((Bq, 12))
    xs[:, :2] = rng.uniform(0, 3, (Bq, 2))
    xs[:, 2] = rng.uniform(4.5, 5.5, Bq)
    xs[:, 6:9] = rng.uniform(-0.5, 0.5, (Bq, 3))
    goals = np.zeros((Bq, 12))
    goals[:, :3] = [6.0, 2.0, 5.0]
    obs = np.tile(np.asarray(pad_obstacles(jnp.asarray(
        [[3.0, 1.0, 0.5, 0, 0, 0, 0], [1.5, 2.0, 0.4, 0, 0, 0, 0]], jnp.float32), 5))[None],
        (Bq, 1, 1))
    ups = rng.uniform(-1, 1, (Bq, 4))
    Uw = rng.uniform(-2, 2, (Bq, n5, 4))
    jspec = make_spec(QUAD_3D)
    jcfg = jmpc.MPCConfig(horizon=n5, num_obs=5)
    n_con = jmpc._num_constraints(jmpc.get_model(QUAD_3D), jcfg)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(QUAD_3D, jspec, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), jnp.float64)), DT, jcfg)
        return r.u, r.viol, r.xs

    with jax.enable_x64(True):
        u_ref, viol_ref, xs_ref = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
            *(jnp.asarray(a, jnp.float64) for a in (xs, goals, obs, ups, Uw))))
    tcfg = interop.config_from_jax(jcfg)
    targs = [torch.as_tensor(a, dtype=torch.float64) for a in (xs, goals, obs, ups, Uw)]
    st = tmpc.init_state(QUAD_3D, tcfg, Bq, dtype=torch.float64)._replace(U=targs[4])
    res = tmpc.solve(QUAD_3D, interop.spec_from_jax(jspec), *targs[:4], st, DT, tcfg)
    assert np.abs(res.u.numpy() - u_ref).max() <= 1e-6
    assert np.abs(res.viol.numpy() - viol_ref).max() <= 1e-6
    assert np.abs(res.xs.numpy() - xs_ref).max() <= 1e-6
    assert res.state.lam.shape == (Bq, n5 * 5)
