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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, QUAD_3D, make_spec
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


@pytest.mark.parametrize("option", [dict(optimal_decay=True), dict(polish_iters=2),
                                    dict(newton_f64=True)])
def test_unported_options_raise(option):
    inputs = [a.astype(np.float32) for a in problems()]
    with pytest.raises(NotImplementedError):
        torch_solve(inputs, torch.float32, cfg=TCFG._replace(**option))


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
