"""Port parity: the batched ADMM QP solver, the Cholesky split and the
optimal-decay CBF-QP.

The same random QPs (numpy seed) go through the JAX ``solve_qp`` (vmapped)
and the port's natively batched ``solve_qp``.  Problems both solve to
prim_res < 1e-4 must agree within 1e-3 in float32 (two float32 solves of
one problem by different operation orders) and within 1e-6 in float64.
Analytic QPs hold the port to their exact optima.  The optimal-decay QP
must agree with JAX within 2e-3 (the envelope of the CBF-QP comparisons).
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
from safe_control_tpu.solvers import optimal_decay_cbf_qp as jod
from safe_control_tpu.solvers.qp import solve_qp as jsolve_qp
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.core import spec as tspec
from safe_control_tpu_torch.solvers import chol
from safe_control_tpu_torch.solvers import optimal_decay_cbf_qp as tod
from safe_control_tpu_torch.solvers import qp as tqp

torch.set_num_threads(1)  # a threaded MKL LU of 128+ rows has hung (SLASWP errors)

DT = 0.05


def random_qps(seed, B, n, m, one_sided=3):
    """Feasible-by-construction QPs: the bounds bracket A x_star."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    Ax = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.5)
    l = Ax - rng.uniform(0.1, 2.0, size=(B, m))
    u = Ax + rng.uniform(0.1, 2.0, size=(B, m))
    u[:, :one_sided] = np.inf
    return P, q, A, l, u


def jax_solve(qps, dtype, iters):
    with jax.enable_x64(dtype == jnp.float64):
        sol = jax.jit(jax.vmap(lambda *a: jsolve_qp(*a, iters=iters)))(
            *(jnp.asarray(a, dtype) for a in qps))
        return [np.asarray(t) for t in sol]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("float64", 1e-6)])
def test_solve_qp_matches_jax(dtype, tol):
    qps = random_qps(0, 16, 3, 10)
    jx, jy, jprim, jdual = jax_solve(qps, getattr(jnp, dtype), 400)
    sol = tqp.solve_qp(*interop.qp_from_numpy(*qps, dtype=getattr(torch, dtype)), iters=400)
    assert sol.x.shape == (16, 3) and sol.y.shape == (16, 10)
    assert sol.prim_res.shape == (16,) and sol.dual_res.shape == (16,)
    ok = (jprim < 1e-4) & (sol.prim_res.numpy() < 1e-4)
    assert ok.sum() >= 12
    assert np.abs(sol.x.numpy() - jx)[ok].max() < tol
    assert np.abs(sol.y.numpy() - jy)[ok].max() < tol
    assert sol.dual_res.numpy()[ok].max() < 1e-3


def test_solve_box_qp_batch_is_solve_qp():
    qps = interop.qp_from_numpy(*random_qps(1, 4, 2, 6))
    a, b = tqp.solve_qp(*qps, iters=200), tqp.solve_box_qp_batch(*qps, iters=200)
    for s, t in zip(a, b):
        assert torch.equal(s, t)


def test_analytic_optima():
    """Projection onto a box, one active inequality, and no constraints."""
    # min ||x - c||^2 s.t. -1 <= x <= 1  =>  clip(c)
    c = torch.tensor([[2.0, -3.0, 0.5, 0.0], [0.2, 9.0, -0.1, -4.0]])
    eye = torch.eye(4).expand(2, 4, 4)
    sol = tqp.solve_qp(2.0 * eye, -2.0 * c, eye, -torch.ones(2, 4), torch.ones(2, 4), iters=100)
    np.testing.assert_allclose(sol.x.numpy(), np.clip(c.numpy(), -1, 1), atol=1e-5)
    # min ||u - ur||^2 s.t. a'u + b >= 0, active:  u = ur + a max(0, -(a'ur+b)) / |a|^2
    ur, a, b = np.array([1.0, 0.0]), np.array([1.0, 1.0]), -3.0
    sol = tqp.solve_qp(2.0 * torch.eye(2)[None], torch.tensor(-2.0 * ur[None], dtype=torch.float32),
                       torch.tensor(a[None, None], dtype=torch.float32),
                       torch.tensor([[-b]]), torch.tensor([[np.inf]]), iters=100)
    want = ur + a * (-(a @ ur + b) / (a @ a))
    np.testing.assert_allclose(sol.x[0].numpy(), want, atol=1e-5)
    assert sol.prim_res[0] < 1e-5
    # Unconstrained: x = -P^-1 q (rows with infinite bounds on both sides).
    P, q = random_qps(2, 3, 4, 4)[:2]
    inf = np.full((3, 4), np.inf)
    sol = tqp.solve_qp(*interop.qp_from_numpy(P, q, np.tile(np.eye(4), (3, 1, 1)), -inf, inf,
                                              dtype=torch.float64), iters=200)
    np.testing.assert_allclose(sol.x.numpy(), -np.linalg.solve(P, q[..., None])[..., 0],
                               atol=1e-6)


def test_polish_keeps_admm_iterate_on_a_singular_kkt():
    """A zero P with an active row whose A is zero makes the KKT matrix
    singular (reg = 0): solve_ex reports it in ``info`` and the polish keeps
    the ADMM iterate, where ``torch.linalg.solve`` would raise."""
    P = torch.zeros((1, 2, 2), dtype=torch.float64)
    q = torch.zeros((1, 2), dtype=torch.float64)
    A = torch.tensor([[[1.0, 0.0], [0.0, 0.0]]], dtype=torch.float64)
    l = torch.tensor([[0.5, -1.0]], dtype=torch.float64)
    u = torch.tensor([[np.inf, 1.0]], dtype=torch.float64)
    x = torch.tensor([[0.7, 0.3]], dtype=torch.float64)
    y = torch.tensor([[0.0, 0.0]], dtype=torch.float64)
    xp, yp = tqp._polish(P, q, A, l, u, x, y, 0.0, 1e-4)
    assert torch.equal(xp, x) and torch.equal(yp, y)
    # and a regular one is polished onto its active set
    P = torch.eye(2, dtype=torch.float64)[None]
    q = torch.tensor([[-1.0, 0.0]], dtype=torch.float64)
    l = torch.tensor([[1.5, -1.0]], dtype=torch.float64)
    xp, _ = tqp._polish(P, q, A, l, u, torch.tensor([[1.50001, 0.0]], dtype=torch.float64), y,
                        1e-8, 1e-4)
    np.testing.assert_allclose(xp.numpy(), [[1.5, 0.0]], atol=1e-7)


@pytest.mark.parametrize("D", [2, 3, 16])
def test_chol_factor_and_solve_split(D):
    """chol_solve is chol_factor + chol_solve_factored, bit for bit, and the
    factor is lower triangular and solves H x = g."""
    rng = np.random.default_rng(D)
    M = rng.normal(size=(8, D, D))
    H = torch.as_tensor(M @ M.transpose(0, 2, 1) + np.eye(D), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=(8, D)), dtype=torch.float32)
    L = chol.chol_factor(H)
    assert torch.equal(L, torch.tril(L))
    assert torch.equal(chol.chol_solve(H, g), chol.chol_solve_factored(L, g))
    np.testing.assert_allclose((L @ L.transpose(1, 2)).numpy(), H.numpy(), rtol=1e-5, atol=1e-4)
    want = np.linalg.solve(H.double().numpy(), g.double().numpy()[..., None])[..., 0]
    np.testing.assert_allclose(chol.chol_solve(H, g).numpy(), want, rtol=1e-3, atol=1e-4)


def test_chol_pivot_clamp():
    """A singular (rank-1) matrix still factors: the zero pivot is clamped to
    sqrt(1e-20), where torch.linalg.cholesky would raise."""
    L = chol.chol_factor(torch.tensor([[[1.0, 1.0], [1.0, 1.0]]]))
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(L[0].numpy(), [[1.0, 0.0], [1.0, 1e-10]], rtol=1e-6)


OD_STATES = {
    DOUBLE_INTEGRATOR_2D: lambda rng, B: np.concatenate(
        [rng.uniform(0, 2.5, (B, 2)), rng.uniform(0.2, 0.9, (B, 2))], axis=1),
    SINGLE_INTEGRATOR_2D: lambda rng, B: rng.uniform(0, 2.5, (B, 2)),
    DYNAMIC_UNICYCLE_2D: lambda rng, B: np.concatenate(
        [rng.uniform(0, 2.5, (B, 2)), rng.uniform(0, 1.5, (B, 1)), rng.uniform(0.2, 0.9, (B, 1))],
        axis=1),
}


@pytest.mark.parametrize("name", list(OD_STATES))
def test_optimal_decay_matches_jax(name):
    rng = np.random.default_rng(4)
    B = 8
    x = OD_STATES[name](rng, B)
    u_ref = rng.uniform(0.3, 1.0, (B, 2))
    near = np.tile(np.array([2.5, 2.5, 0.5, 0, 0, 0, 0.0]), (B, 1))
    near[1] = [1000.0, 1000.0, 0, 0, 0, 0, 0]  # a dummy: inert row
    near[2] = [2.0, 2.6, 0.6, 0.35, 4.0, 0.3, 1.0]  # a superellipsoid
    js, ts = make_spec(name), tspec.make_spec(name)
    f = jax.jit(jax.vmap(lambda a, b, c: jod.solve(name, js, a, b, c, DT)))
    want = [np.asarray(t) for t in f(*(jnp.asarray(a, jnp.float32) for a in (x, u_ref, near)))]
    got = tod.solve(name, ts, *(torch.as_tensor(a, dtype=torch.float32) for a in (x, u_ref, near)),
                    DT)
    for g, w, label in zip(got[:3], want[:3], ("u", "omega1", "omega2")):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3, err_msg=label)
    np.testing.assert_array_equal(got.feasible.numpy(), want[3])
    assert got.feasible.all()  # the relaxation keeps every QP feasible
