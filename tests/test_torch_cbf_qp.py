"""Port parity: the batched CBF-QP safety filter.

``cbf_qp.solve_batch`` of the port against the JAX package's (its 'xla'
backend, vmapped) on the same numpy inputs, for DoubleIntegrator2D,
SingleIntegrator2D and DynamicUnicycle2D, 'cbf' and 'hard' mode, through
both port backends ('xla': the general ``qp.solve_qp``; 'pallas': the QP
kernel module, whose plain version runs on the CPU): |du| < 2e-3 and equal
``feasible`` flags, the JAX package's pallas-vs-xla gate
(``tests/test_qp_kernel.py``).  The committed goldens go through the port's
``cbf_qp.solve`` as ``tests/test_parity_anchors.py`` runs them: c1 (30
DoubleIntegrator2D anchors, K=5) and c5 (20 DynamicUnicycle2D anchors,
K=8) within 1e-3 of the float64 SLSQP solutions, and the first 60 steps of
the c1 closed loop within 5e-3 of its golden trajectory.

Unicycle2D, the KinematicBicycle2D family (C3BF and DPCBF against moving
circles), Quad2D and Manipulator2D (23 rows an obstacle: n=3, m=118 at
K=5) are held to the JAX package in float32 (2e-3, equal flags) and, in
float64, to 1e-6.
"""

import dataclasses
import os

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
    SINGLE_INTEGRATOR_2D,
    UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles as jpad
from safe_control_tpu.solvers import cbf_qp as jcbf
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.core import spec as tspec
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers import cbf_qp
from safe_control_tpu_torch.solvers import qp_kernel as qpk

torch.set_num_threads(1)

DT = 0.05
B = 8
DATA = np.load(os.path.join(os.path.dirname(__file__), "data", "parity_goldens.npz"))
OBS = np.asarray(jpad(jnp.asarray([[2.0, 2.0, 0.5, 0, 0, 0, 0],
                                   [1.2, 2.8, 0.4, 0.3, 4.0, 0.3, 1.0]], jnp.float32), 5))


def states(name, seed=2):
    """Robots heading toward the obstacles; the first three sit just outside
    the circle, moving at it at 0.45, where the 'hard' rows bind too."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.3, 1.4, (B, 2))
    pos[:3] = [[1.2, 2.0], [1.2, 2.05], [1.2, 1.95]]
    if name == SINGLE_INTEGRATOR_2D:
        return pos
    if name == DOUBLE_INTEGRATOR_2D:
        vel = rng.uniform(0.1, 0.6, (B, 2))
        vel[:3] = [0.45, 0.0]
        return np.concatenate([pos, vel], axis=1)
    th, v = rng.uniform(0.5, 1.0, (B, 1)), rng.uniform(0.1, 0.6, (B, 1))
    th[:3], v[:3] = 0.0, 0.45
    return np.concatenate([pos, th, v], axis=1)


def u_refs(seed=3):
    u = np.random.default_rng(seed).uniform(0.2, 1.0, (B, 2))
    u[:3] = [1.0, 0.0]
    return u


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("mode", ["cbf", "hard"])
@pytest.mark.parametrize("name", [DOUBLE_INTEGRATOR_2D, SINGLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D])
def test_solve_batch_matches_jax(name, mode):
    x, u_ref = states(name), u_refs()
    obs = np.tile(OBS[None], (B, 1, 1))
    js, ts = make_spec(name), tspec.make_spec(name)
    want = jcbf.solve_batch(name, js, *(jnp.asarray(a, jnp.float32) for a in (x, u_ref, obs)),
                            DT, backend="xla", mode=mode)
    want = [np.asarray(t) for t in want]
    assert want[1].sum() >= B // 2 and (np.abs(want[0] - u_ref) > 1e-2).sum() >= 3  # bind
    before = qpk.LAUNCH_COUNT
    for backend in ("xla", "pallas", "auto"):
        got = cbf_qp.solve_batch(name, ts, _t(x), _t(u_ref), _t(obs), DT, backend=backend,
                                 mode=mode)
        for g, w in zip(got, want):
            assert g.shape == w.shape, backend
        np.testing.assert_allclose(got.u.numpy(), want[0], atol=2e-3, err_msg=backend)
        np.testing.assert_array_equal(got.feasible.numpy(), want[1], err_msg=backend)
        finite = np.isfinite(want[2])
        np.testing.assert_allclose(got.h_min.numpy()[finite], want[2][finite], atol=2e-3)
    assert qpk.LAUNCH_COUNT == before  # CPU tensors never launch the kernel


def test_batched_spec_matches_jax():
    """Per-robot radius and input limits (a batched spec) in both packages."""
    name = DOUBLE_INTEGRATOR_2D
    base = make_spec(name)
    js = jax.tree_util.tree_map(lambda v: jnp.full((B,), v, jnp.float32), base)
    js = dataclasses.replace(js, radius=jnp.linspace(0.15, 0.35, B, dtype=jnp.float32),
                             ax_max=jnp.linspace(0.5, 1.5, B, dtype=jnp.float32))
    x, u_ref = states(name), u_refs()
    obs = np.tile(OBS[None], (B, 1, 1))
    want = jcbf.solve_batch(name, js, *(jnp.asarray(a, jnp.float32) for a in (x, u_ref, obs)),
                            DT, backend="xla")
    ts = interop.spec_from_jax(js)
    assert ts.radius.shape == (B,)
    got = cbf_qp.solve_batch(name, ts, _t(x), _t(u_ref), _t(obs), DT)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=2e-3)
    np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible))


def test_solve_batch_arguments():
    ts = tspec.make_spec(DOUBLE_INTEGRATOR_2D)
    x, u_ref, obs = _t(states(DOUBLE_INTEGRATOR_2D)), torch.zeros((B, 2)), _t(OBS)
    with pytest.raises(ValueError, match="backend"):
        cbf_qp.solve_batch(DOUBLE_INTEGRATOR_2D, ts, x, u_ref, obs, DT, backend="triton")
    with pytest.raises(TypeError, match="unexpected"):
        cbf_qp.solve_batch(DOUBLE_INTEGRATOR_2D, ts, x, u_ref, obs, DT, alpha=1.0)
    # a shared (K, 7) obstacle set broadcasts over the batch
    shared = cbf_qp.solve_batch(DOUBLE_INTEGRATOR_2D, ts, x, u_ref, obs, DT, iters=400)
    per = cbf_qp.solve_batch(DOUBLE_INTEGRATOR_2D, ts, x, u_ref, obs.expand(B, 5, 7), DT,
                             iters=400)
    assert torch.equal(shared.u, per.u)


def _dev(ours, gold):
    return float(np.max(np.abs(ours.numpy().astype(float) - gold)))


def test_golden_anchors_c1_and_c5():
    """BASELINE configs 1 and 5: the port's cbf_qp.solve against the float64
    SLSQP goldens, every anchor cold, as tests/test_parity_anchors.py."""
    spec = tspec.make_spec(DOUBLE_INTEGRATOR_2D)
    obs = pad_obstacles(DATA["c1_obs"], 5)
    r = cbf_qp.solve(DOUBLE_INTEGRATOR_2D, spec, _t(DATA["c1_x"]), _t(DATA["c1_uref"]), obs, DT)
    assert r.u.shape == (30, 2)
    assert _dev(r.u, DATA["c1_gold"]) < 1e-3

    spec = tspec.make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.7)
    obs = pad_obstacles(DATA["c5_obs"], 8)
    r = cbf_qp.solve(DYNAMIC_UNICYCLE_2D, spec, _t(DATA["c5_x"]), _t(DATA["c5_uref"]), obs, DT)
    assert r.u.shape == (20, 2)
    assert _dev(r.u, DATA["c5_gold"]) < 1e-3


def test_closed_loop_c1_first_60_steps():
    """float32 closed loop vs the float64 SLSQP-in-the-loop golden trajectory."""
    spec = tspec.make_spec(DOUBLE_INTEGRATOR_2D)
    model = get_model(DOUBLE_INTEGRATOR_2D)
    obs = pad_obstacles(DATA["c1_obs"], 5)
    goal = _t(DATA["cl1_goal"])[None]
    gold = DATA["cl1_traj"]
    x = _t(DATA["cl1_x0"])[None]
    dev = 0.0
    for k in range(60):
        u_ref = model.nominal_input(x, goal, spec)
        r = cbf_qp.solve(DOUBLE_INTEGRATOR_2D, spec, x, u_ref, obs, DT)
        assert bool(r.feasible[0])
        x = model.step(x, r.u, spec, DT)
        dev = max(dev, _dev(x[0, :2], gold[k + 1, :2]))
    assert dev < 5e-3, dev


MOVING = np.asarray(jpad(jnp.asarray([[2.0, 2.0, 0.5, -0.4, -0.1, 0, 0],
                                      [1.2, 2.8, 0.4, 0.2, -0.5, 0, 0]], jnp.float32), 5))
ARM_OBS = np.asarray(jpad(jnp.asarray([[1.6, 1.2, 0.3, 0, 0, 0, 0],
                                       [0.4, 1.9, 0.3, 0, 0, 0, 0],
                                       [-1.0, 1.5, 0.4, 0, 0, 0, 0]], jnp.float32), 5))


def new_model_case(name, seed=4):
    """States, nominal inputs and obstacles: robots near the obstacles and
    moving at them (the arm's links reach them), nominal inputs that push."""
    rng = np.random.default_rng(seed)
    if name == MANIPULATOR_2D:
        x = rng.uniform(0.2, 1.2, (B, 3))
        u = rng.uniform(-2.0, 2.0, (B, 3))
        return x, u, np.tile(ARM_OBS[None], (B, 1, 1))
    pos = rng.uniform(0.6, 1.4, (B, 2))
    if name == UNICYCLE_2D:
        x = np.concatenate([pos, rng.uniform(0.3, 1.2, (B, 1))], axis=1)
        u = np.stack([rng.uniform(0.3, 1.0, B), rng.uniform(-0.5, 0.5, B)], axis=1)
    elif name == QUAD_2D:
        x = np.concatenate([pos, rng.uniform(-0.2, 0.2, (B, 1)), rng.uniform(0.2, 0.8, (B, 2)),
                            np.zeros((B, 1))], axis=1)
        u = rng.uniform(4.0, 9.0, (B, 2))
    else:
        x = np.concatenate([pos, rng.uniform(0.3, 1.2, (B, 1)), rng.uniform(0.4, 1.5, (B, 1))],
                           axis=1)
        u = np.stack([rng.uniform(0.5, 2.0, B), rng.uniform(-0.3, 0.3, B)], axis=1)
    moving = name in (KINEMATIC_BICYCLE_2D_C3BF, KINEMATIC_BICYCLE_2D_DPCBF)
    return x, u, np.tile((MOVING if moving else OBS)[None], (B, 1, 1))


@pytest.mark.parametrize("name", [UNICYCLE_2D, KINEMATIC_BICYCLE_2D, KINEMATIC_BICYCLE_2D_C3BF,
                                  KINEMATIC_BICYCLE_2D_DPCBF, QUAD_2D, MANIPULATOR_2D])
def test_new_model_solve_batch_matches_jax(name):
    x, u_ref, obs = new_model_case(name)
    js, ts = make_spec(name), tspec.make_spec(name)
    want = [np.asarray(t) for t in jcbf.solve_batch(
        name, js, *(jnp.asarray(a, jnp.float32) for a in (x, u_ref, obs)), DT, backend="xla")]
    assert (np.abs(want[0] - u_ref) > 1e-2).any()  # a constraint binds
    for backend in ("xla", "pallas"):
        got = cbf_qp.solve_batch(name, ts, _t(x), _t(u_ref), _t(obs), DT, backend=backend)
        np.testing.assert_allclose(got.u.numpy(), want[0], atol=2e-3, err_msg=backend)
        np.testing.assert_array_equal(got.feasible.numpy(), want[1], err_msg=backend)
    with jax.enable_x64(True):
        want64 = [np.asarray(t) for t in jcbf.solve_batch(
            name, js, *(jnp.asarray(a, jnp.float64) for a in (x, u_ref, obs)), DT,
            backend="xla")]
    got64 = cbf_qp.solve_batch(name, ts, *(_t(a, torch.float64) for a in (x, u_ref, obs)), DT,
                               backend="xla")
    np.testing.assert_allclose(got64.u.numpy(), want64[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got64.feasible.numpy(), want64[1])
    finite = np.isfinite(want64[2])
    np.testing.assert_allclose(got64.h_min.numpy()[finite], want64[2][finite], atol=1e-6)
    if name == MANIPULATOR_2D:  # 5 obstacles x 23 link circles + the input box
        P, q, A, lo, hi = cbf_qp._assemble(get_model(name), name, ts, _t(x), _t(u_ref),
                                           _t(obs), DT, "cbf")[:5]
        assert A.shape == (B, 118, 3) and torch.equal(A[:, 69:115], torch.zeros_like(A[:, 69:115]))


@pytest.mark.gpu
def test_manipulator_cbf_qp_on_card_matches_plain_version(monkeypatch):
    """On a card: the Manipulator2D CBF-QP (n=3, m=118: 32 lanes a
    problem) through the QP kernel, one launch, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    dev = torch.device("cuda", 0)
    x, u_ref, obs = (_t(a).to(dev) for a in new_model_case(MANIPULATOR_2D))
    ts = tspec.make_spec(MANIPULATOR_2D)
    before = qpk.LAUNCH_COUNT
    kern = cbf_qp.solve_batch(MANIPULATOR_2D, ts, x, u_ref, obs, DT, backend="pallas")
    torch.cuda.synchronize()
    assert qpk.LAUNCH_COUNT == before + 1
    assert qpk.launch_shape(x.shape[0], 3, 118)[0] == 32
    monkeypatch.setattr(qpk, "solve_qp_batch", qpk.solve_qp_batch_reference)
    plain = cbf_qp.solve_batch(MANIPULATOR_2D, ts, x, u_ref, obs, DT, backend="pallas")
    assert (kern.u - plain.u).abs().max().item() < 2e-3
    assert torch.equal(kern.feasible, plain.feasible)
