"""The port's main paths against the JAX ones, and ``chip_smoke.py`` without a card.

``entry.build_step(batch=8, device="cpu")`` against
``__graft_entry__._build_step(batch=8)``: identical input arrays, then three
chained control steps, each side fed the same inputs (the JAX step's
outputs) at every step; u, U and x_next must agree to 5e-3, the float32
kernel-class envelope.  On the CPU the port's step runs the fused kernel's
plain PyTorch version through ``mpc_cbf.solve_batch``.

``entry.build_fused_step(4, device="cpu")`` (Quad3D, N=10, the full
budget, through ``mpc_cbf.solve_dispatch`` and on the CPU the fused
kernel's plain version) against the same step composed from JAX functions
(vmapped ``mpc_cbf.solve`` and ``model.step``) on the same numpy inputs:
three chained steps, each side fed the JAX step's outputs, u, U and x_next
within 5e-3.  With DynamicUnicycle2D N=8 it takes ``build_step``'s inputs.

``entry.build_cbf_qp_step(16, device="cpu")`` against the same CBF-QP step
composed from JAX functions (vmapped ``nominal_input``,
``cbf_qp.solve_batch``, vmapped ``step``) on the same numpy inputs: three
chained steps, u and x_next within 2e-3 (the JAX package's pallas-vs-xla
envelope) and equal ``feasible`` flags, through the general path and the
QP kernel's plain version.
"""

import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_step
from safe_control_tpu.core.spec import DOUBLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D, QUAD_3D, make_spec
from safe_control_tpu.core.types import pad_obstacles as jpad
from safe_control_tpu.dynamics import get_model as jget_model
from safe_control_tpu.solvers import cbf_qp as jcbf
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu_torch import entry
from safe_control_tpu_torch.solvers import mpc_du_kernel as duk
from safe_control_tpu_torch.solvers import mpc_fused
from safe_control_tpu_torch.solvers import qp_kernel as qpk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_build_step_matches_jax_build_step(use_fused_kernel):
    jstep, jargs = _build_step(batch=8)
    tstep, targs = entry.build_step(8, device="cpu", use_fused_kernel=use_fused_kernel)
    jargs = [np.asarray(a) for a in jargs]
    for got, want in zip(targs, jargs):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    jfn = jax.jit(jstep)
    xs, goals, obs, u_prevs, Us = jargs
    before = duk.LAUNCH_COUNT
    for _ in range(3):
        want = [np.asarray(a) for a in jfn(xs, goals, obs, u_prevs, Us)]
        got = tstep(*(torch.tensor(a) for a in (xs, goals, obs, u_prevs, Us)))
        for name, g, w in zip(("x_next", "u", "U"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-3, err_msg=name)
        xs, u_prevs, Us = want
    assert duk.LAUNCH_COUNT == before  # no kernel launch on the CPU


def _jax_fused_step_quad3d():
    """``build_fused_step``'s Quad3D step composed from the JAX package's
    functions (the general XLA solve: the Pallas kernel's interpreter is far
    too slow at N=10 with the full budget)."""
    spec = make_spec(QUAD_3D)
    model = jget_model(QUAD_3D)
    cfg = jmpc.MPCConfig(horizon=10, num_obs=5)
    n_con = jmpc._num_constraints(model, cfg)

    @jax.jit
    def step(xs, goals, obs, u_prevs, Us):
        def one(x, goal, ob, up, U):
            st = jmpc.MPCState(U=U, lam=jax.numpy.zeros((n_con,), x.dtype))
            res = jmpc.solve_dispatch(QUAD_3D, spec, x, goal, ob, up, st, entry.DT, cfg)
            return model.step(x, res.u, spec, entry.DT), res.u, res.state.U

        return jax.vmap(one)(xs, goals, obs, u_prevs, Us)

    return step


def test_build_fused_step_matches_jax_composition():
    B = 4
    tstep, targs = entry.build_fused_step(B, device="cpu")
    rng = np.random.default_rng(0)
    want_xs = np.zeros((B, 12))
    want_xs[:, :2] = rng.uniform(0, 3, (B, 2))
    want_xs[:, 2] = rng.uniform(4.5, 5.5, B)
    np.testing.assert_array_equal(targs[0].numpy(), want_xs.astype(np.float32))
    np.testing.assert_array_equal(targs[1].numpy(), np.tile([6.0, 2.0, 5.0] + [0.0] * 9, (B, 1)))
    want_obs = np.asarray(jpad(jax.numpy.asarray([[3.0, 1.0, 0.5, 0, 0, 0, 0]],
                                                 jax.numpy.float32), 5))
    np.testing.assert_array_equal(targs[2].numpy(), np.tile(want_obs[None], (B, 1, 1)))
    assert targs[3].shape == (B, 4) and targs[4].shape == (B, 10, 4)

    jstep = _jax_fused_step_quad3d()
    xs, goals, obs, u_prevs, Us = (t.numpy() for t in targs)
    before = (mpc_fused.DISPATCH_COUNT, mpc_fused.LAUNCH_COUNT)
    for _ in range(3):
        want = [np.asarray(a) for a in jstep(xs, goals, obs, u_prevs, Us)]
        got = tstep(*(torch.tensor(a) for a in (xs, goals, obs, u_prevs, Us)))
        for name, g, w in zip(("x_next", "u", "U"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-3, err_msg=name)
        xs, u_prevs, Us = want
    # three fused solves, none of them a kernel launch on the CPU
    assert (mpc_fused.DISPATCH_COUNT, mpc_fused.LAUNCH_COUNT) == (before[0] + 3, before[1])


def test_build_fused_step_du_takes_build_step_inputs():
    _, fused_args = entry.build_fused_step(8, model_name=DYNAMIC_UNICYCLE_2D, horizon=8,
                                           device="cpu")
    _, du_args = entry.build_step(8, device="cpu")
    for a, b in zip(fused_args, du_args):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="inputs"):
        entry.build_fused_step(2, model_name="VTOL2D", device="cpu")


def _jax_cbf_qp_step():
    """The CBF-QP step composed from the JAX package's functions."""
    spec = make_spec(DOUBLE_INTEGRATOR_2D)
    model = jget_model(DOUBLE_INTEGRATOR_2D)

    @jax.jit
    def step(xs, goals, obs):
        u_ref = jax.vmap(lambda x, g: model.nominal_input(x, g, spec))(xs, goals)
        r = jcbf.solve_batch(DOUBLE_INTEGRATOR_2D, spec, xs, u_ref, obs, entry.DT, backend="xla")
        x_next = jax.vmap(lambda x, u: model.step(x, u, spec, entry.DT))(xs, r.u)
        return x_next, r.u, r.feasible, r.h_min

    return step


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_build_cbf_qp_step_matches_jax_composition(backend):
    B = 16
    tstep, (xs, goals, obs) = entry.build_cbf_qp_step(B, device="cpu", backend=backend)
    rng = np.random.default_rng(0)
    want_xs = np.concatenate([rng.uniform(0, 4, (B, 2)), rng.uniform(-0.5, 0.5, (B, 2))], axis=1)
    np.testing.assert_array_equal(xs.numpy(), want_xs.astype(np.float32))
    np.testing.assert_array_equal(goals.numpy(), np.tile([5.0, 5.0, 0.0, 0.0], (B, 1)))
    want_obs = np.asarray(jpad(jax.numpy.asarray(entry.CBF_QP_OBSTACLES, jax.numpy.float32), 5))
    np.testing.assert_array_equal(obs.numpy(), np.tile(want_obs[None], (B, 1, 1)))
    assert obs.shape == (B, 5, 7)  # n=2 variables, m=7 rows: 5 CBF rows and 2 box rows

    jstep = _jax_cbf_qp_step()
    x = xs.numpy()
    before = qpk.LAUNCH_COUNT
    for _ in range(3):
        want = [np.asarray(a) for a in jstep(x, goals.numpy(), obs.numpy())]
        got = tstep(torch.tensor(x), goals, obs)
        for name, g, w in zip(("x_next", "u", "feasible", "h_min"), got, want):
            assert g.shape == w.shape, name
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=2e-3)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=2e-3)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_allclose(got[3].numpy(), want[3], rtol=0, atol=2e-3)
        x = want[0]
    assert qpk.LAUNCH_COUNT == before  # no kernel launch on the CPU


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", ["build_step", "build_fused_step", "build_cbf_qp_step"])
def test_entry_points_run_on_the_card_by_default(name):
    """A caller who names no device gets the card; the CPU is asked for."""
    param = inspect.signature(getattr(entry, name)).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default == "cuda"
