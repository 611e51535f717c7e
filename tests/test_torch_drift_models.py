"""Port parity: DynamicBicycle2D (Fiala tyres) and DriftingCar.

Random float64 states and inputs from a numpy seed go through the JAX model
(vmapped) and the port (batched over the leading axis); ``f``, ``g``,
``step``, their ``jacfwd`` derivatives and the other model functions agree
to 1e-12 (relative to the magnitude: torques reach 1e4).  The Fiala force is
held on its linear branch, its saturated branch and at the switch, and the
state clamp's derivative at a tie (0.5 of the tangent, as ``jnp.clip``).

The fused MPC kernel's two new instantiations (``csrc/mpc_fused_models.h``)
are built with g++ under ``cuda_on_cpu``'s block emulation and IEEE math and
held bit for bit to ``solve_fused_batch_reference``, with unit cost weights:
neither model has MPC weights in either package.
"""

import ctypes
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_on_cpu
from safe_control_tpu.core.spec import DRIFTING_CAR, DYNAMIC_BICYCLE_2D, make_spec
from safe_control_tpu.dynamics import dynamic_bicycle2d as jdyn
from safe_control_tpu.dynamics import get_model as jget_model
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu.solvers import mpc_fused as jfused
from safe_control_tpu_torch import entry, interop
from safe_control_tpu_torch.dynamics import dynamic_bicycle2d as tdyn
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers import mpc_cbf
from safe_control_tpu_torch.solvers import mpc_fused as mf

torch.set_num_threads(1)

MODELS = [DYNAMIC_BICYCLE_2D, DRIFTING_CAR]
DT = 0.05
TOL = 1e-12
CSRC = Path(mf.__file__).resolve().parent.parent / "csrc"


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _inputs(name, B=256, seed=5):
    """Body states over the linear and the saturated tyre regimes: yaw rate
    to +-1.5, slip to +-0.6, speed 0-20 (below the V_safe guard too),
    steering to +-0.5, torque to +-4000; inputs to +-1 and +-9000."""
    rng = np.random.default_rng(seed)
    body = np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.6, 0.6, B),
                     rng.uniform(0.0, 20.0, B), rng.uniform(-0.5, 0.5, B),
                     rng.uniform(-4000, 4000, B)], axis=1)
    x = body if name == DYNAMIC_BICYCLE_2D else np.concatenate(
        [rng.uniform(-5, 5, (B, 2)), rng.uniform(-3, 3, (B, 1)), body], axis=1)
    u = np.stack([rng.uniform(-1, 1, B), rng.uniform(-9000, 9000, B)], axis=1)
    return x, u


def _pair(name, **overrides):
    js = make_spec(name, **overrides)
    return jget_model(name), get_model(name), js, interop.spec_from_jax(js, dtype=torch.float64)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("name", MODELS)
def test_f_g_step_match_jax(name):
    jm, tm, js, ts = _pair(name)
    x, u = _inputs(name)
    xj, uj = jnp.asarray(x), jnp.asarray(u)
    xt, ut = torch.tensor(x), torch.tensor(u)
    _close(jax.vmap(lambda z: jm.f(z, js))(xj), tm.f(xt, ts))
    _close(jax.vmap(lambda z: jm.g(z, js))(xj), tm.g(xt, ts))
    _close(jax.vmap(lambda z, v: jm.step(z, v, js, DT))(xj, uj), tm.step(xt, ut, ts, DT))
    # both regimes of the rear and front tyres occur in this sample
    body = x[:, -5:]
    a_f, a_r = tdyn.slip_angles(*(torch.tensor(body[:, i]) for i in range(4)), ts)
    Fz_f, Fz_r = tdyn.normal_forces(ts)
    sl_f = np.arctan(3.0 * np.sqrt(max((ts.mu * Fz_f) ** 2, 1.0)) / ts.cc_f)
    assert (a_f.abs().numpy() < sl_f).any() and (a_f.abs().numpy() > sl_f).any()
    assert (a_r.abs().numpy() > 0.3).any()


@pytest.mark.parametrize("name", MODELS)
def test_step_and_f_derivatives_match_jax(name):
    jm, tm, js, ts = _pair(name)
    x, u = _inputs(name, B=64, seed=6)
    xj, uj = jnp.asarray(x), jnp.asarray(u)
    xt, ut = torch.tensor(x), torch.tensor(u)
    jx, ju = jax.vmap(jax.jacfwd(lambda z, v: jm.step(z, v, js, DT), argnums=(0, 1)))(xj, uj)
    tx, tu = torch.func.vmap(torch.func.jacfwd(lambda z, v: tm.step(z, v, ts, DT),
                                               argnums=(0, 1)))(xt, ut)
    _close(jx, tx)
    _close(ju, tu)
    _close(jax.vmap(jax.jacfwd(lambda z: jm.f(z, js)))(xj),
           torch.func.vmap(torch.func.jacfwd(lambda z: tm.f(z, ts)))(xt))


@pytest.mark.parametrize("name", MODELS)
def test_policies_bounds_and_position_match_jax(name):
    jm, tm, js, ts = _pair(name)
    x, _ = _inputs(name, seed=7)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    goal = np.random.default_rng(8).uniform(-20, 20, (x.shape[0], 2))
    _close(jax.vmap(lambda z, gl: jm.nominal_input(z, gl, js))(xj, jnp.asarray(goal)),
           tm.nominal_input(xt, torch.tensor(goal), ts))
    _close(jax.vmap(lambda z: jm.stop(z, js))(xj), tm.stop(xt, ts))
    np.testing.assert_array_equal(jax.vmap(lambda z: jm.has_stopped(z, js))(xj),
                                  tm.has_stopped(xt, ts).numpy())
    _close(jax.vmap(lambda z: jm.rotate_to(z, 0.3, js))(xj), tm.rotate_to(xt, 0.3, ts))
    _close(jax.vmap(jm.barrier_pos)(xj), tm.barrier_pos(xt))
    for jb, tb in zip(jm.state_bounds(js), tm.state_bounds(ts, dtype=torch.float64)):
        np.testing.assert_array_equal(np.asarray(jb, float), tb.numpy())
    _close(jm.u_lb(js), tm.u_lb(ts, dtype=torch.float64))
    _close(jm.u_ub(js), tm.u_ub(ts, dtype=torch.float64))
    assert (tm.N_STATES, tm.N_CONTROLS, tm.REL_DEG) == (jm.N_STATES, jm.N_CONTROLS, jm.REL_DEG)


@pytest.mark.parametrize("where", ["linear", "saturated", "switch"])
@pytest.mark.parametrize("mu", [1.0, 0.3])
def test_fiala_force_branches_match_jax(where, mu):
    """The lateral force and its derivative in alpha on either branch and at
    the switch |alpha| = alpha_sl, front (no drive force) and rear (a drive
    force that shrinks the friction circle)."""
    js = make_spec(DYNAMIC_BICYCLE_2D, mu=mu)
    ts = interop.spec_from_jax(js, dtype=torch.float64)
    Fz_f, Fz_r = tdyn.normal_forces(ts)
    for Cc, Fz, Fx in ((ts.cc_f, Fz_f, 0.0), (ts.cc_r, Fz_r, 2500.0 * mu)):
        Fy_max = np.sqrt(max((mu * Fz) ** 2 - ts.gamma_stab * Fx**2, 1.0))
        a_sl = float(np.arctan((3.0 * Fy_max) * (1.0 / Cc)))
        alphas = {"linear": [0.3 * a_sl, -0.9 * a_sl, 0.0],
                  "saturated": [1.2 * a_sl, -0.6, 0.7],
                  "switch": [a_sl, -a_sl]}[where]
        for a in alphas:
            jf = lambda al: jdyn.lateral_force(al, Cc, Fz, jnp.asarray(Fx), js)
            fx = torch.tensor(Fx, dtype=torch.float64)
            tf = lambda al: tdyn.lateral_force(al, Cc, Fz, fx, ts)
            at = torch.tensor(a, dtype=torch.float64)
            np.testing.assert_allclose(float(tf(at)), float(jf(jnp.asarray(a))),
                                       rtol=TOL, atol=1e-9)
            d_t = float(torch.func.jacfwd(tf)(at))
            d_j = float(jax.jacfwd(jf)(jnp.asarray(a)))
            np.testing.assert_allclose(d_t, d_j, rtol=TOL, atol=1e-6)
            if where == "switch":  # the two branches meet with a flat slope
                assert abs(d_t) < 1e-3 * Cc


@pytest.mark.parametrize("name", MODELS)
def test_state_clamp_ties_take_half_the_tangent(name):
    """Steering at delta_max and torque at -tau_max with zero input rates
    land on the clamp's bounds exactly: derivative 0.5, as ``jnp.clip``."""
    jm, tm, js, ts = _pair(name)
    x, _ = _inputs(name, B=1, seed=9)
    x = x[0].copy()
    x[-2], x[-1] = ts.delta_max, -ts.tau_max
    u = np.zeros(2)
    jx = jax.jacfwd(lambda z: jm.step(z, jnp.asarray(u), js, DT))(jnp.asarray(x))
    tx = torch.func.jacfwd(lambda z: tm.step(z, torch.tensor(u), ts, DT))(torch.tensor(x))
    _close(jx, tx)
    assert float(tx[-2, -2]) == 0.5 and float(tx[-1, -1]) == 0.5


def test_drifting_car_drives_and_turns_in_float32():
    """Constant torque on a straight line, and the P law toward a goal up
    and to the left (as ``tests/test_drift_models.py``)."""
    m = get_model(DRIFTING_CAR)
    spec = interop.spec_from_jax(make_spec(DRIFTING_CAR))
    x = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 5.0, 0.0, 1000.0])
    for _ in range(100):
        x = m.step(x, torch.zeros(2), spec, 0.02)
    assert x[0] > 9.0 and abs(float(x[1])) < 0.1 and x[5] > 5.0
    x = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 5.0, 0.0, 0.0])
    goal = torch.tensor([10.0, 10.0])
    assert m.nominal_input(x, goal, spec)[0] > 0
    best = float("inf")
    for _ in range(250):
        x = m.step(x, m.nominal_input(x, goal, spec), spec, 0.02)
        best = min(best, float(torch.linalg.vector_norm(x[:2] - goal)))
    assert best < 2.0


def test_friction_acts_through_spec_mu_as_a_tensor():
    """The drift simulator's plant friction is a 0-d tensor: the step takes
    it and equals the step with the float."""
    m = get_model(DRIFTING_CAR)
    spec = interop.spec_from_jax(make_spec(DRIFTING_CAR), dtype=torch.float64)
    x, u = (torch.tensor(a) for a in _inputs(DRIFTING_CAR, B=16, seed=10))
    a = m.step(x, u, spec.replace(mu=0.3), DT)
    b = m.step(x, u, spec.replace(mu=torch.tensor(0.3, dtype=torch.float64)), DT)
    _close(a, b)


@pytest.mark.parametrize("name", MODELS)
def test_fused_available_and_ids(name):
    cfg = jmpc.MPCConfig(horizon=10, num_obs=5)
    assert mf.fused_available(name, interop.config_from_jax(cfg)) == \
        jfused.fused_available(name, cfg) is True
    assert mf.MODEL_IDS[name] == {DYNAMIC_BICYCLE_2D: 11, DRIFTING_CAR: 12}[name]
    with pytest.raises(KeyError):  # no MPC weights, in either package
        mpc_cbf.mpc_weights(name)
    with pytest.raises(KeyError):
        jmpc._WEIGHTS[name]


@pytest.fixture(scope="module")
def ieee_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    lib = cuda_on_cpu.build(CSRC / "mpc_fused_kernel.cu", tmp_path_factory.mktemp("drift_cpu"),
                            ieee_math=True)
    lib.mpc_fused_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mpc_fused_launch.restype = ctypes.c_int
    return lib


def unit_weights(monkeypatch, name):
    n = get_model(name).N_STATES
    monkeypatch.setitem(mpc_cbf._WEIGHTS, name, ([1.0] * n, [0.5, 0.5]))


@pytest.mark.parametrize("name", MODELS)
def test_cuda_source_with_ieee_math_is_bit_identical_to_plain_version(ieee_lib, monkeypatch,
                                                                      name):
    """B3's DynamicBicycle2D and DriftingCar instantiations at N=10 (M=20),
    the full 8x3 budget, eight problems of ``entry.build_fused_step``'s
    inputs: the fourth with its steering at delta_max (the clamp's tie),
    the last four with drive torques of -4000 to 4000 (tanh's tangent
    1 - r^2 near cancellation)."""
    cuda_on_cpu.ieee_math(monkeypatch)
    unit_weights(monkeypatch, name)
    spec = make_spec(name)
    spec = interop.spec_from_jax(spec)
    cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    args = list(entry.build_fused_step(8, model_name=name, horizon=10, device="cpu")[1])
    args[0] = args[0].clone()
    args[0][3, -2] = spec.delta_max
    args[0][4:, -1] = torch.tensor([-4000.0, -1500.0, 2500.0, 4000.0])
    pb = mf._problem(name, spec, cfg)
    B, N, n, m = 8, pb.N, pb.n, pb.m
    params = torch.tensor(mf.kernel_params(name, spec, DT, cfg), dtype=torch.float32)
    U0 = mf._warm_start(args[4]).reshape(B, N * m).contiguous()
    U = torch.full((B, N * m), float("nan"))
    xs = torch.full((B, (N + 1) * n), float("nan"))
    viol = torch.full((B,), float("nan"))
    err = ieee_lib.mpc_fused_launch(
        mf.MODEL_IDS[name], *(t.contiguous().data_ptr() for t in args[:4]), U0.data_ptr(),
        params.data_ptr(), U.data_ptr(), xs.data_ptr(), viol.data_ptr(), None, None, B,
        N, pb.K, len(pb.bounded), params.numel(), cfg.outer_iters, cfg.newton_iters, None)
    assert err == 0
    plain = mf.solve_fused_batch_reference(name, spec, *args, DT, cfg)
    assert torch.isfinite(plain.U).all() and (plain.U != args[4]).any()
    assert torch.equal(U.reshape(B, N, m), plain.U)
    assert torch.equal(xs.reshape(B, N + 1, n), plain.xs)
    assert torch.equal(viol, plain.viol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODELS)
def test_instantiation_matches_plain_version_on_card(cuda_device, monkeypatch, name):
    """On a card: one launch at B=64 against the plain version on the card,
    within the kernel envelope (max |du| < 5e-3, viol atol 1e-3)."""
    unit_weights(monkeypatch, name)
    cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    spec = interop.spec_from_jax(make_spec(name))
    ins = entry.build_fused_step(64, model_name=name, device=cuda_device)[1]
    plain = mf.solve_fused_batch_reference(name, spec, *ins, DT, cfg)
    before = mf.LAUNCH_COUNT
    kern = mf.solve_fused_batch(name, spec, *ins, DT, cfg)
    torch.cuda.synchronize()
    assert mf.LAUNCH_COUNT == before + 1
    assert torch.isfinite(kern.U).all()
    assert (kern.U - plain.U).abs().max().item() < 5e-3
    assert (kern.viol - plain.viol).abs().max().item() <= 1e-3
