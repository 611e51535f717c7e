"""The generic fused MPC kernel module: its plain PyTorch version, wrapper,
dispatch and sources.

On the CPU the wrapper ``solve_fused_batch`` runs
``solve_fused_batch_reference``, the plain PyTorch version of
``csrc/mpc_fused_kernel.cu``.  It is held against the JAX package at the
geometries and gates of the JAX kernel's own tests
(``tests/test_mpc_fused.py``), on the same numpy inputs:

- DynamicUnicycle2D N=4, 2x2 budget, B=4, against JAX
  ``mpc_fused.solve_fused_batch(interpret=True)``: u and xs within 2e-3,
  viol atol 1e-3 (float32; measured ~3e-8);
- Quad3D N=2, 1x1, against the same: 1e-5 (the JAX test's gate against the
  XLA solve);
- VTOL2D N=4, 1x2, against JAX's XLA ``mpc_cbf.solve`` (the interpret path
  is slow and runs Mosaic's atan2 polynomial): u and viol within 1e-2;
- in float64 at Quad3D N=10 with the full 8x3 budget, against JAX
  ``mpc_cbf.solve`` in float64: 1e-6.  A wrong tangent breaks this.

``solve_dispatch`` routes a supported configuration through
``solve_fused_batch`` and falls back, with one log record per reason, on
an unsupported one.  The CUDA kernel itself is checked by the ``gpu``-marked
test on a card and by ``chip_smoke.py``.
"""

import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DYNAMIC_UNICYCLE_2D,
    QUAD_3D,
    VTOL_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu.solvers import mpc_fused as jfused
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers import mpc_cbf as tmpc
from safe_control_tpu_torch.solvers import mpc_fused as tfused

torch.set_num_threads(1)

DT = 0.05
CSRC = Path(tfused.__file__).resolve().parent.parent / "csrc"


def du_problems():
    """The JAX DU parity batch: B=4, a circle and a superellipsoid row."""
    B = 4
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.uniform(0, 3, (B, 2)), rng.uniform(-1, 1, (B, 1)),
                         rng.uniform(0, 0.8, (B, 1))], axis=1)
    goals = np.tile(np.array([5.0, 1.0, 0, 0]), (B, 1))
    obs1 = np.asarray(pad_obstacles(jnp.asarray(
        [[2.5, 0.8, 0.4, 0, 0, 0, 0], [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], jnp.float32), 5))
    obs = np.tile(obs1[None], (B, 1, 1))
    return [a.astype(np.float32) for a in
            (xs, goals, obs, np.zeros((B, 2)), np.zeros((B, 4, 2)))]


def quad3d_problem(N, B=1, seed=None):
    """The JAX Quad3D anchor (hover at z=5, goal (6, 2, 5), circle (3, 1, 0.5));
    with a seed, B starts spread over x, y in [0, 3] and z in [4.5, 5.5]."""
    x0 = np.zeros((B, 12))
    x0[:, 2] = 5.0
    if seed is not None:
        rng = np.random.default_rng(seed)
        x0[:, :2] = rng.uniform(0, 3, (B, 2))
        x0[:, 2] = rng.uniform(4.5, 5.5, B)
    goal = np.zeros((B, 12))
    goal[:, :3] = [6.0, 2.0, 5.0]
    obs = np.tile(np.asarray(pad_obstacles(jnp.asarray([[3.0, 1.0, 0.5, 0, 0, 0, 0]],
                                                       jnp.float32), 5))[None], (B, 1, 1))
    return [x0, goal, obs, np.zeros((B, 4)), np.zeros((B, N, 4))]


def torch_fused(name, inputs, cfg, dtype=torch.float32, fn=tfused.solve_fused_batch):
    spec = interop.spec_from_jax(make_spec(name))
    if name == DYNAMIC_UNICYCLE_2D:
        spec = interop.spec_from_jax(make_spec(name, a_max=1.0, w_max=0.5))
    return fn(name, spec, *(torch.as_tensor(np.array(a), dtype=dtype) for a in inputs), DT,
              interop.config_from_jax(cfg))


def jax_solve(name, spec, inputs, cfg, dtype):
    n_con = jmpc._num_constraints(jmpc.get_model(name), cfg)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(name, spec, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((n_con,), dtype)), DT, cfg)
        return r.u, r.viol, r.xs

    with jax.enable_x64(dtype == jnp.float64):
        args = [jnp.asarray(a, dtype) for a in inputs]
        return [np.asarray(a) for a in jax.jit(jax.vmap(one))(*args)]


def test_reference_matches_jax_fused_kernel_du():
    cfg = jmpc.MPCConfig(horizon=4, num_obs=5, outer_iters=2, newton_iters=2)
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    inputs = du_problems()
    want = jfused.solve_fused_batch(DYNAMIC_UNICYCLE_2D, spec, *(jnp.asarray(a) for a in inputs),
                                    DT, cfg, interpret=True)
    before = tfused.LAUNCH_COUNT
    got = torch_fused(DYNAMIC_UNICYCLE_2D, inputs, cfg)  # CPU: the plain version
    assert tfused.LAUNCH_COUNT == before
    assert got.u.shape == (4, 2) and got.U.shape == (4, 4, 2) and got.xs.shape == (4, 5, 4)
    assert np.abs(got.u.numpy() - np.asarray(want.u)).max() < 2e-3
    assert np.abs(got.xs.numpy() - np.asarray(want.xs)).max() < 2e-3
    np.testing.assert_allclose(got.viol.numpy(), np.asarray(want.viol), atol=1e-3)
    assert (got.viol > 0.1).any()  # one start violates the superellipsoid row


def test_reference_matches_jax_fused_kernel_quad3d():
    cfg = jmpc.MPCConfig(horizon=2, num_obs=5, outer_iters=1, newton_iters=1)
    inputs = [a.astype(np.float32) for a in quad3d_problem(2)]
    want = jfused.solve_fused_batch(QUAD_3D, make_spec(QUAD_3D), *(jnp.asarray(a) for a in inputs),
                                    DT, cfg, interpret=True)
    got = torch_fused(QUAD_3D, inputs, cfg)
    assert np.abs(got.u.numpy() - np.asarray(want.u)).max() < 1e-5
    assert np.abs(got.xs.numpy() - np.asarray(want.xs)).max() < 1e-5
    np.testing.assert_allclose(got.viol.numpy(), np.asarray(want.viol), atol=1e-5)


def test_reference_matches_jax_solve_vtol2d():
    """Full aero f/g, the r=2 circle barrier and the pitch / vx / vz bound rows
    (vz's upper side infinite: clamped to 1e6); the constraint-stressed JAX
    anchor."""
    cfg = jmpc.MPCConfig(horizon=4, num_obs=5, outer_iters=1, newton_iters=2)
    inputs = [np.asarray([[8.0, 38.0, 0.05, 12.0, 0.5, 0.0]], np.float32),
              np.asarray([[80.0, 40.0, 0, 0, 0, 0]], np.float32),
              np.asarray(pad_obstacles(jnp.asarray([[40.0, 35.0, 3.0, 0, 0, 0, 0]],
                                                   jnp.float32), 5))[None],
              np.zeros((1, 4), np.float32), np.zeros((1, 4, 4), np.float32)]
    u_ref, viol_ref, xs_ref = jax_solve(VTOL_2D, make_spec(VTOL_2D), inputs, cfg, jnp.float32)
    got = torch_fused(VTOL_2D, inputs, cfg)
    assert np.abs(got.u.numpy() - u_ref).max() < 1e-2
    np.testing.assert_allclose(got.viol.numpy(), viol_ref, atol=1e-2)
    assert np.isfinite(got.xs.numpy()).all() and got.xs.shape == xs_ref.shape


def test_reference_f64_matches_jax_solve_f64_quad3d_n10():
    """Quad3D N=10, the full 8x3 budget, four spread starts, float64."""
    cfg = jmpc.MPCConfig(horizon=10, num_obs=5)
    inputs = quad3d_problem(10, B=4, seed=0)
    u_ref, viol_ref, xs_ref = jax_solve(QUAD_3D, make_spec(QUAD_3D), inputs, cfg, jnp.float64)
    got = torch_fused(QUAD_3D, inputs, cfg, dtype=torch.float64,
                      fn=tfused.solve_fused_batch_reference)
    assert np.abs(got.u.numpy() - u_ref).max() <= 1e-6
    assert np.abs(got.viol.numpy() - viol_ref).max() <= 1e-6
    assert np.abs(got.xs.numpy() - xs_ref).max() <= 1e-6


def _jax_cfg(**kw):
    return jmpc.MPCConfig(num_obs=5, use_fused_kernel=True, **kw)


@pytest.mark.parametrize("model_name,cfg", [
    (QUAD_3D, _jax_cfg(horizon=10)),
    (QUAD_3D, _jax_cfg(horizon=16)),  # M = 64, the widest admitted
    (QUAD_3D, _jax_cfg(horizon=17)),  # M = 68
    (VTOL_2D, _jax_cfg(horizon=30)),  # M = 120, the open question
    (DYNAMIC_UNICYCLE_2D, _jax_cfg(horizon=8, optimal_decay=True)),
    (DYNAMIC_UNICYCLE_2D, _jax_cfg(horizon=8, polish_iters=2)),
    (DYNAMIC_UNICYCLE_2D, _jax_cfg(horizon=8, newton_f64=True)),
    ("SingleIntegrator2D", _jax_cfg(horizon=32)),
    ("DoubleIntegrator2D", _jax_cfg(horizon=33)),
])
def test_fused_available_agrees_with_jax(model_name, cfg):
    assert tfused.fused_available(model_name, interop.config_from_jax(cfg)) == \
        jfused.fused_available(model_name, cfg)


def test_fused_available_needs_a_cuda_instantiation():
    cfg = tmpc.MPCConfig(horizon=4)
    assert not tfused.fused_available("Unicycle2D", cfg)  # JAX admits it; not ported
    assert set(tfused.MODEL_IDS) == set(tmpc.MODEL_REGISTRY)


def _quad_inputs(B=2, N=3):
    return [torch.as_tensor(a, dtype=torch.float32) for a in quad3d_problem(N, B=B, seed=1)]


def test_solve_dispatch_routes_to_the_fused_solve():
    cfg = tmpc.MPCConfig(horizon=3, num_obs=5, outer_iters=2, newton_iters=1,
                         use_fused_kernel=True)
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    xs, goals, obs, ups, Uw = _quad_inputs()
    st = tmpc.init_state(QUAD_3D, cfg, 2)._replace(U=Uw)
    before = tfused.DISPATCH_COUNT
    res = tmpc.solve_dispatch(QUAD_3D, spec, xs, goals, obs, ups, st, DT, cfg)
    assert tfused.DISPATCH_COUNT == before + 1
    want = tfused.solve_fused_batch_reference(QUAD_3D, spec, xs, goals, obs, ups, Uw, DT, cfg)
    assert torch.equal(res.u, want.u) and torch.equal(res.state.U, want.U)
    assert torch.equal(res.xs, want.xs) and torch.equal(res.viol, want.viol)
    assert torch.equal(res.state.lam, torch.zeros_like(st.lam))
    assert torch.equal(res.feasible, res.viol <= cfg.viol_tol)
    # without the flag: the general solve, within float32 noise of the kernel's algorithm
    gen = tmpc.solve_dispatch(QUAD_3D, spec, xs, goals, obs, ups, st, DT,
                              cfg._replace(use_fused_kernel=False))
    assert tfused.DISPATCH_COUNT == before + 1
    assert (gen.u - res.u).abs().max().item() < 1e-5


def test_solve_dispatch_falls_back_with_one_log_record(caplog):
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    xs, goals, obs, ups, _ = _quad_inputs(N=17)
    wide = tmpc.MPCConfig(horizon=17, num_obs=5, outer_iters=1, newton_iters=1,
                          use_fused_kernel=True)  # M = 68 > 64
    st = tmpc.init_state(QUAD_3D, wide, 2)
    tmpc._FUSED_FALLBACK_SEEN.clear()
    before = tfused.DISPATCH_COUNT
    with caplog.at_level(logging.WARNING, logger="safe_control_tpu_torch.solvers"):
        res = tmpc.solve_dispatch(QUAD_3D, spec, xs, goals, obs, ups, st, DT, wide)
        again = tmpc.solve_dispatch(QUAD_3D, spec, xs, goals, obs, ups, st, DT, wide)
    assert tfused.DISPATCH_COUNT == before
    records = [r for r in caplog.records if "fell back" in r.getMessage()]
    assert len(records) == 1 and "M=17*m" in records[0].getMessage()
    want = tmpc.solve(QUAD_3D, spec, xs, goals, obs, ups, st, DT, wide)
    assert torch.equal(res.u, want.u) and torch.equal(again.u, want.u)

    # optimal decay falls back too, to the general solve, which does not take it yet
    caplog.clear()
    decay = tmpc.MPCConfig(horizon=8, num_obs=5, optimal_decay=True, use_fused_kernel=True)
    du = interop.spec_from_jax(make_spec(DYNAMIC_UNICYCLE_2D))
    B = 2
    st = tmpc.MPCState(U=torch.zeros(B, 8, 2), lam=torch.zeros(B, 56))
    with caplog.at_level(logging.WARNING, logger="safe_control_tpu_torch.solvers"):
        with pytest.raises(NotImplementedError):
            tmpc.solve_dispatch(DYNAMIC_UNICYCLE_2D, du, torch.zeros(B, 4), torch.zeros(B, 4),
                                torch.zeros(B, 5, 7), torch.zeros(B, 2), st, DT, decay)
    records = [r for r in caplog.records if "fell back" in r.getMessage()]
    assert len(records) == 1 and "optimal_decay=True" in records[0].getMessage()
    assert tfused.DISPATCH_COUNT == before


def test_solve_fused_single_contract():
    cfg = tmpc.MPCConfig(horizon=3, num_obs=5, outer_iters=2, newton_iters=1)
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    xs, goals, obs, ups, Uw = _quad_inputs(B=1)
    st = tmpc.MPCState(U=Uw[0], lam=torch.ones(tmpc._num_constraints(get_model(QUAD_3D), cfg)))
    one = tfused.solve_fused_single(QUAD_3D, spec, xs[0], goals[0], obs[0], ups[0], st, DT, cfg)
    batch = tfused.solve_fused_batch(QUAD_3D, spec, xs, goals, obs, ups, Uw, DT, cfg)
    assert one.u.shape == (4,) and one.state.U.shape == (3, 4) and one.xs.shape == (4, 12)
    assert torch.equal(one.u, batch.u[0]) and torch.equal(one.xs, batch.xs[0])
    assert torch.equal(one.state.lam, torch.zeros_like(st.lam))
    assert bool(one.feasible) == bool(batch.viol[0] <= cfg.viol_tol)


def test_wrapper_rejects_bad_inputs():
    cfg = tmpc.MPCConfig(horizon=3, num_obs=5)
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    good = _quad_inputs()
    with pytest.raises(ValueError, match="shape"):
        tfused.solve_fused_batch(QUAD_3D, spec, *good[:4], good[4][:, :2], DT, cfg)
    with pytest.raises(ValueError, match="shape"):
        tfused.solve_fused_batch(QUAD_3D, spec, good[0], good[1][:1], *good[2:], DT, cfg)
    mixed = list(good)
    mixed[3] = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tfused.solve_fused_batch(QUAD_3D, spec, *mixed, DT, cfg)
    with pytest.raises(ValueError, match="does not take"):
        tfused.solve_fused_batch(QUAD_3D, spec, *good, DT, cfg._replace(optimal_decay=True))
    batched = spec.replace(radius=torch.tensor([0.2, 0.3]))
    with pytest.raises(ValueError, match="per-robot"):
        tfused.solve_fused_batch(QUAD_3D, batched, *good, DT, cfg)


def test_cuda_source_matches_module():
    """The entry point's model ids, the parameter block's fixed head and each
    model's constant count agree between the CUDA source and the module."""
    kernel = (CSRC / "mpc_fused_kernel.cu").read_text()
    models = (CSRC / "mpc_fused_models.h").read_text()
    cases = dict((name, int(i)) for i, name in re.findall(r"MPC_FUSED_CASE\((\d+), (\w+)\)",
                                                           kernel))
    assert cases == tfused.MODEL_IDS
    assert int(re.search(r"constexpr int COMMON = (\d+);", kernel).group(1)) == 9
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    for name in tfused.MODEL_IDS:
        m = get_model(name)
        cfg = tmpc.MPCConfig(horizon=4)
        pb = tfused._problem(name, spec, cfg)
        params = tfused.kernel_params(name, spec, DT, cfg)
        assert len(params) == 9 + m.N_STATES + 3 * m.N_CONTROLS + 3 * len(pb.bounded) + \
            len(tfused._model_params(name, spec, DT))
        sizes = re.search(rf"struct {name} {{\s*static constexpr int n = (\d+), m = (\d+), "
                          rf"REL_DEG = (\d+);", models)
        assert tuple(int(v) for v in sizes.groups()) == (m.N_STATES, m.N_CONTROLS, m.REL_DEG)
    # VTOL2D's constants in the order the header's comment lists them
    vt = interop.spec_from_jax(make_spec(VTOL_2D))
    mp = tfused._model_params(VTOL_2D, vt, DT)
    assert len(mp) == 26 and mp[2] == -vt.m_blend and mp[20] == vt.mass * 9.81
    assert mp[24] == vt.ell_f * vt.k_front / vt.inertia


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch):
    """On a card: the kernel against its plain version on the same inputs, and
    the CUDA path never runs the plain version."""
    cfg = tmpc.MPCConfig(horizon=10, num_obs=5)
    spec = interop.spec_from_jax(make_spec(QUAD_3D))
    ins = [t.to(cuda_device) for t in _quad_inputs(B=64, N=10)]
    plain = tfused.solve_fused_batch_reference(QUAD_3D, spec, *ins, DT, cfg)
    before = tfused.LAUNCH_COUNT

    def refuse(*a, **k):
        raise AssertionError("the CUDA path ran the plain version")

    monkeypatch.setattr(tfused, "solve_fused_batch_reference", refuse)
    kern = tfused.solve_fused_batch(QUAD_3D, spec, *ins, DT, cfg)
    torch.cuda.synchronize()
    assert tfused.LAUNCH_COUNT == before + 1
    assert (kern.U - plain.U).abs().max().item() < 5e-3
    assert (kern.xs - plain.xs).abs().max().item() < 5e-3
    assert (kern.viol - plain.viol).abs().max().item() <= 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)
