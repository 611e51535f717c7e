"""Port parity: the tracking loop (``sim/tracking.py``), batched over robots.

The port's ``tracking.step`` on a batch of B=8 robots against
``jax.jit(jax.vmap(step))`` of the JAX package's, from the same states (the
JAX ``init_state`` read across with ``interop.tracker_state_from_numpy``):

- ``select_obstacles`` on inputs built with ties (dummy rows, duplicated
  obstacles, passed obstacles whose 0.5e6 penalty rounds them equal):
  the same selection in the same order;
- one ``step`` for ``cbf_qp`` (DoubleIntegrator2D, DynamicUnicycle2D, and
  SingleIntegrator2D with each attitude controller, sensing on),
  ``optimal_decay_cbf_qp``, and ``mpc_cbf`` with and without
  ``use_fused_kernel`` (DynamicUnicycle2D, Quad3D, VTOL2D): ``u`` within
  2e-3 (CBF-QP) or 5e-3 (MPC, float32), 1e-6 in float64; ``ret``, ``mode``,
  ``goal_idx`` and ``feasible`` equal, the footprint and obstacle memory
  equal, the yaw within the same tolerance as ``u``.  On the CPU the port's
  CBF-QP runs the general ``qp.solve_qp``, as the JAX package's
  ``cbf_qp.solve`` does; the fused MPC runs its plain version, and the JAX
  side runs its general solve, the plain reference of its fused kernel.
  The MPC configurations are cut to a short horizon and a small iteration
  budget to keep the test short; the full budget is held by
  ``tests/test_torch_mpc_*.py``;
- a 40-step prefix of the DoubleIntegrator2D CBF-QP scenario of
  ``tests/test_tracking_e2e.py`` against JAX's ``run``: the same return
  codes, states within 2e-3;
- the freeze of terminal robots inside a mixed batch;
- ``init_state`` against JAX's, ``TrackerConfig``'s validation errors
  (``tests/test_controller_dispatch.py``), and the drift models' initial
  state (ported since A.6.2; the test keeps its earlier name);
- the dynamic-obstacle scenario of ``tests/test_dynamic_env_e2e.py``
  (KinematicBicycle2D with the DPCBF or C3BF barrier through the CBF-QP,
  8 moving obstacles): two steps of ``run_dynamic`` at B=8 against
  ``jax.vmap`` of JAX's, u and x within 2e-3, the same codes, the same
  obstacles; and one ``optimal_decay_mpc_cbf`` step (DynamicUnicycle2D,
  N=4, the cut budget) within 5e-3, its warm start of width m + 2 too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    KINEMATIC_BICYCLE_2D_C3BF,
    KINEMATIC_BICYCLE_2D_DPCBF,
    QUAD_3D,
    SINGLE_INTEGRATOR_2D,
    VTOL_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles as jpad
from safe_control_tpu.perception.grid import GridSpec
from safe_control_tpu.sim import tracking as jt
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.sim import tracking as tt
from safe_control_tpu_torch.solvers import mpc_cbf as tmpc
from safe_control_tpu_torch.solvers import mpc_fused as tfused

torch.set_num_threads(1)

B = 8
# The scenario of tests/test_tracking_e2e.py.
WAYPOINTS = np.array([[2, 2, np.pi / 2], [2, 12, 0], [12, 12, 0], [12, 2, 0]], dtype=float)
KNOWN_OBS = np.array([
    [2.2, 5.0, 0.2], [3.0, 5.0, 0.2], [4.0, 9.0, 0.3], [1.5, 10.0, 0.5], [9.0, 11.0, 1.0],
    [7.0, 7.0, 3.0], [4.0, 3.5, 1.5], [10.0, 7.3, 0.4], [6.0, 13.0, 0.7], [5.0, 10.0, 0.6],
    [11.0, 5.0, 0.8], [13.5, 11.0, 0.6], [2.0, 7.0, 0.7], [2.0, 8.0, 0.5],
])
KNOWN = np.asarray(jpad(jnp.asarray(KNOWN_OBS), 16))
UNKNOWN = np.asarray(jpad(jnp.asarray([[3.0, 6.2, 0.4, 0, 0, 0, 0],
                                       [1.2, 3.4, 0.5, 0.3, 4.0, 0.3, 1.0],
                                       [4.4, 2.1, 0.3, 0, 0, 0, 0]], jnp.float32), 4))
GRID = GridSpec(width=20.0, height=20.0, resolution=0.1)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def starts(name, seed=0):
    """B states around the scenario's start, headings and speeds spread."""
    rng = np.random.default_rng(seed)
    pos = np.array([2.0, 2.0]) + rng.uniform(-0.6, 0.6, (B, 2))
    if name == SINGLE_INTEGRATOR_2D:
        return pos
    if name == DOUBLE_INTEGRATOR_2D:
        return np.concatenate([pos, rng.uniform(-0.4, 0.4, (B, 2))], axis=1)
    if name == DYNAMIC_UNICYCLE_2D:
        return np.concatenate([pos, rng.uniform(-np.pi, np.pi, (B, 1)),
                               rng.uniform(0.0, 0.6, (B, 1))], axis=1)
    if name == QUAD_3D:
        x = np.zeros((B, 12))
        x[:, :2] = pos
        x[:, 2] = rng.uniform(4.5, 5.5, B)
        x[:, 6:8] = rng.uniform(-0.3, 0.3, (B, 2))
        return x
    x = np.zeros((B, 6))  # VTOL2D cruising toward the first waypoint
    x[:, 0] = rng.uniform(0.0, 3.0, B)
    x[:, 1] = rng.uniform(8.0, 10.0, B)
    x[:, 3] = rng.uniform(9.0, 11.0, B)
    return x


def make_case(name, pos_controller="cbf_qp", att="velocity_tracking_yaw", sensing=False,
              mpc=None, seed=0, **cfg_kw):
    spec = make_spec(name, v_max=1.0, a_max=1.5, radius=0.25) if name in (
        DOUBLE_INTEGRATOR_2D, SINGLE_INTEGRATOR_2D) else make_spec(name)
    if name == DYNAMIC_UNICYCLE_2D:
        spec = make_spec(name, w_max=0.5, a_max=1.0, radius=0.25)
    cfg = jt.TrackerConfig(model_name=name, pos_controller=pos_controller, att_controller=att,
                           use_sensor=sensing, grid=GRID if (sensing or att in (
                               "visibility_area", "visibility_raycast", "gatekeeper")) else None,
                           mpc=mpc or jmpc.MPCConfig(), **cfg_kw)
    wps = WAYPOINTS.copy()
    if name == VTOL_2D:
        wps = np.array([[20.0, 10.0, 0], [40.0, 12.0, 0]])
    return cfg, spec, starts(name, seed), wps


def jax_init(cfg, spec, x0, wps, dtype=jnp.float32):
    yaw0 = np.linspace(-3.0, 3.0, B)
    return jax.vmap(lambda x, y: jt.init_state(cfg, spec, x, y, first_goal=wps[1][:2],
                                               dtype=dtype))(
        jnp.asarray(x0, dtype), jnp.asarray(yaw0, dtype))


def jax_stepper(cfg, spec, wps, known, unknown=None):
    """``jax.jit(jax.vmap(step))`` with the inputs other than the state bound."""
    n = len(wps)
    return jax.jit(jax.vmap(lambda s: jt.step(cfg, spec, s, jnp.asarray(wps, jnp.float32),
                                             jnp.asarray(n), jnp.asarray(known),
                                             None if unknown is None else jnp.asarray(unknown))))


def torch_step(cfg, spec, st, wps, known, unknown=None, dtype=torch.float32):
    return tt.step(interop.tracker_config_from_jax(cfg), interop.spec_from_jax(spec),
                   interop.tracker_state_from_numpy(st, dtype=dtype), _t(wps), len(wps),
                   _t(known, dtype), None if unknown is None else _t(unknown, dtype))


def assert_step_matches(got, want, u_tol):
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=u_tol)
    for name in ("ret", "feasible"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    for name in ("mode", "goal_idx", "footprint"):
        assert np.array_equal(getattr(got.state, name).numpy(),
                              np.asarray(getattr(want.state, name))), name
    assert np.array_equal(got.state.mem.valid.numpy(), np.asarray(want.state.mem.valid))
    np.testing.assert_allclose(got.state.mem.slots.numpy(), np.asarray(want.state.mem.slots),
                               atol=1e-5)
    np.testing.assert_allclose(got.state.x.numpy(), np.asarray(want.state.x), atol=u_tol)
    np.testing.assert_allclose(got.state.yaw.numpy(), np.asarray(want.state.yaw), atol=u_tol)
    np.testing.assert_allclose(got.goal.numpy(), np.asarray(want.goal), atol=1e-6)
    assert np.array_equal(got.safety_mask.numpy(), np.asarray(want.safety_mask))


def test_select_obstacles_ties_match_jax():
    """Ties everywhere: dummy rows (all at the same distance), obstacles
    duplicated, and passed obstacles whose distances round equal under the
    0.5e6 penalty.  The selection and its order must be JAX's."""
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(5):
        x, y = rng.uniform(0.0, 6.0, 2)
        rows += [[x, y, 0.3, 0, 0, 0, 0]] * 2  # duplicated
    rows += [[4.0, 4.0 + d, 0.2, 0, 0, 0, 0] for d in (0.0, 0.004, 0.008)]  # near-equal
    obs = np.asarray(jpad(jnp.asarray(rows, jnp.float32), 20))
    pos = rng.uniform(1.0, 5.0, (B, 2)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    speed = np.where(np.arange(B) % 2 == 0, -0.5, 0.4).astype(np.float32)  # some reverse
    for name, num_obs in ((DOUBLE_INTEGRATOR_2D, 10), (DYNAMIC_UNICYCLE_2D, 10),
                          (DYNAMIC_UNICYCLE_2D, 24)):
        cfg = jt.TrackerConfig(model_name=name, num_obs=num_obs)
        sp = make_spec(name)
        spd = speed if name == DYNAMIC_UNICYCLE_2D else np.zeros(B, np.float32)
        want = np.asarray(jax.jit(jax.vmap(lambda p, h, s: jt.select_obstacles(
            cfg, sp, p, h, jnp.asarray(obs), s)))(jnp.asarray(pos), jnp.asarray(heading),
                                                   jnp.asarray(spd)))
        got = tt.select_obstacles(interop.tracker_config_from_jax(cfg), interop.spec_from_jax(sp),
                                  _t(pos), _t(heading), _t(obs).expand(B, -1, -1),
                                  _t(spd)).numpy()
        assert got.shape == want.shape == (B, num_obs, 7)
        assert np.array_equal(got, want), name


def test_init_state_matches_jax():
    for name, kw in ((DOUBLE_INTEGRATOR_2D, dict(att="gatekeeper")),
                     (DYNAMIC_UNICYCLE_2D, dict(pos_controller="mpc_cbf"))):
        cfg, spec, x0, wps = make_case(name, **kw)
        want = jax_init(cfg, spec, x0, wps)
        got = tt.init_state(interop.tracker_config_from_jax(cfg), interop.spec_from_jax(spec),
                            _t(x0), _t(np.linspace(-3.0, 3.0, B)), first_goal=wps[1][:2])
        ref = interop.tracker_state_from_numpy(want)
        for a, b in zip(jax.tree_util.tree_leaves(tuple(got)), jax.tree_util.tree_leaves(tuple(ref))):
            assert a.shape == b.shape and torch.equal(a, b)
        assert (got.mode == tt.STOP).any() and (got.mode == tt.TRACK).any()


CBF_QP_CASES = [
    (DOUBLE_INTEGRATOR_2D, dict()),
    (DYNAMIC_UNICYCLE_2D, dict()),
    (DOUBLE_INTEGRATOR_2D, dict(sensing=True, cbf_mode="hard")),
    (SINGLE_INTEGRATOR_2D, dict(att="none")),
    (SINGLE_INTEGRATOR_2D, dict(att="simple", sensing=True, enable_rotation=False)),
    (SINGLE_INTEGRATOR_2D, dict(att="velocity_tracking_yaw", sensing=True)),
    (SINGLE_INTEGRATOR_2D, dict(att="visibility_area", sensing=True)),
    (SINGLE_INTEGRATOR_2D, dict(att="visibility_raycast", sensing=True,
                                visibility_mode="point_mass")),
    (SINGLE_INTEGRATOR_2D, dict(att="gatekeeper", sensing=True, detection_mode="ray")),
    (DOUBLE_INTEGRATOR_2D, dict(pos_controller="optimal_decay_cbf_qp")),
    (DYNAMIC_UNICYCLE_2D, dict(pos_controller="optimal_decay_cbf_qp", sensing=True)),
]


@pytest.mark.parametrize("name,kw", CBF_QP_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for n, kw in CBF_QP_CASES])
def test_cbf_qp_step_matches_jax(name, kw):
    cfg, spec, x0, wps = make_case(name, **kw)
    st = jax_init(cfg, spec, x0, wps)
    unknown = UNKNOWN if kw.get("sensing") else None
    jstep = jax_stepper(cfg, spec, wps, KNOWN, unknown)
    want = jstep(st)
    got = torch_step(cfg, spec, st, wps, KNOWN, unknown)
    assert_step_matches(got, want, 2e-3)
    # a second step from the JAX state: the memory, footprint and gatekeeper carry over
    want2 = jstep(want.state)
    got2 = torch_step(cfg, spec, want.state, wps, KNOWN, unknown)
    assert_step_matches(got2, want2, 2e-3)
    if cfg.att_controller == "gatekeeper":
        for f in ("committed_len", "time_idx", "next_event_idx", "total_replans"):
            assert np.array_equal(getattr(got2.state.att_gk, f).numpy(),
                                  np.asarray(getattr(want2.state.att_gk, f))), f


SMALL_MPC = dict(num_obs=5, outer_iters=2, newton_iters=2)
MPC_CASES = [
    (DYNAMIC_UNICYCLE_2D, 4, False), (DYNAMIC_UNICYCLE_2D, 4, True),
    (QUAD_3D, 2, False), (QUAD_3D, 2, True),
    (VTOL_2D, 2, False), (VTOL_2D, 2, True),
]
_JAX_MPC_STEPS = {}


def jax_mpc_step(name, horizon):
    """The JAX step of an MPC case, with ``use_fused_kernel=False``: its
    general solve is the plain reference of the JAX fused kernel, whose
    interpret mode would take minutes here.  Computed once per case."""
    if (name, horizon) not in _JAX_MPC_STEPS:
        mpc = jmpc.MPCConfig(horizon=horizon, **SMALL_MPC)
        cfg, spec, x0, wps = make_case(name, pos_controller="mpc_cbf", mpc=mpc)
        st = jax_init(cfg, spec, x0, wps)
        _JAX_MPC_STEPS[(name, horizon)] = (st, jax_stepper(cfg, spec, wps, KNOWN)(st))
    return _JAX_MPC_STEPS[(name, horizon)]


@pytest.mark.parametrize("name,horizon,fused", MPC_CASES)
def test_mpc_step_matches_jax(name, horizon, fused):
    mpc = jmpc.MPCConfig(horizon=horizon, use_fused_kernel=fused, **SMALL_MPC)
    cfg, spec, x0, wps = make_case(name, pos_controller="mpc_cbf", mpc=mpc)
    st, want = jax_mpc_step(name, horizon)
    before = (tfused.DISPATCH_COUNT, tfused.LAUNCH_COUNT)
    got = torch_step(cfg, spec, st, wps, KNOWN)
    # one call of the fused solve for the whole batch, and no launch on the CPU
    assert (tfused.DISPATCH_COUNT - before[0], tfused.LAUNCH_COUNT - before[1]) == (int(fused), 0)
    assert_step_matches(got, want, 5e-3)
    np.testing.assert_allclose(got.state.mpc.U.numpy(), np.asarray(want.state.mpc.U), atol=5e-3)


@pytest.mark.parametrize("pos_controller", ["cbf_qp", "mpc_cbf"])
def test_step_float64_matches_jax(pos_controller):
    name = DOUBLE_INTEGRATOR_2D if pos_controller == "cbf_qp" else DYNAMIC_UNICYCLE_2D
    mpc = jmpc.MPCConfig(horizon=4, **SMALL_MPC)
    cfg, spec, x0, wps = make_case(name, pos_controller=pos_controller, mpc=mpc)
    with jax.enable_x64(True):
        st = jax_init(cfg, spec, x0, wps, dtype=jnp.float64)
        want = jax_stepper(cfg, spec, wps, KNOWN)(st)
        got = torch_step(cfg, spec, st, wps, KNOWN, dtype=torch.float64)
        assert got.u.dtype == torch.float64
        assert_step_matches(got, want, 1e-6)


def test_closed_loop_prefix_matches_jax_run():
    """40 steps of the DoubleIntegrator2D CBF-QP scenario from its start."""
    spec = make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.0, a_max=1.5, radius=0.25)
    cfg = jt.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, pos_controller="cbf_qp", dt=0.05)
    x0 = np.array([2.0, 2.0, 0.0, 0.0])
    st = jt.init_state(cfg, spec, jnp.asarray(x0, jnp.float32), np.pi / 2,
                       first_goal=WAYPOINTS[0][:2])
    n = 40
    final, traj = jax.jit(lambda s: jt.run(cfg, spec, s, jnp.asarray(WAYPOINTS, jnp.float32),
                                           jnp.asarray(4), jnp.asarray(KNOWN), n))(st)
    tcfg, tspec = interop.tracker_config_from_jax(cfg), interop.spec_from_jax(spec)
    tst = tt.init_state(tcfg, tspec, _t(x0), np.pi / 2, first_goal=WAYPOINTS[0][:2])
    tfinal, ttraj = tt.run(tcfg, tspec, tst, _t(WAYPOINTS), 4, _t(KNOWN), n)
    assert ttraj["x"].shape == (1, n, 4) and ttraj["u"].shape == (1, n, 2)
    assert np.array_equal(ttraj["ret"].numpy()[0], np.asarray(traj["ret"]))
    np.testing.assert_allclose(ttraj["x"].numpy()[0], np.asarray(traj["x"]), atol=2e-3)
    np.testing.assert_allclose(ttraj["u"].numpy()[0], np.asarray(traj["u"]), atol=2e-3)
    assert int(tfinal.goal_idx[0]) == int(final.goal_idx) == 1
    assert float(ttraj["x"][0, -1, 1]) > 2.5  # on its way to the second waypoint


def test_terminal_robots_stay_frozen_in_a_mixed_batch():
    """Robots whose last code was terminal (-1 done, -2 infeasible) keep
    every field, the MPC warm start, the memory, the footprint and the
    gatekeeper state included, while the rest of the batch runs on exactly
    as a batch of the running robots alone."""
    cfg, spec, x0, wps = make_case(DOUBLE_INTEGRATOR_2D, pos_controller="mpc_cbf",
                                   att="gatekeeper", sensing=True,
                                   mpc=jmpc.MPCConfig(horizon=4, use_fused_kernel=True,
                                                      **SMALL_MPC))
    tcfg, tspec = interop.tracker_config_from_jax(cfg), interop.spec_from_jax(spec)
    st = tt.init_state(tcfg, tspec, _t(x0), _t(np.linspace(-3, 3, B)), first_goal=wps[1][:2],
                       device="cpu")
    args = (_t(wps), len(wps), _t(KNOWN), _t(UNKNOWN))
    st = tt.step(tcfg, tspec, st, *args).state  # a state with some history
    frozen = torch.tensor([True, False, False, True, False, True, False, False])
    st = st._replace(ret=torch.where(frozen, torch.tensor([-1, 0, 0, -2, 0, -1, 0, 0]), st.ret))
    out = tt.step(tcfg, tspec, st, *args)
    running = tt.step(tcfg, tspec, type(st)(*jax.tree_util.tree_map(
        lambda a: a[~frozen], tuple(st))), *args)
    old, new = jax.tree_util.tree_leaves(tuple(st)), jax.tree_util.tree_leaves(tuple(out.state))
    live = jax.tree_util.tree_leaves(tuple(running.state))
    assert len(old) == len(new) == len(live) == 20
    for a, b, c in zip(old, new, live):
        assert torch.equal(b[frozen], a[frozen])
        assert torch.equal(b[~frozen], c)
    assert not torch.equal(out.state.x[~frozen], st.x[~frozen])


def test_tracker_config_validation():
    with pytest.raises(ValueError, match="Unknown controller type"):
        tt.TrackerConfig(model_name=DYNAMIC_UNICYCLE_2D, pos_controller="nope")
    with pytest.raises(ValueError, match="Unknown attitude controller"):
        tt.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, att_controller="nope")
    with pytest.raises(ValueError, match="Unsupported unknown_obs_detection"):
        tt.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, detection_mode="lidar")
    with pytest.raises(ValueError, match="Unsupported cbf_mode"):
        tt.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, cbf_mode="soft")
    with pytest.raises(ValueError, match="require a GridSpec"):
        tt.TrackerConfig(model_name=DOUBLE_INTEGRATOR_2D, att_controller="gatekeeper")
    cfg = tt.TrackerConfig(model_name=DYNAMIC_UNICYCLE_2D, pos_controller="optimal_decay_mpc_cbf")
    assert cfg.mpc.optimal_decay and cfg.uses_mpc
    jcfg = jt.TrackerConfig(model_name=DYNAMIC_UNICYCLE_2D, pos_controller="optimal_decay_mpc_cbf")
    assert interop.tracker_config_from_jax(jcfg) == cfg
    # the optimal-decay MPC's state carries the two decay multipliers a stage
    tst = tt.init_state(cfg, interop.spec_from_jax(make_spec(DYNAMIC_UNICYCLE_2D)),
                        torch.zeros(4), device="cpu")
    jst = jt.init_state(jcfg, make_spec(DYNAMIC_UNICYCLE_2D), jnp.zeros(4))
    assert tst.mpc.U.shape == (1,) + jst.mpc.U.shape == (1, 10, 4)
    assert np.array_equal(tst.mpc.U[0].numpy(), np.asarray(jst.mpc.U))
    assert [f.name for f in dataclasses.fields(tt.TrackerConfig)] == \
        [f.name for f in dataclasses.fields(jt.TrackerConfig)]


@pytest.mark.parametrize("name", ["DynamicBicycle2D", "DriftingCar"])
def test_models_not_yet_ported_raise(name):
    """The drift models are ported now: their initial tracker state equals
    JAX's, and a state of the wrong size still raises."""
    cfg = tt.TrackerConfig(model_name=name)
    spec = interop.spec_from_jax(make_spec(name))
    x0 = np.linspace(0.1, 0.8, 5 if name == "DynamicBicycle2D" else 8)
    tst = tt.init_state(cfg, spec, torch.tensor(x0, dtype=torch.float32), device="cpu")
    jst = jt.init_state(jt.TrackerConfig(model_name=name), make_spec(name), jnp.asarray(x0))
    np.testing.assert_array_equal(tst.x[0].numpy(), np.asarray(jst.x))
    assert int(tst.mode[0]) == int(jst.mode)
    assert tst.mpc.U.shape[1:] == jst.mpc.U.shape and tst.mpc.lam.shape[1:] == jst.mpc.lam.shape
    with pytest.raises(RuntimeError):
        tt.init_state(cfg, spec, torch.zeros(3), device="cpu")


# The scenario of tests/test_dynamic_env_e2e.py: 8 obstacles moving at
# (-0.5, +-0.5), two waypoints across them.
DYN_BASE = np.array([[8.0, 9.0, 0.5], [10.0, 4.0, 0.5], [12.0, 5.0, 0.5], [14.0, 9.0, 0.5],
                     [16.0, 6.0, 0.5], [18.0, 14.0, 0.5], [20.0, 4.0, 0.5], [22.0, 12.0, 0.5]])
DYN_VELS = np.array([[-0.5, 0.5] if i % 2 == 0 else [-0.5, -0.5] for i in range(8)])
DYN_OBS = np.hstack([DYN_BASE, DYN_VELS, np.zeros((8, 2))])
DYN_WAYPOINTS = np.array([[1.0, 7.5], [20.0, 7.5]])


@pytest.mark.parametrize("name", [KINEMATIC_BICYCLE_2D_DPCBF, KINEMATIC_BICYCLE_2D_C3BF])
def test_dynamic_env_run_matches_jax(name):
    """B=8 bicycles spread around the scenario's start (some close to the
    obstacles, so that their rows bind), two steps of ``run_dynamic``."""
    spec = make_spec(name, a_max=5.0, radius=0.3)
    cfg = jt.TrackerConfig(model_name=name, pos_controller="cbf_qp", dt=0.05, num_obs=8)
    rng = np.random.default_rng(3)
    x0 = np.zeros((B, 4))
    x0[:, 0] = rng.uniform(1.0, 9.0, B)
    x0[:, 1] = rng.uniform(5.5, 9.5, B)
    x0[:, 2] = rng.uniform(-0.5, 0.5, B)
    x0[:, 3] = rng.uniform(0.5, 2.0, B)
    st = jax.vmap(lambda x: jt.init_state(cfg, spec, x, 0.0, first_goal=DYN_WAYPOINTS[0]))(
        jnp.asarray(x0, jnp.float32))
    obs = np.asarray(jpad(jnp.asarray(DYN_OBS, jnp.float32), 8))
    run = jax.jit(jax.vmap(lambda s: jt.run_dynamic(
        cfg, spec, s, jnp.asarray(DYN_WAYPOINTS, jnp.float32), jnp.asarray(2), jnp.asarray(obs),
        n_steps=2, y_range=(0.0, 15.0))))
    want_final, want_obs, want = run(st)
    final, obs_final, traj = tt.run_dynamic(
        interop.tracker_config_from_jax(cfg), interop.spec_from_jax(spec),
        interop.tracker_state_from_numpy(st), _t(DYN_WAYPOINTS), 2, _t(obs), 2,
        y_range=(0.0, 15.0))
    assert np.array_equal(traj["ret"].numpy(), np.asarray(want["ret"]))
    np.testing.assert_allclose(traj["u"].numpy(), np.asarray(want["u"]), atol=2e-3)
    np.testing.assert_allclose(traj["x"].numpy(), np.asarray(want["x"]), atol=2e-3)
    np.testing.assert_allclose(obs_final.numpy(), np.asarray(want_obs)[0], atol=1e-6)
    assert np.array_equal(final.mode.numpy(), np.asarray(want_final.mode))
    assert (traj["ret"].numpy() == tt.RET_OK).any()


def test_optimal_decay_mpc_step_matches_jax():
    mpc = jmpc.MPCConfig(horizon=4, **SMALL_MPC)
    cfg, spec, x0, wps = make_case(DYNAMIC_UNICYCLE_2D, pos_controller="optimal_decay_mpc_cbf",
                                   mpc=mpc)
    assert cfg.mpc.optimal_decay
    st = jax_init(cfg, spec, x0, wps)
    want = jax_stepper(cfg, spec, wps, KNOWN)(st)
    got = torch_step(cfg, spec, st, wps, KNOWN)
    assert_step_matches(got, want, 5e-3)
    assert got.state.mpc.U.shape == (B, 4, 4)
    np.testing.assert_allclose(got.state.mpc.U.numpy(), np.asarray(want.state.mpc.U), atol=5e-3)


def test_dynamic_obstacles_match_jax():
    obs = KNOWN[:6].copy()
    obs[:, 3:5] = np.random.default_rng(8).uniform(-2, 2, (6, 2))
    want = np.asarray(jt.step_dynamic_obstacles(jnp.asarray(obs), 0.05, (0.0, 5.0), (0.0, 6.0)))
    got = tt.step_dynamic_obstacles(_t(obs), 0.05, (0.0, 5.0), (0.0, 6.0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("pos_controller", ["cbf_qp", "mpc_cbf"])
def test_fleet_step_on_card_matches_plain_versions(cuda_device, monkeypatch, pos_controller):
    """On a card: one step of a 256-robot fleet launches its kernel once
    (B2 for the CBF-QP, B3 for the fused MPC), and agrees with the same
    step with the kernel's plain version bound in its place: u within 1e-3
    (B2, ``chip_smoke.py``'s QP_U_TOL) or 5e-3 (B3), the codes and modes
    equal."""
    from safe_control_tpu_torch.core.spec import make_spec as tmake_spec
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    name = DOUBLE_INTEGRATOR_2D if pos_controller == "cbf_qp" else DYNAMIC_UNICYCLE_2D
    n_fleet = 256
    rng = np.random.default_rng(0)
    x0 = np.zeros((n_fleet, 4))
    x0[:, :2] = np.array([2.0, 2.0]) + rng.uniform(-0.1, 0.1, (n_fleet, 2))
    if name == DYNAMIC_UNICYCLE_2D:
        x0[:, 2] = np.pi / 2
    cfg = tt.TrackerConfig(model_name=name, pos_controller=pos_controller,
                           mpc=tmpc.MPCConfig(horizon=8, num_obs=5, use_fused_kernel=True))
    spec = tmake_spec(name, a_max=1.5 if name == DOUBLE_INTEGRATOR_2D else 1.0)
    st = tt.init_state(cfg, spec, _t(x0).to(cuda_device), np.pi / 2,
                       first_goal=WAYPOINTS[0][:2])
    args = (_t(WAYPOINTS).to(cuda_device), 4, _t(KNOWN).to(cuda_device))
    counter = qpk if pos_controller == "cbf_qp" else tfused
    before = counter.LAUNCH_COUNT
    out = tt.step(cfg, spec, st, *args)
    torch.cuda.synchronize()
    assert counter.LAUNCH_COUNT == before + 1
    if pos_controller == "cbf_qp":
        monkeypatch.setattr(qpk, "solve_qp_batch", qpk.solve_qp_batch_reference)
        tol = 1e-3
    else:
        monkeypatch.setattr(tfused, "solve_fused_batch", tfused.solve_fused_batch_reference)
        tol = 5e-3
    plain = tt.step(cfg, spec, st, *args)
    torch.cuda.synchronize()
    assert counter.LAUNCH_COUNT == before + 1
    assert (out.u - plain.u).abs().max().item() < tol
    assert torch.equal(out.ret, plain.ret) and torch.equal(out.state.mode, plain.state.mode)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)
