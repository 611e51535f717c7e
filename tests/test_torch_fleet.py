"""Port parity: the heterogeneous fleets of ``parallel/fleet.py``.

- the tracked fleet: ``tests/test_fleet.py::_mk``'s 24 robots (DI, DU and
  DPCBF bicycles) for 20 steps of ``step_fleet`` (chunks of 1, coupling
  margin 0.5) against JAX: the return codes equal, the states within 2e-3
  (the general QP's float32 rounding); the port's scenario builder gives
  JAX's inputs;
- the shielded fleet: ``tests/test_fleet_shielded.py``'s two walls at 8 a
  group, 3 chunks of 5 steps, in both prediction modes, against JAX:
  backup steps, commits and goal indices equal, x within 2e-3 (1e-9 in
  float64), the gatekeeper states' integers equal;
- neighbour ties keep the lower index first, as ``lax.top_k``;
- the registry guards and registration;
- ``min_pairwise_clearance``, ``fleet_positions`` and the statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fleet as jfleet_case
import test_fleet_shielded as jshield_case
from safe_control_tpu.parallel import fleet as jf
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.core.spec import QUAD_2D, make_spec
from safe_control_tpu_torch.core.types import norm2
from safe_control_tpu_torch.parallel import fleet as tf
from safe_control_tpu_torch.parallel import fleet_scenarios as fs

torch.set_num_threads(1)


def _np(a):
    return np.asarray(a)


def _to_torch(groups, specs, x0s, wps, known, dtype=torch.float32):
    specs_t = [interop.spec_from_jax(s) for s in specs]
    x0s_t = [torch.as_tensor(_np(x), dtype=dtype) for x in x0s]
    wps_t = [torch.as_tensor(_np(w), dtype=dtype) for w in wps]
    return specs_t, x0s_t, wps_t, torch.as_tensor(_np(known), dtype=dtype)


def test_corridor_scenario_builder_matches_jax():
    groups, specs, x0s, wps, n_wps, known = jfleet_case._mk()
    tg, ts, tx, tw, tn, tk = fs.corridor_fleet("cpu")
    assert [interop.fleet_group_from_jax(g) for g in groups] == tg
    assert [interop.spec_from_jax(s) for s in specs] == ts
    for a, b in zip(x0s + wps, tx + tw):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    np.testing.assert_array_equal(tk.numpy(), _np(known))
    assert tn == [int(n) for n in n_wps]


def test_tracked_fleet_matches_jax():
    groups, specs, x0s, wps, n_wps, known = jfleet_case._mk()
    js = jf.init_fleet(groups, specs, x0s, [w[:, 0] for w in wps])
    step = jax.jit(lambda s: jf.step_fleet(groups, specs, s, wps, n_wps, known,
                                           inter_robot=True, n_steps=1, coupling_margin=0.5))
    tg = [interop.fleet_group_from_jax(g) for g in groups]
    ts, tx, tw, tk = _to_torch(groups, specs, x0s, wps, known)
    st = tf.init_fleet(tg, ts, tx, [w[:, 0] for w in tw], device="cpu")
    for a, b in zip(js.trackers, st.trackers):
        np.testing.assert_array_equal(b.mode.numpy(), _np(a.mode))
    for _ in range(20):
        js = step(js)
        st = tf.step_fleet(tg, ts, st, tw, [1, 1, 1], tk, True, 1, 0.5)
    ref = interop.fleet_state_from_numpy(js, device="cpu")
    for a, b in zip(ref.trackers, st.trackers):
        for name in ("ret", "goal_idx", "mode"):
            assert torch.equal(getattr(b, name), getattr(a, name)), name
        assert (b.x - a.x).abs().max().item() < 2e-3
    assert tf.fleet_stats(tg, st) == jf.fleet_stats(groups, js)
    jp, tp = jf.fleet_positions(groups, js), tf.fleet_positions(tg, st)
    assert tp.shape == (24, 3)
    assert np.abs(tp.numpy() - _np(jp)).max() < 2e-3
    # a chunk of 2 steps with the views held fixed, and no coupling
    st2 = tf.step_fleet(tg, ts, st, tw, [1, 1, 1], tk, True, 2, 0.5)
    js2 = jax.jit(lambda s: jf.step_fleet(groups, specs, s, wps, n_wps, known, True, 2, 0.5))(js)
    st3 = tf.step_fleet(tg, ts, st, tw, [1, 1, 1], tk, False, 1)
    js3 = jax.jit(lambda s: jf.step_fleet(groups, specs, s, wps, n_wps, known, False, 1))(js)
    for j_out, t_out in ((js2, st2), (js3, st3)):
        for a, b in zip(j_out.trackers, t_out.trackers):
            np.testing.assert_array_equal(b.ret.numpy(), _np(a.ret))
            assert np.abs(b.x.numpy() - _np(a.x)).max() < 2e-3


def test_coupling_excludes_the_own_group_and_ties_keep_the_lower_index():
    """A robot sees the nearest 4 robots of the OTHER groups only (the JAX
    package leaves its whole group out), and among equally far robots the
    lower global index."""
    tg, ts, tx, tw, tn, tk = fs.corridor_fleet("cpu")
    # group 1 and 2 robots on a ring around group 0's robot 0: all at distance 1
    x0 = [x.clone() for x in tx]
    c = x0[0][0, :2]
    ang = torch.arange(8, dtype=torch.float64) * (2 * np.pi / 8)
    ring = (c.double() + torch.stack([torch.cos(ang), torch.sin(ang)], -1)).float()
    x0[1][:, :2] = ring
    x0[2][:, :2] = ring + 0.0
    st = tf.init_fleet(tg, ts, x0, [w[:, 0] for w in tw], device="cpu")
    obs = tf.coupling_obstacles(tg, st, tk, 0.5)
    assert [o.shape for o in obs] == [(8, 8, 7)] * 3
    rows0 = obs[0][0, 4:]
    pos = tf.fleet_positions(tg, st)
    d = norm2(pos[8:, :2] - c)
    expect = 8 + torch.sort(d, stable=True).indices[:4]
    np.testing.assert_array_equal(rows0[:, :2].numpy(), pos[expect, :2].numpy())
    np.testing.assert_allclose(rows0[:, 2].numpy(), pos[expect, 2].numpy() + 0.5)
    own = set(map(tuple, pos[:8, :2].numpy().tolist()))
    for o in obs[0].reshape(-1, 7)[:, :2].numpy().tolist():
        assert tuple(o) not in own
    # JAX's views on the same positions
    groups, specs, _, wps, n_wps, known = jfleet_case._mk()
    js = jf.init_fleet(groups, specs, [jnp.asarray(x.numpy()) for x in x0],
                       [w[:, 0] for w in wps])
    jsel = jf.fleet_positions(groups, js)
    others = jnp.concatenate([jsel[8:]], axis=0)
    _, jidx = jax.lax.top_k(-jnp.linalg.norm(others[:, :2] - jsel[0, :2][None], axis=1), 4)
    np.testing.assert_array_equal(expect.numpy() - 8, _np(jidx))


def _shielded_case(n_per_group, dtype):
    groups, specs, x0s, wps, n_wps, known = jshield_case.build_fleet(n_per_group=n_per_group)
    tg = [interop.shielded_group_from_jax(g) for g in groups]
    ts, tx, tw, tk = _to_torch(groups, specs, x0s, wps, known, dtype)
    return (groups, specs, x0s, wps, n_wps, known), (tg, ts, tx, tw, [1, 1], tk)


@pytest.mark.parametrize("prediction", ["commitments", "constant_velocity"])
def test_shielded_fleet_matches_jax(prediction):
    (groups, specs, x0s, wps, n_wps, known), (tg, ts, tx, tw, tn, tk) = \
        _shielded_case(8, torch.float32)
    built = fs.two_walls(8, "cpu")
    assert built[0] == tg and built[1] == ts
    for a, b in zip(built[2] + built[3], tx + tw):
        assert torch.equal(a, b)
    js = jf.init_shielded_fleet(groups, x0s)
    step = jax.jit(lambda s: jf.step_fleet_shielded(groups, specs, s, wps, n_wps, known,
                                                    n_steps=5, k_neighbors=4,
                                                    prediction=prediction))
    st = tf.init_shielded_fleet(tg, tx, device="cpu")
    for _ in range(3):
        js = step(js)
        st = tf.step_fleet_shielded(tg, ts, st, tw, tn, tk, n_steps=5, k_neighbors=4,
                                    prediction=prediction)
    ref = interop.shielded_fleet_state_from_numpy(js, device="cpu")
    for gi in range(2):
        assert np.abs(st.x[gi].numpy() - ref.x[gi].numpy()).max() < 2e-3
        for name in ("goal_idx", "backup_steps", "commits"):
            assert torch.equal(getattr(st, name)[gi], getattr(ref, name)[gi]), name
        for name in ("time_idx", "next_event_idx", "nominal_steps_committed", "initialized",
                     "committed_valid"):
            assert torch.equal(getattr(st.gk[gi], name), getattr(ref.gk[gi], name)), name
    assert tf.shielded_fleet_stats(tg, st) == jf.shielded_fleet_stats(groups, js)
    assert abs(tf.min_pairwise_clearance(tg, st) - jf.min_pairwise_clearance(groups, js)) < 2e-3
    assert sum(int(c.sum()) for c in st.commits) > 0


def test_shielded_fleet_matches_jax_float64():
    (groups, specs, x0s, wps, n_wps, known), (tg, ts, tx, tw, tn, tk) = \
        _shielded_case(8, torch.float64)
    with jax.enable_x64(True):
        x64 = [jnp.asarray(_np(x), jnp.float64) for x in x0s]
        w64 = [jnp.asarray(_np(w), jnp.float64) for w in wps]
        k64 = jnp.asarray(_np(known), jnp.float64)
        js = jf.init_shielded_fleet(groups, x64)
        js = js._replace(gk=tuple(g._replace(committed_x=g.committed_x.astype(jnp.float64),
                                             committed_u=g.committed_u.astype(jnp.float64))
                                  for g in js.gk))
        step = jax.jit(lambda s: jf.step_fleet_shielded(groups, specs, s, w64, n_wps, k64,
                                                        n_steps=5, k_neighbors=4))
        for _ in range(3):
            js = step(js)
        ref = interop.shielded_fleet_state_from_numpy(js, device="cpu", dtype=torch.float64)
    st = tf.init_shielded_fleet(tg, tx, device="cpu", dtype=torch.float64)
    for _ in range(3):
        st = tf.step_fleet_shielded(tg, ts, st, tw, tn, tk, n_steps=5, k_neighbors=4)
    for gi in range(2):
        assert st.x[gi].dtype == torch.float64
        assert np.abs(st.x[gi].numpy() - ref.x[gi].numpy()).max() < 1e-9
        for name in ("goal_idx", "backup_steps", "commits"):
            assert torch.equal(getattr(st, name)[gi], getattr(ref, name)[gi]), name


def test_unsupported_family_raises():
    gk = jshield_case.GK
    groups = [tf.ShieldedGroup(model_name=QUAD_2D, count=2,
                               gk=interop.gatekeeper_config_from_jax(
                                   dataclasses.replace(gk, model_name=QUAD_2D)))]
    with pytest.raises(KeyError, match="brake policy"):
        tf.init_shielded_fleet(groups, [torch.zeros((2, 6))], device="cpu")
    assert QUAD_2D not in tf.BRAKE_REGISTRY and QUAD_2D not in tf.PLANAR_VELOCITY_REGISTRY
    with pytest.raises(KeyError, match="planar-velocity"):
        tf._planar_velocity(QUAD_2D, torch.zeros((2, 6)))
    # a minimum-speed bicycle cannot park: its brake builder refuses it
    with pytest.raises(ValueError, match="v_min"):
        tf._brake_policy("KinematicBicycle2D", make_spec("KinematicBicycle2D", v_min=0.2), 0.05)


def test_registration_admits_a_family(monkeypatch):
    monkeypatch.setattr(tf, "BRAKE_REGISTRY", dict(tf.BRAKE_REGISTRY))
    monkeypatch.setattr(tf, "PLANAR_VELOCITY_REGISTRY", dict(tf.PLANAR_VELOCITY_REGISTRY))
    tf.register_brake_policy(QUAD_2D, lambda spec, dt: (lambda x: -x[..., 3:5] / dt))
    tf.register_planar_velocity(QUAD_2D, lambda x: x[..., 3:5])
    gk = interop.gatekeeper_config_from_jax(dataclasses.replace(jshield_case.GK,
                                                                model_name=QUAD_2D))
    groups = [tf.ShieldedGroup(model_name=QUAD_2D, count=2, gk=gk)]
    st = tf.init_shielded_fleet(groups, [torch.zeros((2, 6))], device="cpu")
    assert st.x[0].shape == (2, 6) and st.gk[0].committed_x.shape == (2, gk.committed_len, 6)
    x = torch.tensor([[0.0, 0.0, 0.0, 1.0, -2.0, 0.0]])
    np.testing.assert_array_equal(tf._brake_policy(QUAD_2D, None, 0.5)(x).numpy(), [[-2.0, 4.0]])


def test_brakes_and_velocities_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 4)).astype(np.float32) * [3.0, 3.0, 2.0, 1.0]
    for model, spec_kw in (("DoubleIntegrator2D", dict(a_max=1.5)),
                           ("DynamicUnicycle2D", dict(a_max=1.0)),
                           ("KinematicBicycle2D", dict(a_max=1.0, v_min=0.0))):
        from safe_control_tpu.core.spec import make_spec as jmake_spec

        jspec = jmake_spec(model, **spec_kw)
        jb = jax.vmap(jf._brake_policy(model, jspec, 0.05))(jnp.asarray(x))
        tb = tf._brake_policy(model, interop.spec_from_jax(jspec), 0.05)(torch.from_numpy(x))
        np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=1e-6, atol=1e-6)
        jv = jax.vmap(lambda r: jf._planar_velocity(model, r))(jnp.asarray(x))
        tv = tf._planar_velocity(model, torch.from_numpy(x))
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6, atol=1e-6)


def test_min_pairwise_clearance_and_positions():
    (groups, specs, x0s, wps, n_wps, known), (tg, ts, tx, tw, tn, tk) = \
        _shielded_case(4, torch.float32)
    x0s = [x.at[0, :2].set(jnp.asarray([3.0, 3.0])) for x in x0s]  # two robots coincide
    tx = [torch.as_tensor(_np(x)) for x in x0s]
    js = jf.init_shielded_fleet(groups, x0s)
    st = tf.init_shielded_fleet(tg, tx, device="cpu")
    got, ref = tf.min_pairwise_clearance(tg, st), jf.min_pairwise_clearance(groups, js)
    assert got == pytest.approx(ref, abs=1e-6) and got == pytest.approx(-0.5, abs=1e-6)
    stats = tf.shielded_fleet_stats(tg, st)
    assert stats == jf.shielded_fleet_stats(groups, js)
    assert stats == dict(total=8, backup_steps=0, commits=0, mean_goal_idx=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_tracked_fleet_on_card_is_one_qp_launch_a_group_a_step(cuda_device):
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    groups, specs, x0s, wps, n_wps, known = fs.corridor_fleet(cuda_device)
    st = tf.init_fleet(groups, specs, x0s, [w[:, 0] for w in wps])
    before = qpk.LAUNCH_COUNT
    st = tf.step_fleet(groups, specs, st, wps, n_wps, known, True, 5, 0.5)
    torch.cuda.synchronize()
    assert qpk.LAUNCH_COUNT - before == 3 * 5
    assert all(bool(torch.isfinite(t.x).all()) for t in st.trackers)
    assert tf.fleet_stats(groups, st)["infeasible_or_collision"] == 0
