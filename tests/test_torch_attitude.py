"""Port parity: the attitude (yaw side-channel) controllers.

The port's batched ``attitude/`` modules against the JAX package's on the
same numpy inputs, in float32:

- ``velocity_tracking_yaw`` (SingleIntegrator2D and DoubleIntegrator2D,
  with and without the acceleration preview) and the constant rate: within
  1e-6;
- ``visibility_area_yaw`` / ``visibility_targets`` and
  ``visibility_raycast_yaw`` on the corridor footprint of
  ``tests/test_attitude_parity.py``: equal argmax yaws (equal target yaws,
  and rates within 1e-6);
- the yaw gatekeeper over the scripted corridor drive of
  ``tests/test_attitude_parity.py`` (and a second robot in the same batch
  on another line): the sequence of decisions (event, reactive fallback,
  commitment, committed nominal length, crossing and crossing index) must be
  identical, as that test requires of the JAX package, the emitted rates
  within 1e-5, and the replan statistics equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.attitude import gatekeeper_att as jgk
from safe_control_tpu.attitude import simple as jsimple
from safe_control_tpu.attitude import visibility as jvis
from safe_control_tpu.core.spec import DOUBLE_INTEGRATOR_2D, SINGLE_INTEGRATOR_2D, make_spec
from safe_control_tpu.perception.grid import GridSpec
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.attitude import gatekeeper_att as tgk
from safe_control_tpu_torch.attitude import simple as tsimple
from safe_control_tpu_torch.attitude import visibility as tvis
from safe_control_tpu_torch.core.types import linspace

torch.set_num_threads(1)

DT = 0.05
JGS = GridSpec(width=20.0, height=20.0, resolution=0.1)
TGS = interop.grid_from_jax(JGS)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _cell_centers(gs):
    xs = (np.arange(gs.nx) + 0.5) * gs.resolution
    ys = (np.arange(gs.ny) + 0.5) * gs.resolution
    return np.meshgrid(xs, ys, indexing="ij")


def corridor_footprint(gs):
    """A corridor strip plus a start disk (``tests/test_attitude_parity.py``)."""
    cx, cy = _cell_centers(gs)
    return ((cx <= 8.0) & (cy >= 3.5) & (cy <= 6.5)) | ((cx - 1.0) ** 2 + (cy - 5.0) ** 2
                                                          <= 1.5 ** 2)


def frontier_footprint(gs):
    """Everything up to x = 8 known (the gatekeeper corridor)."""
    cx, _ = _cell_centers(gs)
    return cx <= 8.0


def test_linspace_matches_jnp_under_jit():
    """The candidate yaws and sample points, bit for bit as the JAX
    package's functions make them inside ``jax.jit``."""
    for start, stop, num, endpoint in [(-np.pi, np.pi, 36, False), (0.05, 1.0, 32, True),
                                       (0.0, 1.0, 8, True), (0.0, 2 * np.pi, 24, False)]:
        want = np.asarray(jax.jit(lambda z: z + jnp.linspace(start, stop, num,
                                                             endpoint=endpoint))(jnp.zeros(num)))
        assert np.array_equal(linspace(start, stop, num, endpoint=endpoint).numpy(), want)


@pytest.mark.parametrize("name,preview", [(SINGLE_INTEGRATOR_2D, 0.0),
                                          (DOUBLE_INTEGRATOR_2D, 0.0),
                                          (DOUBLE_INTEGRATOR_2D, 0.3)])
def test_velocity_tracking_yaw_matches_jax(name, preview):
    rng = np.random.default_rng(1)
    B = 16
    n = 2 if name == SINGLE_INTEGRATOR_2D else 4
    x = rng.uniform(-1, 1, (B, n)).astype(np.float32)
    u = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    x[0, 2:], u[0] = 0.0, 0.0  # standing still: no command
    spec = make_spec(name)
    want = np.asarray(jax.vmap(lambda a, y, b: jsimple.velocity_tracking_yaw(
        name, spec, a, y, b, preview_time=preview))(jnp.asarray(x), jnp.asarray(yaw),
                                                      jnp.asarray(u)))
    got = tsimple.velocity_tracking_yaw(name, interop.spec_from_jax(spec), _t(x), _t(yaw), _t(u),
                                        preview_time=preview).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == 0.0 and np.abs(got).max() > 0.1
    assert tsimple.simple_att(interop.spec_from_jax(spec), None) == jsimple.simple_att(spec, None)


POSES = [  # off-lattice positions, as in tests/test_attitude_parity.py
    ([2.03, 5.01], 0.3), ([5.02, 4.04], -1.2), ([7.53, 5.51], 2.0), ([6.01, 6.23], 0.0),
    ([3.02, 5.01], 0.0), ([6.51, 4.52], 1.0), ([7.52, 5.03], -0.5),
]


def test_visibility_yaws_match_jax():
    spec = make_spec(DOUBLE_INTEGRATOR_2D, cam_range=2.97)
    tspec = interop.spec_from_jax(spec)
    fp = corridor_footprint(JGS)
    pos = np.array([p for p, _ in POSES], np.float32)
    yaw = np.array([y for _, y in POSES], np.float32)
    B = len(POSES)
    fp_b = np.broadcast_to(fp, (B,) + fp.shape).copy()
    jfp = jnp.asarray(fp)
    # under jax.jit, as the JAX package's tracker runs them
    want_t = np.asarray(jax.jit(lambda p: jgk.visibility_targets(jfp, JGS, p, spec, 36))(
        jnp.asarray(pos)))
    got_t = tgk.visibility_targets(torch.as_tensor(fp_b[:1]), TGS, _t(pos)[None], tspec,
                                   36).numpy()[0]
    assert np.array_equal(got_t, want_t)
    for fn_j, fn_t in ((jvis.visibility_area_yaw, tvis.visibility_area_yaw),
                       (jvis.visibility_raycast_yaw, tvis.visibility_raycast_yaw)):
        want = np.asarray(jax.jit(jax.vmap(lambda p, y: fn_j(jfp, JGS, p, y, spec)))(
            jnp.asarray(pos), jnp.asarray(yaw)))
        got = fn_t(torch.as_tensor(fp_b), TGS, _t(pos), _t(yaw), tspec).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    # an empty map rotates at the maximum rate
    empty = torch.zeros((1,) + fp.shape, dtype=torch.bool)
    assert tvis.visibility_area_yaw(empty, TGS, _t(pos[:1]), _t(yaw[:1]), tspec).item() == \
        spec.w_max


def _decisions(info, k):
    """The decision tuple of robot ``k`` from an info dict (the committed
    nominal length counts only when a commitment was accepted)."""
    ev, re, fo = (bool(np.asarray(info[n])[k]) for n in ("event", "reactive", "found"))
    commit = ev and fo and not re
    return (ev, re, commit, int(np.asarray(info["nominal_len"])[k]) if commit else 0,
            bool(np.asarray(info["crossing"])[k]), int(np.asarray(info["crossing_step"])[k]))


def test_gatekeeper_decisions_match_jax():
    """The scripted corridor drive: robot 0 starts facing away from the
    critical point (the reactive fallback), then advances toward the
    unknown end (the nominal cap shrinks until rejection); robot 1 runs a
    parallel line at another speed.  The world is driven by the JAX
    package's rates, and both sides get the same inputs every step.  The grid
    is cut to 12 m x 10 m: every camera sector and predicted path of the
    drive lies inside it, so the decisions are those of the 20 m grid."""
    jgs = GridSpec(width=12.0, height=10.0, resolution=0.1)
    tgs = interop.grid_from_jax(jgs)
    spec = make_spec(DOUBLE_INTEGRATOR_2D, cam_range=2.97, w_max=2.0)
    tspec = interop.spec_from_jax(spec)
    cfg = jgk.GatekeeperAttConfig(dt=DT, nominal_horizon=1.0, backup_horizon=0.5,
                                  event_offset=0.25, horizon_discount=0.25,
                                  braking_distance_margin=0.35)
    tcfg = interop.gk_att_config_from_jax(cfg)
    T = cfg.total_steps
    fp = frontier_footprint(jgs)
    jfp = jnp.asarray(np.stack([fp, fp]))
    tfp = torch.as_tensor(np.stack([fp, fp]))

    jst = jax.vmap(lambda _: jgk.init_state(cfg))(jnp.arange(2))
    tst = tgk.init_state(tcfg, 2)
    step_j = jax.jit(jax.vmap(lambda st, f, pt, vt, yw: jgk.step(
        cfg, spec, DOUBLE_INTEGRATOR_2D, st, f, jgs, pt, vt, yw)))

    pos = np.array([[6.31, 5.013], [5.07, 6.021]])
    vel = np.array([[1.0, 0.0], [0.8, 0.0]])
    yaw = np.array([2.0, 0.1])
    seq_j, seq_t = [], []
    for _ in range(48):
        ptraj = (pos[:, None, :] + np.arange(T + 1)[None, :, None] * DT * vel[:, None, :]
                 ).astype(np.float32)
        vtraj = np.repeat(vel[:, None, :], T + 1, axis=1).astype(np.float32)
        yw32 = yaw.astype(np.float32)
        u_j, jst, info_j = step_j(jst, jfp, jnp.asarray(ptraj), jnp.asarray(vtraj),
                                  jnp.asarray(yw32))
        u_t, tst, info_t = tgk.step(tcfg, tspec, DOUBLE_INTEGRATOR_2D, tst, tfp, tgs,
                                    _t(ptraj), _t(vtraj), _t(yw32))
        for k in range(2):
            seq_j.append(_decisions(info_j, k))
            seq_t.append(_decisions({n: v.numpy() for n, v in info_t.items()}, k))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5)
        yaw = np.asarray(jnp.mod(jnp.asarray(yaw + np.asarray(u_j) * DT) + np.pi, 2 * np.pi)
                         - np.pi, dtype=float)
        pos = pos + vel * DT
    assert seq_t == seq_j
    assert any(d[1] for d in seq_j) and any(d[2] for d in seq_j)  # both paths exercised
    for name in ("committed_len", "time_idx", "next_event_idx", "total_replans",
                 "accepted_replans", "rejected_replans", "nominal_steps_total"):
        assert np.array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name))), name
    np.testing.assert_allclose(tst.committed_u.numpy(), np.asarray(jst.committed_u), atol=1e-5)


@pytest.mark.parametrize("name", [SINGLE_INTEGRATOR_2D, DOUBLE_INTEGRATOR_2D])
def test_extend_prediction_and_braking_distance_match_jax(name):
    from safe_control_tpu.dynamics import get_model as jget
    from safe_control_tpu_torch.dynamics import get_model as tget

    spec = make_spec(name)
    cfg = jgk.GatekeeperAttConfig()
    rng = np.random.default_rng(2)
    n = jget(name).N_STATES
    x_pred = rng.uniform(-1, 1, (3, 4, n)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda xp: jgk.extend_prediction(
        jget(name), spec, xp, DT, cfg.total_steps))(jnp.asarray(x_pred)))
    got = tgk.extend_prediction(tget(name), interop.spec_from_jax(spec), _t(x_pred), DT,
                                cfg.total_steps).numpy()
    assert got.shape == want.shape == (3, cfg.total_steps + 1, n)
    np.testing.assert_allclose(got, want, atol=1e-6)
    bd_j = np.float32(jgk.max_braking_distance(cfg, spec, name))
    bd_t = np.float32(tgk.max_braking_distance(cfg, interop.spec_from_jax(spec), name))
    assert bd_t == bd_j
