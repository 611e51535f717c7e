"""Port parity: the workspace and warehouse environments and the warehouse
case-study runs.

- ``Env``: the obstacle split, boundary strips and grid helpers equal JAX's;
- ``_ghost_table`` at every level and 100 ``step``s of every level equal
  JAX's exactly (float64 on the host), and the device ghost table its
  float32;
- ``fold_position`` in float32 and float64 on negative and positive inputs
  equals ``jnp.mod``'s fold bit for bit; the fold prediction is bounce-exact
  and the level 6-7 tables hold their reshuffled rows (the JAX package's
  own tests, on the port);
- ``safe_spots`` at level 3 equals JAX's; the collision checks agree;
- the first 20 steps of ``run_backup_cbf_level(1)`` and
  ``run_gatekeeper_level(3)`` on the CPU: the recorded states within 2e-3
  of JAX's, and each step's ladder branch (QP solved / nominal / backup),
  ``qp_ok`` and ``using_backup`` equal; BackupCBF's first step from rest
  fails its QP (the NaN derivative of the speed norm) and applies the
  nominal [3, 0], in both packages.

The per-step flags are read by wrapping each package's ``backup_cbf.solve``
or ``gatekeeper.step`` for the test (``jax.debug.callback`` on the JAX
side, inside its jitted step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.envs import env as jenv
from safe_control_tpu.envs import warehouse_env as jwe
from safe_control_tpu.sim import warehouse_sim as jws
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.envs import env as tenv
from safe_control_tpu_torch.envs import warehouse_env as twe
from safe_control_tpu_torch.sim import warehouse_sim as tws

torch.set_num_threads(1)

LEVELS = [0, 1, 2, 3, 4, 5, 6, 7, "hero"]


def test_env_matches_jax():
    known = [[5.0, 5.0, 1.0, 0, 0, 0, 0], [8.0, 2.0, 0.5, 0, 0, 0, 0],
             [12.0, 9.0, 1.0, 2.0, 4.0, 0.3, 1.0]]
    for rows in (known, [[5.0, 5.0, 1.0], [8.0, 2.0, 0.5]]):
        je, te = jenv.Env(20.0, 15.0, rows, 0.25), tenv.Env(20.0, 15.0, rows, 0.25)
        for name in ("obs_circle", "obs_superellipsoid", "obs_boundary", "obs_rectangle",
                     "all_obs"):
            np.testing.assert_array_equal(getattr(te, name), getattr(je, name))
    assert te.get_map_shape() == je.get_map_shape() == (60, 80)
    pts = np.array([[0.1, 0.2], [19.9, 14.9], [7.3, 3.3]])
    np.testing.assert_array_equal(te.f_to_grid(pts), je.f_to_grid(pts))
    np.testing.assert_array_equal(te.grid_to_f([[3, 4]]), je.grid_to_f([[3, 4]]))
    assert tenv.Env().all_obs.shape == jenv.Env().all_obs.shape == (0, 7)
    with pytest.raises(ValueError, match="e should be >= 2"):
        tenv.Env(known_obs=[[1.0, 1.0, 1.0, 1.0, 1.5, 0.0, 1.0]])


@pytest.mark.parametrize("level", LEVELS)
def test_ghost_tables_and_steps_equal_jax(level):
    assert twe._ghost_table(level) == jwe._ghost_table(level)
    je = jwe.WarehouseEnv(level=level, dt=0.1)
    te = twe.WarehouseEnv(level=level, dt=0.1, device="cpu")
    for _ in range(100):
        je.step()
        te.step()
    np.testing.assert_array_equal(te._ghosts, je._ghosts)
    g = te.ghosts
    assert g.dtype == torch.float32 and g.shape == (twe.MAX_GHOSTS, 5)
    assert torch.equal(g, interop.ghosts_from_numpy(je.ghosts))
    np.testing.assert_array_equal(te.static_obs7, je.static_obs7)
    np.testing.assert_array_equal(te.get_nominal_waypoints(), je.get_nominal_waypoints())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fold_position_matches_jnp_mod(dtype):
    rng = np.random.default_rng(0)
    z = np.concatenate([rng.normal(size=4000) * 400.0,
                        [-578.0, -194.0, -192.0, -2.0, -1e-7, -0.0, 0.0, 2.0, 98.0, 194.0,
                         386.0, 1e6]]).astype(dtype)
    assert (z < 0).sum() > 1000 and (z > 0).sum() > 1000
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jwe.fold_position(jnp.asarray(z)))
    out = twe.fold_position(torch.from_numpy(z)).numpy()
    assert out.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, ref)
    assert (out >= twe.BOUNCE_LO).all() and (out <= twe.BOUNCE_HI).all()


def test_fold_prediction_is_bounce_exact():
    env = twe.WarehouseEnv(level=3, dt=0.1, device="cpu")
    g0 = env._ghosts.copy()
    act = g0[:, 4] > 0
    n = 400  # several bounces for the fast sweepers
    for _ in range(n):
        env.step()
    g = env._ghosts[act]
    t = n * env.dt
    px = twe.fold_position(torch.from_numpy(g0[act, 0] + g0[act, 2] * t)).numpy()
    py = twe.fold_position(torch.from_numpy(g0[act, 1] + g0[act, 3] * t)).numpy()
    assert np.abs(px - g[:, 0]).max() < 1e-9
    assert np.abs(py - g[:, 1]).max() < 1e-9


def _has(act, x, y, vx, vy):
    m = ((np.abs(act[:, 0] - x) < 1e-4) & (np.abs(act[:, 1] - y) < 1e-4)
         & (np.abs(act[:, 2] - vx) < 1e-4) & (np.abs(act[:, 3] - vy) < 1e-4))
    return bool(m.any())


def test_levels_6_7_exact_tables():
    g6 = twe.WarehouseEnv(level=6, dt=0.05, device="cpu").ghosts.numpy()
    act6 = g6[g6[:, 4] > 0]
    assert len(act6) == 28
    s = 2.7
    assert _has(act6, 95.0, 25.0, -s, 0.0) and not _has(act6, 5.0, 30.0, s, 0.0)
    assert _has(act6, 45.0, 25.0, 1.5, 0.0)
    assert _has(act6, 95.0, 5.0, 0.0, s) and _has(act6, 25.0, 5.0, 0.0, s)
    assert _has(act6, 95.0, 55.0, -s, 0.0) and _has(act6, 80.0, 85.0, -1.5, 0.0)
    assert _has(act6, 95.0, 70.0, -s, 0.0) and _has(act6, 50.0, 10.0, 0.0, s * 0.45)
    g7 = twe.WarehouseEnv(level=7, dt=0.05, device="cpu").ghosts.numpy()
    act7 = g7[g7[:, 4] > 0]
    assert len(act7) == 28
    s7, fs = 2.6, 2.6 * 0.8
    for y in (44.0, 58.0, 72.0, 86.0):
        assert _has(act7, 5.0, y, fs, 0.0)
    for x in (44.0, 58.0, 72.0, 86.0):
        assert _has(act7, x, 5.0, 0.0, fs)
    assert _has(act7, 95.0, 34.0, -fs * 1.1, 0.0) and _has(act7, 95.0, 30.0, -s7, 0.0)
    assert _has(act7, 66.0, 80.0, 0.0, -fs * 1.2) and _has(act7, 66.0, 60.0, 0.0, fs * 1.2)
    assert _has(act7, 20.0, 70.0, s7 * 1.02, 0.0) and _has(act7, 95.0, 5.0, 0.0, s7)


def test_safe_spots_level3_equal_jax():
    ref = jwe.WarehouseEnv(level=3, dt=0.1).safe_spots(robot_radius=tws.R)
    out = twe.WarehouseEnv(level=3, dt=0.1, device="cpu").safe_spots(robot_radius=tws.R)
    assert out.shape == ref.shape and len(out) > 100
    np.testing.assert_array_equal(out, ref)


def test_collision_checks_match_jax():
    je = jwe.WarehouseEnv(level=2, dt=0.1)
    te = twe.WarehouseEnv(level=2, dt=0.1, device="cpu")
    pts = np.array([[10.0, 10.0], [20.5, 26.0], [94.0, 50.0], [-0.5, 50.0], [88.0, 89.0],
                    [50.0, 9.0], [99.7, 3.0]], np.float32)
    tp = torch.from_numpy(pts)
    for t in (0.0, 1.5):
        np.testing.assert_array_equal(te.ghost_states(t).numpy(), np.asarray(je.ghost_states(t)))
        got = te.check_ghost_collision(tp, 0.8, t).numpy()
        ref = [bool(je.check_ghost_collision(jnp.asarray(p), 0.8, t)) for p in pts]
        np.testing.assert_array_equal(got, ref)
    for fn in ("check_boundary_collision", "check_static_collision"):
        got = getattr(te, fn)(tp, 0.8).numpy()
        ref = [bool(getattr(je, fn)(jnp.asarray(p), 0.8)) for p in pts]
        np.testing.assert_array_equal(got, ref)
    got = te.check_goal_reached(tp).numpy()
    np.testing.assert_array_equal(got, [bool(je.check_goal_reached(jnp.asarray(p))) for p in pts])
    assert got.any() and not got.all()


def _branch(qp_ok, h_min):
    """The fallback ladder's branch: the QP's input, the nominal input (QP
    failed, safe now) or the raw backup (QP failed, unsafe)."""
    return "qp" if qp_ok else ("nominal" if h_min > 0.01 else "backup")


def test_backup_cbf_level1_first_steps_match_jax(monkeypatch):
    jflags, tflags = [], []
    j_solve, t_solve = jws.bcbf.solve, tws.bcbf.solve

    def j_wrapped(*args, **kwargs):
        res = j_solve(*args, **kwargs)
        jax.debug.callback(lambda ok, ub, h, u: jflags.append(
            (bool(ok), bool(ub), float(h), np.asarray(u).copy())),
            res.qp_ok, res.using_backup, res.h_min, res.u)
        return res

    def t_wrapped(*args, **kwargs):
        res = t_solve(*args, **kwargs)
        tflags.append((bool(res.qp_ok[0]), bool(res.using_backup[0]), float(res.h_min[0]),
                       res.u[0].numpy().copy()))
        return res

    monkeypatch.setattr(jws.bcbf, "solve", j_wrapped)
    monkeypatch.setattr(jws, "_CTRL_CACHE", {})
    monkeypatch.setattr(tws.bcbf, "solve", t_wrapped)
    monkeypatch.setattr(tws, "_STEPS", {})
    rj, rt = [], []
    out_j = jws.run_backup_cbf_level(1, max_steps=20, record=rj)
    out_t = tws.run_backup_cbf_level(1, max_steps=20, record=rt, device="cpu")
    assert len(rj) == len(rt) == len(jflags) == len(tflags) == 20
    assert np.abs(np.array(rt) - np.array(rj)).max() < 2e-3
    for (jok, jub, jh, _), (tok, tub, th, _) in zip(jflags, tflags):
        assert (tok, tub) == (jok, jub)
        assert _branch(tok, th) == _branch(jok, jh)
        assert abs(th - jh) < 2e-3
    # step 0 from rest: the QP fails and the nominal [3, 0] is applied
    for ok, ub, h, u in (jflags[0], tflags[0]):
        assert not ok and not ub and abs(h - 1.0) < 1e-6
        np.testing.assert_allclose(u, [3.0, 0.0], atol=1e-6)
    assert out_t["outcome"] == out_j["outcome"] and out_t["wp_i"] == out_j["wp_i"]
    assert out_t["steps"] == out_j["steps"] == 20
    assert abs(out_t["min_h"] - out_j["min_h"]) < 2e-3
    assert abs(out_t["min_rollout_h"] - out_j["min_rollout_h"]) < 2e-3


def test_gatekeeper_level3_first_steps_match_jax(monkeypatch):
    jflags, tflags = [], []
    j_step, t_step = jws.gk.step, tws.gk.step

    def j_wrapped(*args, **kwargs):
        out = j_step(*args, **kwargs)
        jax.debug.callback(lambda ub, ev, found: jflags.append((bool(ub), bool(ev), bool(found))),
                           out.using_backup, out.event_fired, out.candidate_found)
        return out

    def t_wrapped(*args, **kwargs):
        out = t_step(*args, **kwargs)
        tflags.append((bool(out.using_backup[0]), bool(out.event_fired[0]),
                       bool(out.candidate_found[0])))
        return out

    monkeypatch.setattr(jws.gk, "step", j_wrapped)
    monkeypatch.setattr(tws.gk, "step", t_wrapped)
    monkeypatch.setattr(tws, "_STEPS", {})
    rj, rt = [], []
    out_j = jws.run_gatekeeper_level(3, max_steps=20, record=rj)
    out_t = tws.run_gatekeeper_level(3, max_steps=20, record=rt, device="cpu")
    assert len(rj) == len(rt) == len(jflags) == len(tflags) == 20
    assert np.abs(np.array(rt) - np.array(rj)).max() < 2e-3
    assert tflags == jflags
    assert any(f[1] for f in tflags)  # events fired
    assert out_t == pytest.approx(out_j, abs=2e-3)


def test_runs_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tws.run_gatekeeper_level(1, max_steps=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_captured_steps_equal_eager_steps_on_card(cuda_device):
    from safe_control_tpu_torch.shielding import gatekeeper as tgk

    env = twe.WarehouseEnv(level=3, dt=tws.DT, device=cuda_device)
    spots = tws.padded_spots(env)
    x0 = torch.tensor([[10.0, 10.0, 0.0, 0.0]], device=cuda_device)
    goal = torch.tensor([[30.0, 10.0]], device=cuda_device)
    for name, args in (("gatekeeper", lambda: (tgk.init_state(tws.GK_CFG, 1, device=cuda_device),
                                               x0, goal, env.ghosts, spots)),
                       ("backup_cbf", lambda: (x0, goal, env.ghosts))):
        eager = tws.step_object(name, cuda_device, graph=False)(*args())[-1].cpu()
        graphed = tws.step_object(name, cuda_device)
        first = graphed(*args())[-1].cpu()
        again = graphed(*args())[-1].cpu()
        assert graphed.capture_seconds is not None
        assert torch.equal(first, eager) and torch.equal(again, eager)
