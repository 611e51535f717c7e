"""Port parity: the drift-car simulator (``sim/drift_sim.py``) and its env.

The first three steps of the port's eager simulator on the CPU against the
JAX package's ``DriftingCarSimulator`` on the scenario of
``tests/drift_scenario_common.py`` (a five-lane straight track, the two
moving obstacle cars), at a cut horizon (MPCC N=10 with a 3x2 budget, 10
nominal and 20 backup steps) so that the JAX compile stays short: the
states within 5e-3 and the backup flags equal, for the gatekeeper with the
lane-change backup, MPS with the stopping backup, and the backup CBF.
Also the config's errors, the device checks, ``reset``, the environment's
queries against JAX's, and (slow) the scenarios of
``tests/test_drift_scenario*.py`` at their full size on the CPU.  On a card
(``gpu``): the captured graph's first step equals an eager step.
"""

import numpy as np
import pytest
import torch

import drift_scenario_common as dsc
from safe_control_tpu.envs.drifting_env import DriftingEnv as JEnv
from safe_control_tpu.sim.drift_sim import DriftingCarSimulator as JSim
from safe_control_tpu.sim.drift_sim import DriftSimConfig as JCfg
from safe_control_tpu.solvers import al_gn as jal
from safe_control_tpu.solvers import mpcc as jm
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.envs.drifting_env import DriftingEnv
from safe_control_tpu_torch.sim import drift_sim
from safe_control_tpu_torch.solvers import mpcc as tm

torch.set_num_threads(1)


def _env(cls, moving=True, puddles=(), **kw):
    env = cls("straight", track_width=dsc.LANE_W * dsc.N_LANES, track_length=dsc.TRACK_LEN,
              num_lanes=dsc.N_LANES, **kw)
    ego_y = env.get_lane_center(dsc.EGO_LANE)
    if moving:
        env.add_dynamic_obstacle_car(50.0, env.get_lane_center(dsc.MIDDLE_LANE), 0.0, 2.0, 0.0,
                                     radius=1.0)
        env.add_dynamic_obstacle_car(35.0, 4.0, 0.0, 0.75, 0.0, radius=1.0)
    else:
        env.add_obstacle_car(60.0, ego_y, 0.0, radius=1.0)
    for p in puddles:
        env.add_puddle(p[0], ego_y if p[1] is None else p[1], p[2], p[3])
    return env


def _setup(algo, backup, N, nominal, backup_steps, al, device="cpu", moving=True, puddles=(),
           mu=1.0):
    """The JAX and the port pieces of one scenario: specs, envs, paths,
    the start state and both configs."""
    js = dsc._spec(mu)
    jenv = _env(JEnv, moving, puddles)
    tenv = _env(DriftingEnv, moving, puddles, device=device)
    ego_y = jenv.get_lane_center(dsc.EGO_LANE)
    backup_y = jenv.get_lane_center(dsc.BACKUP_LANE)
    sx = np.linspace(0.0, dsc.TRACK_LEN, 601)
    jp = jm.make_path(sx, np.full_like(sx, ego_y))
    jmcfg = jm.MPCCConfig(horizon=N, v_ref=10.0, al=al)
    kw = dict(dt=dsc.DT, algo=algo, backup=backup, nominal_steps=nominal,
              backup_steps=backup_steps, event_offset_steps=1, discount_steps=5,
              target_velocity=10.0)
    x0 = np.array([1.0, ego_y, 0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    port = dict(spec=interop.spec_from_jax(js), env=tenv,
                path=interop.path_from_jax(jp, device=device), x0=x0,
                mpcc_cfg=interop.mpcc_config_from_jax(jmcfg), cfg=drift_sim.DriftSimConfig(**kw),
                backup_target_y=backup_y)
    jax_side = (js, jenv, jp, x0, jmcfg, JCfg(**kw), backup_y)
    return jax_side, port


@pytest.mark.parametrize("algo,backup", [("gatekeeper", "lane_change"), ("mps", "stop"),
                                         ("backupcbf", "lane_change")])
def test_first_steps_match_jax(algo, backup):
    al = jal.ALGNConfig(outer_iters=3, newton_iters=2)
    jax_side, port = _setup(algo, backup, N=10, nominal=10, backup_steps=20, al=al)
    jsim = JSim(*jax_side)
    tsim = drift_sim.DriftingCarSimulator(**port, device="cpu")
    flags_j, flags_t = [], []
    for _ in range(3):
        b0 = jsim.stats["backup_steps"]
        assert jsim.step() == tsim.step()
        flags_j.append(jsim.stats["backup_steps"] - b0)
        flags_t.append(tsim.stats["backup_steps"] - (sum(flags_t)))
    np.testing.assert_allclose(np.asarray(tsim.trajectory), np.asarray(jsim.trajectory),
                               atol=5e-3, rtol=0)
    assert flags_t == flags_j
    for k in ("nominal_steps", "backup_steps", "collision", "collision_step"):
        assert tsim.stats[k] == jsim.stats[k]
    if algo == "backupcbf":
        assert tsim.stats["global_min_h"] == pytest.approx(jsim.stats["global_min_h"], abs=5e-3)
    np.testing.assert_allclose(tsim.predictions[-1], jsim.predictions[-1], atol=5e-3)
    assert tsim.mstate.initialized.all() and bool(tsim.gstate.initialized.all()) == \
        (algo != "backupcbf")


def test_config_errors_devices_and_reset():
    with pytest.raises(ValueError, match="unknown algo"):
        drift_sim.DriftSimConfig(algo="nope")
    with pytest.raises(ValueError, match="unknown backup"):
        drift_sim.DriftSimConfig(backup="nope")
    al = tm.al_gn.ALGNConfig(outer_iters=1, newton_iters=1)
    _, port = _setup("gatekeeper", "lane_change", N=4, nominal=4, backup_steps=5,
                     al=jal.ALGNConfig(outer_iters=1, newton_iters=1))
    port["mpcc_cfg"] = tm.MPCCConfig(horizon=4, v_ref=10.0, al=al)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            drift_sim.DriftingCarSimulator(**port)
    with pytest.raises(ValueError, match="horizon"):
        drift_sim.DriftingCarSimulator(**{**port, "mpcc_cfg": tm.MPCCConfig(horizon=3)},
                                       device="cpu")
    sim = drift_sim.DriftingCarSimulator(**port, device="cpu")
    out = sim.run(0.1)
    assert len(out["trajectory"]) == 2 and out["nominal_steps"] + out["backup_steps"] == 2
    assert np.isfinite(out["x_final"]).all() and out["x_final"][0] > 1.0
    sim.reset(port["x0"])
    assert sim.t_idx == 0 and sim.trajectory == [] and sim.stats["nominal_steps"] == 0
    np.testing.assert_array_equal(sim.x.numpy(), port["x0"].astype(np.float32))
    assert not sim.mstate.initialized.any() and not sim.gstate.initialized.any()
    with pytest.raises(ValueError, match="track width"):
        sim.reset(port["x0"], env=DriftingEnv("straight", track_width=7.0, device="cpu"))


def test_env_queries_match_jax():
    import jax.numpy as jnp

    jenv = _env(JEnv, puddles=[(28.0, None, 10.0, 0.05), (60.0, 0.0, 3.0, 0.4)])
    tenv = _env(DriftingEnv, puddles=[(28.0, None, 10.0, 0.05), (60.0, 0.0, 3.0, 0.4)],
                device="cpu")
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(-5, 305, 200), rng.uniform(-12, 12, 200)], axis=1)
    pos = pos.astype(np.float32)
    for i, p in enumerate(pos):
        pj = jnp.asarray(p)
        pt = torch.tensor(p)
        assert bool(tenv.check_collision(pt, 1.2)) == bool(jenv.check_collision(pj, 1.2))
        assert float(tenv.get_friction_at_position(pt, 0.9)) == \
            float(jenv.get_friction_at_position(pj, 0.9))
        assert bool(tenv.check_obstacle_collision(pt, 1.2, t=3.0)) == \
            bool(jenv.check_obstacle_collision(pj, 1.2, t=3.0))
        if i < 20:
            assert float(tenv.signed_lateral_offset(pt)) == pytest.approx(
                float(jenv.signed_lateral_offset(pj)), abs=1e-5)
    for t in (0.0, 2.5):
        np.testing.assert_allclose(tenv.obstacle_car_states(t).numpy(),
                                   np.asarray(jenv.obstacle_car_states(t)), atol=1e-6)
    np.testing.assert_allclose(tenv.centerline.numpy(), np.asarray(jenv.centerline))
    for track in ("oval", "l_shape"):
        a, b = JEnv(track), DriftingEnv(track, device="cpu")
        np.testing.assert_allclose(b.normals.numpy(), np.asarray(a.normals), atol=1e-7)
    jenv.step_dynamic_obstacles(0.5)
    tenv.step_dynamic_obstacles(0.5)
    np.testing.assert_allclose(tenv.obstacle_cars.numpy(), np.asarray(jenv.obstacle_cars))


def _port_scenario(algo, backup, puddles=(), mu=1.0, tf=8.0, moving=True):
    """``drift_scenario_common._run`` through the port, eagerly on the CPU."""
    _, port = _setup(algo, backup, N=30, nominal=30, backup_steps=60, al=jal.ALGNConfig(),
                     moving=moving, puddles=puddles, mu=mu)
    return drift_sim.DriftingCarSimulator(**port, device="cpu").run(tf)


@pytest.mark.slow
def test_high_friction_gatekeeper_no_collision():
    r = _port_scenario("gatekeeper", "lane_change")
    assert not r["collision"], f"collision at {r['x_final'][:2]}"
    assert r["x_final"][0] > 40.0


@pytest.mark.slow
def test_high_friction_mps_runs():
    r = _port_scenario("mps", "lane_change")
    assert np.isfinite(r["x_final"]).all() and r["x_final"][0] > 30.0
    assert r["nominal_steps"] + r["backup_steps"] > 0


@pytest.mark.slow
def test_puddle_surprise_negative_case():
    r = _port_scenario("gatekeeper", "lane_change", puddles=[(28.0, None, 10.0, 0.05)], tf=6.0)
    assert r["collision"], f"puddle_surprise unexpectedly survived: {r['x_final'][:2]}"


@pytest.mark.slow
def test_high_friction_backupcbf_runs():
    r = _port_scenario("backupcbf", "lane_change")
    assert np.isfinite(r["x_final"]).all() and r["x_final"][0] > 30.0
    assert r["nominal_steps"] + r["backup_steps"] > 0


@pytest.mark.slow
def test_stop_backup_no_collision():
    r = _port_scenario("gatekeeper", "stop", moving=False, tf=9.0)
    assert not r["collision"], f"collision at {r['x_final'][:2]}"
    assert r["backup_steps"] > 0 or r["x_final"][5] < 10.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_graph_replay_equals_eager_step_on_card(cuda_device):
    """The captured step's first replay and an eager step on the card run
    the same kernels on the same inputs: the same next state."""
    al = jal.ALGNConfig(outer_iters=3, newton_iters=2)
    _, port = _setup("gatekeeper", "lane_change", N=10, nominal=10, backup_steps=20, al=al,
                     device=cuda_device)
    graph = drift_sim.DriftingCarSimulator(**port, device=cuda_device)
    eager = drift_sim.DriftingCarSimulator(**port, device=cuda_device, graph=False)
    for _ in range(3):
        assert graph.step() == eager.step()
    assert graph.capture_seconds is not None and eager.capture_seconds is None
    np.testing.assert_allclose(np.asarray(graph.trajectory), np.asarray(eager.trajectory),
                               atol=1e-6, rtol=0)
