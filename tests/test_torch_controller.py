"""Port parity: the host-side ``LocalTrackingController`` (``sim/controller.py``).

The port's controller on the CPU (``device="cpu"``) against the JAX
package's, driven the same way:

- a short SingleIntegrator2D CBF-QP run with the RGB-D sensor on and the
  camera looking away from the motion (so that the visibility code 1
  occurs) to its goal: the same return codes step for
  step, controls and states within 2e-3 (the CBF-QP gate);
- the device cache of waypoints and obstacles follows an obstacle array
  mutated in place, and is not rebuilt for unchanged content;
- ``run_all_steps(write_csv=True)``: the same CSV header and columns, rows
  within 2e-3 of the JAX controller's;
- ``set_waypoints`` (leading waypoints within the reached threshold
  dropped, the first goal's FoV test deciding the start mode) and
  ``set_unknown_obs`` (padding to 7 columns);
- the card by default: without CUDA the constructor raises unless the
  caller asks for the CPU; ``mpc_rti`` selects ``MPCConfig.rti``.
"""

import csv
import types

import numpy as np
import pytest
import torch

from safe_control_tpu.sim.controller import LocalTrackingController as JaxController
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.sim import tracking as tt
from safe_control_tpu_torch.sim.controller import LocalTrackingController

torch.set_num_threads(1)

ENV = types.SimpleNamespace(width=6.0, height=6.0, resolution=0.1,
                            obs_circle=np.array([[2.2, 1.6, 0.3]]))
SI = {"model": "SingleIntegrator2D", "v_max": 1.0, "radius": 0.25, "sensor": "rgbd"}


def pair(robot_spec=SI, X0=(1.0, 1.0, 0.2), **kw):
    kw.setdefault("env", ENV)
    return (JaxController(list(X0), robot_spec, **kw),
            LocalTrackingController(list(X0), robot_spec, device="cpu", **kw))


def test_return_codes_match_jax_controller():
    # the camera held at 1.2 rad while the robot drives along +x: the braking
    # tube leaves the sensed footprint (code 1) before the goal (code -1)
    jc, tc = pair(X0=(1.0, 1.0, 1.2), controller_type={"pos": "cbf_qp", "att": "none"},
                  enable_rotation=False)
    for c in (jc, tc):
        c.set_waypoints([[1.0, 1.0], [1.9, 1.05]])
        c.set_unknown_obs([[1.8, 0.5, 0.2]])
    rets_j, rets_t = [], []
    for _ in range(40):
        rets_j.append(jc.control_step())
        rets_t.append(tc.control_step())
        np.testing.assert_allclose(tc.get_control_input(), jc.get_control_input(), atol=2e-3)
        np.testing.assert_allclose(tc.robot_state, np.asarray(jc.robot_state), atol=2e-3)
        assert np.array_equal(tc.last_safety_mask, np.asarray(jc.last_safety_mask))
        if rets_j[-1] in (tt.RET_DONE, tt.RET_INFEASIBLE):
            break
    assert rets_t == rets_j
    assert rets_t[-1] == tt.RET_DONE and tc.has_reached_goal() and jc.has_reached_goal()
    assert tt.RET_VISIBILITY in rets_t  # the sensing paths ran
    assert tc.u_pos.shape == (2,) and tc.get_control_input().shape == (2, 1)
    assert tc.last_safety_mask.shape == (60, 60)


def test_device_cache_follows_in_place_obstacle_updates():
    c = LocalTrackingController([1.0, 1.0], {"model": "SingleIntegrator2D"}, env=ENV,
                                device="cpu")
    c.set_waypoints([[4.0, 1.0]])
    c.control_step()
    cache = c._dev_cache
    c.control_step()
    assert c._dev_cache is cache  # unchanged content: nothing re-uploaded
    c.obs[0, :2] += 0.5  # a dynamic environment moves the obstacle in place
    c.control_step()
    assert c._dev_cache is not cache
    known = c._dev_cache[2]
    np.testing.assert_allclose(known[0, :3].numpy(), [2.7, 2.1, 0.3], atol=1e-6)
    assert known.shape == (32, 7) and known[1, 0] == 1000.0
    c.obs = np.array([[2.7, 2.1, 0.3, 0, 0, 0, 0]])  # reassigned, same content
    cache = c._dev_cache
    c.control_step()
    assert c._dev_cache is cache


def test_csv_matches_jax_controller(tmp_path, monkeypatch):
    robot = {"model": "DoubleIntegrator2D", "a_max": 1.5}
    rows = {}
    for name, c in zip(("jax", "torch"), pair(robot, X0=(1.0, 1.0, 0.0, 0.0))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        c.set_waypoints([[3.0, 3.0]])
        assert c.run_all_steps(tf=0.25, write_csv=True) == 0
        with open(d / "output.csv", newline="") as f:
            rows[name] = list(csv.reader(f))
    assert rows["torch"][0] == rows["jax"][0] == ["states", "control_inputs", "alpha1", "alpha2"]
    assert len(rows["torch"]) == len(rows["jax"]) == 6
    got = np.array(rows["torch"][1:], dtype=float)
    want = np.array(rows["jax"][1:], dtype=float)
    assert got.shape == want.shape == (5, 4 + 2 + 2)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_set_waypoints_and_unknown_obs():
    jc, tc = pair(X0=(1.0, 1.0, np.pi))
    wps = [[1.1, 1.0], [1.2, 1.1], [3.0, 1.0], [3.0, 3.0]]
    for c in (jc, tc):
        c.set_waypoints(wps)
    np.testing.assert_array_equal(tc.waypoints, jc.waypoints)
    assert len(tc.waypoints) == 2  # the two leading waypoints within 0.3 m dropped
    assert int(tc.state.mode[0]) == int(jc.state.mode) == tt.STOP  # goal behind the camera
    assert float(tc.state.yaw[0]) == pytest.approx(np.pi)
    for uo in ([2.0, 2.0, 0.3], [[2.0, 2.0, 0.3], [3.0, 2.0, 0.2]],
               [[3.0, 2.0, 0.2, 0.1, 4.0, 0.0, 1.0]], []):
        for c in (jc, tc):
            c.set_unknown_obs(uo)
        np.testing.assert_array_equal(tc.unknown_obs, jc.unknown_obs)
        assert tc.unknown_obs.shape[1] == 7
    assert tc.cfg == interop.tracker_config_from_jax(jc.cfg)  # the same tracker configuration
    assert (tc.cfg.grid.nx, tc.cfg.num_obs, tc.cfg.use_sensor) == (60, 10, True)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert LocalTrackingController([1.0, 1.0], {"model": "SingleIntegrator2D"}).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LocalTrackingController([1.0, 1.0], {"model": "SingleIntegrator2D"})
    # the real-time-iteration preset, as the JAX controller builds it
    for extra in ({}, {"mpc_newton_iters": 3}):
        rs = {"model": "VTOL2D", "mpc_rti": True, **extra}
        rti = LocalTrackingController([0.0, 10.0, 0.0, 10.0, 0.0, 0.0], rs, device="cpu")
        want = JaxController._build_mpc_cfg(rs, 30, "mpc_cbf")
        assert rti.cfg.mpc == interop.config_from_jax(want)._replace(scan_unroll=1)
        assert (rti.cfg.mpc.outer_iters, rti.cfg.mpc.newton_iters) == \
            (2, extra.get("mpc_newton_iters", 2))
