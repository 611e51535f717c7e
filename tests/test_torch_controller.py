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
  caller asks for the CPU; ``mpc_rti`` selects ``MPCConfig.rti``;
- the step can be captured as a CUDA graph: for each configuration of the
  tracker, a step after the first reads nothing back to the host and makes
  no tensor from host values (no ``_local_scalar_dense``, ``nonzero``,
  boolean indexing or ``lift_fresh`` among its aten operations); on the
  CPU the controller runs it eagerly.  (With ``use_fused_kernel`` the CPU
  runs B3's plain version, not the kernel's wrapper the card captures:
  ``chip_smoke.py`` phases 13 and 29 capture that configuration.)
- ``examples/test_vtol.py``'s RTI robot with ``use_fused_kernel``
  (VTOL2D N=30, M=120, past the JAX package's fused width of 64): a control
  step goes through the fused solve once, and its control agrees with the
  same step through the general solve within 5e-3 (the kernel envelope).
"""

import csv
import types

from torch.utils._python_dispatch import TorchDispatchMode

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


class HostReads(TorchDispatchMode):
    """Records the aten operations that read a tensor back to the host or
    make one from host values: neither can be captured in a CUDA graph."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name == "index" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in (args[1] or ()))
        if name in ("_local_scalar_dense", "nonzero", "lift_fresh", "masked_select",
                    "item") or bool_index:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


DISPATCH_ENV = types.SimpleNamespace(width=12.0, height=12.0, resolution=0.25,
                                     obs_circle=np.array([[6.0, 5.0, 0.5]]))
CAPTURE_CASES = {
    "di_cbf_qp": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D"}, {"pos": "cbf_qp"}),
    "di_fov_memory": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D", "sensor": "rgbd"},
                      {"pos": "cbf_qp"}),
    "di_ray": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D", "sensor": "rgbd",
                              "unknown_obs_detection": "ray"}, {"pos": "cbf_qp"}),
    "di_visibility_area": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D", "sensor": "rgbd"},
                           {"pos": "cbf_qp", "att": "visibility_area"}),
    "di_visibility_raycast": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D", "sensor": "rgbd"},
                              {"pos": "cbf_qp", "att": "visibility_raycast"}),
    "du_optimal_decay_qp": ([1, 1, 0, 0.5], {"model": "DynamicUnicycle2D"},
                            {"pos": "optimal_decay_cbf_qp"}),
    "du_mpc": ([1, 1, 0, 0.5], {"model": "DynamicUnicycle2D", "mpc_horizon": 4,
                                "mpc_outer_iters": 1, "mpc_newton_iters": 1}, {"pos": "mpc_cbf"}),
    "di_mpc_gatekeeper": ([1, 1, 0, 0], {"model": "DoubleIntegrator2D", "sensor": "rgbd",
                                         "mpc_horizon": 4, "mpc_outer_iters": 1,
                                         "mpc_newton_iters": 1},
                          {"pos": "mpc_cbf", "att": "gatekeeper"}),
    "vtol_wide_mpc": ([2, 10, 0, 20, 0, 0], {"model": "VTOL2D", "mpc_horizon": 11,
                                             "mpc_outer_iters": 1, "mpc_newton_iters": 1},
                      {"pos": "mpc_cbf"}),
}


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_step_reads_nothing_back_to_the_host(case):
    x0, rs, ct = CAPTURE_CASES[case]
    c = LocalTrackingController(x0, rs, controller_type=ct, dt=0.05, env=DISPATCH_ENV,
                                device="cpu")
    assert not c.captured and not c.step_object().use_graph
    c.set_unknown_obs([[5.0, 3.4, 0.5, 0, 0, 0, 0]])
    c.set_waypoints([[45.0, 10.0]] if rs["model"] == "VTOL2D" else [[9.0, 6.0]])
    c.control_step()  # the first step makes the device constants
    wps, n_wps, known, unknown = c._device_inputs()
    with HostReads() as audit:
        tt.step(c.cfg, c.spec, c.state, wps, n_wps, known, unknown)
    assert audit.seen == []


def test_vtol_rti_step_goes_through_the_fused_solve():
    from safe_control_tpu_torch.envs.env import Env
    from safe_control_tpu_torch.solvers import mpc_fused

    spec = {"model": "VTOL2D", "radius": 0.6, "v_max": 20.0, "reached_threshold": 1.0,
            "mpc_horizon": 30, "mpc_rti": True}
    pillars = np.hstack([np.asarray([[37.0, float(y), 0.5] for y in range(6, 10)]),
                         np.zeros((4, 4))])
    us = {}
    for fused in (True, False):
        c = LocalTrackingController([2.0, 10.0, 0.0, 20.0, 0.0, 0.0],
                                    dict(spec, use_fused_kernel=fused),
                                    controller_type={"pos": "mpc_cbf"}, dt=0.05,
                                    env=Env(width=75.0, height=20.0), device="cpu")
        c.obs = pillars
        c.set_waypoints(np.asarray([[2.0, 10.0], [45.0, 10.0]]))
        before = mpc_fused.DISPATCH_COUNT
        c.control_step()
        assert mpc_fused.DISPATCH_COUNT == before + fused
        us[fused] = np.asarray(c.u_pos)
    assert np.isfinite(us[True]).all()
    assert np.abs(us[True] - us[False]).max() < 5e-3
