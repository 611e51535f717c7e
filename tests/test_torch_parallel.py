"""Port parity: the multi-device path over ``torch.distributed``, the
profiling hooks and the helpers.

- the sharded Monte Carlo sweep (16 scenarios from the JAX package's
  ``dpcbf_sweep_init`` through ``interop``, 20 steps in chunks of 10) and
  the sharded shielded fleet (two walls of 16, 4 chunks of 3) at world
  sizes 2 and 4: gloo ranks spawned as their own interpreters
  (``tests/torch_dist_worker.py``, which imports no JAX) on a ``FileStore``
  under ``tmp_path``; every rank's result equal to the port's
  single-process path: return codes and counters exactly, states within
  2e-5 (as ``tests/test_fleet_shielded.py`` holds JAX's sharded fleet; a
  batch split another way rounds CPU transcendentals in other SIMD lanes);
- the same at world size 1 in this process, and ``sharded_batch_apply`` /
  ``psum_scenario``, bit for bit;
- ``scenario_mesh`` raises without a process group;
- ``trace_to`` and ``span`` on the CPU;
- ``utils.helpers`` against the JAX package's.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from safe_control_tpu.core.spec import KINEMATIC_BICYCLE_2D_DPCBF, make_spec
from safe_control_tpu.parallel import monte_carlo as jmc
from safe_control_tpu.sim import tracking as jt
from safe_control_tpu.utils import helpers as jhelpers
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.parallel import fleet as fl
from safe_control_tpu_torch.parallel import fleet_scenarios as fs
from safe_control_tpu_torch.parallel import mesh as mesh_mod
from safe_control_tpu_torch.parallel import monte_carlo as tmc
from safe_control_tpu_torch.utils import helpers as thelpers
from safe_control_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
RANK_TIMEOUT = 240.0  # seconds for all the ranks of one world
WAYPOINTS = [[1.0, 7.5], [20.0, 7.5]]
JSPEC = make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, radius=0.3)
JCFG = jt.TrackerConfig(model_name=KINEMATIC_BICYCLE_2D_DPCBF, pos_controller="cbf_qp", dt=0.05,
                        num_obs=8, qp_iters=400)
SPEC = interop.spec_from_jax(JSPEC)
CFG = interop.tracker_config_from_jax(JCFG)
leaves = torch.utils._pytree.tree_leaves


@pytest.fixture(scope="module")
def reference():
    """The scenarios and the port's single-process results."""
    wj = jnp.asarray(WAYPOINTS, dtype=jnp.float32)
    s0 = jmc.dpcbf_sweep_init(JCFG, JSPEC, jax.random.PRNGKey(0), batch=16, waypoints=wj)
    sweep0 = interop.sweep_state_from_numpy(s0, device="cpu")
    wps = torch.tensor(WAYPOINTS)
    sweep = sweep0
    for _ in range(2):
        sweep = tmc.run_sweep_chunk(CFG, SPEC, sweep, wps, 2, 10)
    groups, specs, x0s, fwps, n_wps, known = fs.two_walls(16, "cpu")
    fleet = fl.init_shielded_fleet(groups, x0s)
    for _ in range(4):
        fleet = fl.step_fleet_shielded(groups, specs, fleet, fwps, n_wps, known, n_steps=3,
                                       k_neighbors=4)
    return dict(sweep0=sweep0, waypoints=wps, sweep=sweep, rates=tmc.sweep_stats(sweep),
                fleet=fleet, groups=groups)


def _run_ranks(world, tmp_path, payload):
    """Start ``world`` rank interpreters, wait for them within RANK_TIMEOUT
    (killing every one still running on a failure) and load their results."""
    in_file = tmp_path / "in.pt"
    torch.save(payload, in_file)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(tmp_path / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(rank), str(world), str(tmp_path / "store"),
                 str(in_file), str(tmp_path / f"out{rank}.pt")],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()[-4000:]
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _assert_sweep_equal(got, ref, atol):
    assert torch.equal(got.tracker.ret, ref.tracker.ret)
    for name in ("mode", "goal_idx"):
        assert torch.equal(getattr(got.tracker, name), getattr(ref.tracker, name))
    assert int(got.steps_done) == int(ref.steps_done) == 20
    for a, b in zip(leaves(got), leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= atol
        else:
            assert torch.equal(a, b)


def _assert_fleet_equal(got, ref, atol):
    for name in ("goal_idx", "backup_steps", "commits"):
        for a, b in zip(getattr(got, name), getattr(ref, name)):
            assert torch.equal(a, b), name
    for a, b in zip(got.x, ref.x):
        assert (a - b).abs().max().item() <= atol
    for a, b in zip(leaves(got.gk), leaves(ref.gk)):
        if a.is_floating_point():
            assert (a - b).abs().max().item() <= atol
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_paths_match_single_process(world, reference, tmp_path):
    outs = _run_ranks(world, tmp_path, dict(sweep=reference["sweep0"],
                                            waypoints=reference["waypoints"]))
    for out in outs:  # every rank holds the whole result
        assert not out["jax_imported"]
        _assert_sweep_equal(out["sweep"], reference["sweep"], 2e-5)
        assert out["rates"] == tuple(float(v) for v in reference["rates"])
        _assert_fleet_equal(out["fleet"], reference["fleet"], 2e-5)
    stats = fl.shielded_fleet_stats(reference["groups"], outs[0]["fleet"])
    assert stats["commits"] > 0


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store1"), 1), rank=0,
                            world_size=1)
    try:
        yield mesh_mod.scenario_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_in_process_is_bit_identical(reference, world_of_one):
    mesh = world_of_one
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    final, res = tmc.run_sharded_sweep(mesh, CFG, SPEC, reference["sweep0"], WAYPOINTS, 2, 20,
                                       chunk=10)
    _assert_sweep_equal(final, reference["sweep"], 0.0)
    assert torch.equal(res.x, reference["sweep"].tracker.x)
    assert [float(res.success_rate), float(res.collision_rate)] == \
        [float(v) for v in reference["rates"]]
    groups, specs, x0s, wps, n_wps, known = fs.two_walls(16, "cpu")
    st = mesh_mod.shard_leading_axis(mesh, fl.init_shielded_fleet(groups, x0s))
    for _ in range(4):
        st = fl.step_fleet_shielded_sharded(groups, specs, st, wps, n_wps, known, mesh,
                                            n_steps=3, k_neighbors=4)
    _assert_fleet_equal(st, reference["fleet"], 0.0)
    # the generic wrapper and the sum
    batch = torch.arange(12.0).reshape(6, 2)
    apply = mesh_mod.sharded_batch_apply(mesh, lambda b: (b * 2.0, b.sum()),
                                         reduce_stats=mesh_mod.psum_scenario)
    out, total = apply(batch)
    assert torch.equal(out, batch * 2.0) and float(total) == float(batch.sum())
    with pytest.raises(ValueError, match="the group has 1"):
        mesh_mod.scenario_mesh(2, device="cpu")


def test_shard_and_gather_blocks(world_of_one):
    mesh = mesh_mod.ScenarioMesh(group=None, rank=1, size=3, device=torch.device("cpu"))
    tree = (torch.arange(6), torch.ones((6, 2), dtype=torch.bool), torch.tensor(5))
    got = mesh_mod.shard_leading_axis(mesh, tree)
    assert torch.equal(got[0], torch.tensor([2, 3])) and got[1].shape == (2, 2)
    assert int(got[2]) == 5
    with pytest.raises(ValueError, match="divide"):
        mesh_mod.shard_leading_axis(mesh, torch.zeros(4))
    one = world_of_one
    flags = mesh_mod.gather_leading_axis(one, torch.tensor([True, False]))
    assert flags.dtype == torch.bool and flags.tolist() == [True, False]
    groups, specs, x0s, wps, n_wps, known = fs.two_walls(3, "cpu")
    halves = mesh_mod.ScenarioMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="world size"):
        fl.step_fleet_shielded_sharded(groups, specs, fl.init_shielded_fleet(groups, x0s), wps,
                                       n_wps, known, halves)


def test_scenario_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.scenario_mesh()


def test_kernel_timer_trace_and_annotate_on_cpu(tmp_path):
    """``trace_to`` and ``span``, which replaced ``KernelTimer`` and
    ``annotate``: the span in the profile and in the Chrome trace as a
    host-only event, the session's record, and the metadata (no B3 phase
    clock without a card; the counters' rise over the session)."""
    from safe_control_tpu_torch.solvers import mpc_cbf, mpc_fused

    for _ in range(2):  # each session starts with an empty record
        with profiling.trace_to(str(tmp_path / "trace")) as prof:
            with profiling.span("fleet_chunk"):
                torch.ones((32, 32)).exp().sum()
        assert [s.name for s in profiling.spans()] == ["fleet_chunk"]
    names = {e.key for e in prof.key_averages()}
    assert "fleet_chunk" in names
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert {e.get("cat") for e in data["traceEvents"] if e.get("name") == "fleet_chunk"} == {
        "cpu_op"}
    assert data["b3_phases"] is None
    counters = data["port_counters"]
    assert counters[f"{mpc_fused.__name__}.DISPATCH_COUNT"] == 0
    assert counters[f"{mpc_fused.__name__}.LAUNCH_COUNT"] == 0
    assert counters[f"{mpc_fused.__name__}.NARROW_LAUNCH_COUNT"] == 0
    assert counters[f"{mpc_cbf.__name__}._FUSED_FALLBACK_SEEN"] == 0


def test_helpers_match_jax():
    pos = np.array([[1.0, 2.0], [-3.0, 0.5]], np.float32)
    yaw = np.array([0.3, -2.0], np.float32)
    for i in range(2):
        jl, jr = jhelpers.fov_edge_points(jnp.asarray(pos[i]), float(yaw[i]), 1.2, 3.0)
        tl, tr = thelpers.fov_edge_points(torch.from_numpy(pos[i]), float(yaw[i]), 1.2, 3.0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    tl, tr = thelpers.fov_edge_points(torch.from_numpy(pos), torch.from_numpy(yaw), 1.2, 3.0)
    assert tl.shape == tr.shape == (2, 2)
    rects = [[1.0, 2.0, 4.0, 2.0], [0.0, 0.0, 1.0, 3.0]]
    np.testing.assert_array_equal(thelpers.rect_to_superellipsoid(rects, 4.0, 0.2),
                                  jhelpers.rect_to_superellipsoid(rects, 4.0, 0.2))
    with pytest.raises(ValueError):
        thelpers.rect_to_superellipsoid(rects, 1.5, 0.0)
    assert thelpers.angle_normalize is not None
