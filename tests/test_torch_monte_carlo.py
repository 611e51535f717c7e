"""Port parity: the Monte Carlo sweep, the checkpoint and the metrics.

- ``run_sweep_chunk`` against JAX's on the same init (the JAX
  ``dpcbf_sweep_init``'s arrays through ``interop``): 64 randomized DPCBF
  dynamic-obstacle scenarios (``tests/test_parallel.py``'s configuration)
  over 20 steps, the return codes equal and the states within 2e-3 (the
  general QP's float32 rounding), and the same success and collision
  rates.  This is also the check of the dynamic-obstacle fleet against JAX
  on a larger sample (64 starts) than PR 10's 8;
- ``dpcbf_sweep_init``'s draws (a ``torch.Generator``): ranges, shapes and
  reproducibility;
- a checkpoint saved mid-sweep and restored resumes bit for bit;
- the metrics accumulation and the CSV logger;
- the multi-device pieces raise, naming ROADMAP A.7.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import KINEMATIC_BICYCLE_2D_DPCBF, make_spec
from safe_control_tpu.parallel import monte_carlo as jmc
from safe_control_tpu.sim import tracking as jt
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.parallel import mesh as tmesh
from safe_control_tpu_torch.parallel import monte_carlo as tmc
from safe_control_tpu_torch.utils import checkpoint as ckpt
from safe_control_tpu_torch.utils import metrics as metrics_mod

torch.set_num_threads(1)

WAYPOINTS = [[1.0, 7.5], [20.0, 7.5]]
JSPEC = make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, radius=0.3)
JCFG = jt.TrackerConfig(model_name=KINEMATIC_BICYCLE_2D_DPCBF, pos_controller="cbf_qp", dt=0.05,
                        num_obs=8, qp_iters=400)
SPEC = interop.spec_from_jax(JSPEC)
CFG = interop.tracker_config_from_jax(JCFG)


def test_run_sweep_chunk_matches_jax_on_64_starts():
    wj = jnp.asarray(WAYPOINTS, dtype=jnp.float32)
    s0 = jmc.dpcbf_sweep_init(JCFG, JSPEC, jax.random.PRNGKey(0), batch=64, waypoints=wj)
    sj = jax.jit(lambda s: jmc.run_sweep_chunk(JCFG, JSPEC, s, wj, jnp.asarray(2), 20))(s0)
    st0 = interop.sweep_state_from_numpy(s0, device="cpu")
    st = tmc.run_sweep_chunk(CFG, SPEC, st0, torch.tensor(WAYPOINTS), 2, 20)
    np.testing.assert_array_equal(st.tracker.ret.numpy(), np.asarray(sj.tracker.ret))
    assert np.abs(st.tracker.x.numpy() - np.asarray(sj.tracker.x)).max() < 2e-3
    np.testing.assert_allclose(st.obs.numpy(), np.asarray(sj.obs), atol=1e-5)
    assert int(st.steps_done) == int(sj.steps_done) == 20
    for a, b in zip(tmc.sweep_stats(st), jmc.sweep_stats(sj)):
        assert float(a) == float(b)
    assert (st.tracker.ret != 0).any()  # the sample holds a terminal code


def test_sweep_init_draws():
    g = torch.Generator().manual_seed(3)
    a = tmc.dpcbf_sweep_init(CFG, SPEC, g, 16, WAYPOINTS, device="cpu")
    b = tmc.dpcbf_sweep_init(CFG, SPEC, torch.Generator().manual_seed(3), 16, WAYPOINTS,
                             device="cpu")
    assert torch.equal(a.obs, b.obs) and a.obs.shape == (16, 8, 7)
    pos, r, vel = a.obs[..., :2], a.obs[..., 2], a.obs[..., 3:5]
    assert (pos[..., 0] >= 6.0).all() and (pos[..., 0] <= 22.0).all()
    assert (pos[..., 1] >= 1.0).all() and (pos[..., 1] <= 14.0).all()
    spd = torch.linalg.vector_norm(vel, dim=-1)
    assert (spd >= 0.3 - 1e-6).all() and (spd <= 0.8 + 1e-6).all() and (r == 0.5).all()
    assert (a.obs[..., 5:] == 0).all()
    np.testing.assert_array_equal(a.tracker.x[0].numpy(), [1.0, 7.5, 0.0, 1.0])
    assert a.tracker.x.shape == (16, 4) and int(a.steps_done) == 0
    jst = jmc.dpcbf_sweep_init(JCFG, JSPEC, jax.random.PRNGKey(0), batch=2,
                               waypoints=jnp.asarray(WAYPOINTS))
    assert int(a.tracker.mode[0]) == int(jst.tracker.mode[0])
    assert math.isclose(float(a.tracker.yaw[0]), float(jst.tracker.yaw[0]))


def test_checkpoint_resume_bitexact(tmp_path):
    s0 = tmc.dpcbf_sweep_init(CFG, SPEC, torch.Generator().manual_seed(7), 4, WAYPOINTS,
                              device="cpu")
    wps = torch.tensor(WAYPOINTS)
    full = tmc.run_sweep_chunk(CFG, SPEC, s0, wps, 2, 10)
    half = tmc.run_sweep_chunk(CFG, SPEC, s0, wps, 2, 5)
    path = str(tmp_path / "sweep")
    ckpt.save(path, half, step=5)
    assert ckpt.latest_step(path) == 5 and ckpt.latest_step(str(tmp_path / "none")) is None
    restored = ckpt.restore(path, half)
    assert isinstance(restored, tmc.SweepState)
    for a, b in zip(torch.utils._pytree.tree_leaves(restored),
                    torch.utils._pytree.tree_leaves(half)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = tmc.run_sweep_chunk(CFG, SPEC, restored, wps, 2, 5)
    assert torch.equal(resumed.tracker.x, full.tracker.x)
    assert torch.equal(resumed.tracker.ret, full.tracker.ret)
    assert int(resumed.steps_done) == 10
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), half)


def test_metrics_accumulation(tmp_path):
    m = metrics_mod.init_metrics(device="cpu")
    m = metrics_mod.update_metrics(m, h=torch.tensor(0.5), infeasible=torch.tensor(False),
                                   using_backup=torch.tensor(True), replanned=torch.tensor(True),
                                   event=torch.tensor(True))
    m = metrics_mod.update_metrics(m, h=torch.tensor(-0.1), infeasible=torch.tensor(True),
                                   using_backup=torch.tensor(False),
                                   replanned=torch.tensor(False), event=torch.tensor(True))
    s = metrics_mod.summarize(m)
    assert s["h_min"] == np.float32(-0.1)
    assert s["infeasible_steps"] == 1
    assert s["backup_steps"] == 1 and s["nominal_steps"] == 1
    assert s["replans_accepted"] == 1 and s["replans_rejected"] == 1
    path = tmp_path / "log.csv"
    with metrics_mod.CSVLogger(str(path)) as log:
        log.log(torch.tensor([1.0, 2.0]), np.array([0.5]), extras=(0.1, 0.2))
    lines = path.read_text().splitlines()
    assert lines[0] == "states,control_inputs,alpha1,alpha2"
    assert [float(v) for v in lines[1].split(",")] == pytest.approx([1.0, 2.0, 0.5, 0.1, 0.2])


def test_multi_device_pieces_wait_for_a7():
    st = tmc.dpcbf_sweep_init(CFG, SPEC, torch.Generator().manual_seed(0), 2, WAYPOINTS,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        tmc.run_sharded_sweep(None, CFG, SPEC, st, WAYPOINTS, 2, 10)
    with pytest.raises(NotImplementedError, match="A.7"):
        tmc.sweep_stats(st, axis_name="scenario")
    with pytest.raises(NotImplementedError, match="A.7"):
        tmesh.scenario_mesh()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tmc.dpcbf_sweep_init(CFG, SPEC, torch.Generator(), 2, WAYPOINTS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sweep_on_card_is_one_qp_launch_a_step(cuda_device):
    from safe_control_tpu_torch.solvers import qp_kernel as qpk

    st = tmc.dpcbf_sweep_init(CFG, SPEC, torch.Generator().manual_seed(0), 256, WAYPOINTS,
                              device=cuda_device)
    wps = torch.tensor(WAYPOINTS, device=cuda_device)
    before = qpk.LAUNCH_COUNT
    out = tmc.run_sweep_chunk(CFG, SPEC, st, wps, 2, 10)
    torch.cuda.synchronize()
    assert qpk.LAUNCH_COUNT - before == 10
    assert torch.isfinite(out.tracker.x).all()
