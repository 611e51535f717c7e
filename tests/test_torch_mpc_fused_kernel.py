"""The generic fused MPC kernel's CUDA source, built and run on the CPU.

``csrc/mpc_fused_kernel.cu`` is built with g++ under the block emulation of
``cuda_on_cpu`` (every thread of a 128-thread block a fiber,
``__syncthreads`` a barrier over the block, the dynamic shared memory a
buffer of the launch's size filled with NaN bytes) and held to
``solve_fused_batch_reference``, its plain PyTorch version, on the same
float32 inputs with the full 8x3 budget:

- bit for bit at Quad3D N=10 (the fused path's shape, M=40) and N=16
  (M=64, the widest admitted), and at SingleIntegrator2D and
  DoubleIntegrator2D at N=10 and N=9 (M=20 and 18, M=18 an odd number of
  2x2 tiles a side): these use +, -, *, /, sqrt, floor and min/max only,
  which the CPU rounds as the card does once the plain version gets a
  correctly rounded ``torch.sqrt``.  Every shipped model has an even m, so
  no M leaves a tile half outside H;
- within the kernel-class envelope of ``chip_smoke.py``'s phase 10 (max
  |du| and |dxs| < 5e-3, viol atol 1e-3) at DynamicUnicycle2D N=8 and
  VTOL2D N=16, whose ``sinf``/``cosf``/``powf``/``expf``/``atan2f`` come
  from the C library on the CPU and from PyTorch's own kernels in the plain
  version; whether the bits agree is printed.

A tile of H summed in another order, or an entry mirrored to the wrong
place, moves the Quad3D solution by far more than a bit.  The obstacles of
the bit-for-bit cases are circles: a superellipsoid's ``powf`` would round
by the CPU's C library.  On a card ``chip_smoke.py`` (phase 10) and
``fused_kernel_ab.py`` hold the built kernel to the same plain version.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_on_cpu
from safe_control_tpu_torch import entry
from safe_control_tpu_torch.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    QUAD_3D,
    SINGLE_INTEGRATOR_2D,
    VTOL_2D,
    make_spec,
)
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.solvers import mpc_cbf
from safe_control_tpu_torch.solvers import mpc_fused as mf

torch.set_num_threads(1)

CSRC = Path(mf.__file__).resolve().parent.parent / "csrc"
U_TOL = 5e-3  # chip_smoke.py's phase 10 envelope
VIOL_TOL = 1e-3


@pytest.fixture(scope="module")
def cpu_lib(tmp_path_factory):
    """``csrc/mpc_fused_kernel.cu`` built for the CPU under the block emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    lib = cuda_on_cpu.build(CSRC / "mpc_fused_kernel.cu", tmp_path_factory.mktemp("fused_cpu"))
    lib.mpc_fused_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mpc_fused_launch.restype = ctypes.c_int
    lib.mpc_fused_shared_bytes.argtypes = [ctypes.c_int] * 5
    lib.mpc_fused_shared_bytes.restype = ctypes.c_int
    return lib


def launch(lib, model_name, spec, args, cfg):
    """One launch of the CPU build as ``solve_fused_batch`` makes it on a
    card; (U (B, N, m), xs (B, N+1, n), viol (B,))."""
    pb = mf._problem(model_name, spec, cfg)
    B, M = args[0].shape[0], pb.N * pb.m
    params = torch.tensor(mf.kernel_params(model_name, spec, entry.DT, cfg), dtype=torch.float32)
    U0 = mf._warm_start(args[4]).reshape(B, M).contiguous()
    U = torch.full((B, M), float("nan"))
    xs = torch.full((B, (pb.N + 1) * pb.n), float("nan"))
    viol = torch.full((B,), float("nan"))
    err = lib.mpc_fused_launch(
        mf.MODEL_IDS[model_name], *(t.contiguous().data_ptr() for t in args[:4]),
        U0.data_ptr(), params.data_ptr(), U.data_ptr(), xs.data_ptr(), viol.data_ptr(), B,
        pb.N, pb.K, len(pb.bounded), params.numel(), cfg.outer_iters, cfg.newton_iters, None)
    assert err == 0
    return U.reshape(B, pb.N, pb.m), xs.reshape(B, pb.N + 1, pb.n), viol


def integrator_problems(model_name, N, B, obstacles, seed=11):
    """Starts in [0, 3]^2 (velocities in [-0.5, 0.5]), goal (5, 1)."""
    nx = 2 if model_name == SINGLE_INTEGRATOR_2D else 4
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(0, 3, (B, 2)), rng.uniform(-0.5, 0.5, (B, nx - 2))], axis=1)
    goals = np.zeros((B, nx))
    goals[:, :2] = [5.0, 1.0]
    obs = pad_obstacles(obstacles, 5)[None].repeat(B, 1, 1)
    return (torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(goals, dtype=torch.float32),
            obs, torch.zeros((B, 2)), torch.zeros((B, N, 2)))


def vtol_problems(B, seed=11):
    """chip_smoke.py's phase 10c starts: cruise at 10-13 m/s near (7, 38)."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(5, 10, (B, 1)), rng.uniform(36, 40, (B, 1)),
                         rng.uniform(-0.1, 0.1, (B, 1)), rng.uniform(10, 13, (B, 1)),
                         rng.uniform(-0.5, 0.5, (B, 1)), np.zeros((B, 1))], axis=1)
    goals = torch.tensor([80.0, 40.0, 0, 0, 0, 0]).repeat(B, 1)
    obs = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5)[None].repeat(B, 1, 1)
    return (torch.as_tensor(xs, dtype=torch.float32), goals, obs, torch.zeros((B, 4)),
            torch.zeros((B, 16, 4)))


CIRCLES = [[2.5, 0.8, 0.4, 0, 0, 0, 0], [4.0, -0.4, 0.6, 0, 0, 0, 0]]


@pytest.mark.parametrize("model_name,N", [
    (QUAD_3D, 10),
    (QUAD_3D, 16),  # M=64, the widest admitted: 528 tiles and 64 grad entries on 128 threads
    (SINGLE_INTEGRATOR_2D, 10),
    (DOUBLE_INTEGRATOR_2D, 10),
    (DOUBLE_INTEGRATOR_2D, 9),
])
def test_cuda_source_on_the_cpu_is_bit_identical_to_plain_version(cpu_lib, monkeypatch,
                                                                  model_name, N):
    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=N, num_obs=5)
    if model_name == QUAD_3D:
        args = entry.build_fused_step(3 if N == 10 else 2, horizon=N, device="cpu")[1]
    else:
        args = integrator_problems(model_name, N, 3, CIRCLES)
    U, xs, viol = launch(cpu_lib, model_name, spec, args, cfg)
    plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    assert torch.isfinite(plain.U).all() and (plain.U != args[4]).any()  # the solve moved U
    assert torch.equal(U, plain.U)
    assert torch.equal(xs, plain.xs)
    assert torch.equal(viol, plain.viol)


@pytest.mark.parametrize("model_name,B", [(DYNAMIC_UNICYCLE_2D, 3), (VTOL_2D, 16)])
def test_cuda_source_on_the_cpu_matches_plain_version_in_envelope(cpu_lib, monkeypatch,
                                                                  model_name, B):
    """DU N=8 within the envelope on every problem.  VTOL2D's phase 10c
    starts are constraint-stressed (viol 0.02-0.7 after the solve), and
    there the C library's rounding of the aero model moves a few solutions
    far (up to 0.84 in u on 3 of 16 starts; the first port's source under
    the same emulation gives the same bits as this one): every problem
    finite, and three in four within the envelope."""
    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
    if model_name == DYNAMIC_UNICYCLE_2D:
        spec = make_spec(model_name, a_max=1.0, w_max=0.5)
        cfg = mpc_cbf.MPCConfig(horizon=8, num_obs=5)
        args = entry.build_step(B, device="cpu")[1]  # a circle and a superellipsoid row
    else:
        spec = make_spec(model_name)
        cfg = mpc_cbf.MPCConfig(horizon=16, num_obs=5)
        args = vtol_problems(B)
    U, xs, viol = launch(cpu_lib, model_name, spec, args, cfg)
    plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    du = (U - plain.U).abs().amax((1, 2))
    dxs = (xs - plain.xs).abs().amax((1, 2))
    dv = (viol - plain.viol).abs()
    within = (du < U_TOL) & (dxs < U_TOL) & (dv <= VIOL_TOL)
    same = torch.equal(U, plain.U) and torch.equal(xs, plain.xs) and torch.equal(viol, plain.viol)
    print(f"{model_name}: max|du| per problem {du.tolist()}, max|dviol| {dv.max().item():.3e}, "
          f"{int(within.sum())}/{B} within the envelope, bit-identical {same}")
    assert torch.isfinite(U).all() and torch.isfinite(xs).all() and torch.isfinite(viol).all()
    if model_name == DYNAMIC_UNICYCLE_2D:
        assert within.all()
    else:
        assert 4 * int(within.sum()) >= 3 * B


def test_shared_memory_layout(cpu_lib):
    """Jr and Jc share their space with L and the line search's arrays: at
    Quad3D N=10 five blocks fit an SM's 228 KB (1 KB of it reserved a
    block), at VTOL2D N=16 two; the first port's layout took 58,232 and
    136,996 bytes."""
    sm_bytes, reserved = 233_472, 1_024
    sizes = {}
    for model_name, N in ((QUAD_3D, 10), (VTOL_2D, 16)):
        spec, cfg = make_spec(model_name), mpc_cbf.MPCConfig(horizon=N, num_obs=5)
        sizes[model_name] = cpu_lib.mpc_fused_shared_bytes(
            *mf._shape_args(model_name, spec, entry.DT, cfg))
    assert sizes == {QUAD_3D: 44_872, VTOL_2D: 111_012}
    assert sm_bytes // (sizes[QUAD_3D] + reserved) == 5
    assert sm_bytes // (sizes[VTOL_2D] + reserved) == 2
    assert cpu_lib.mpc_fused_threads() == 128


def test_parameter_block_is_made_once_per_values_and_device(monkeypatch):
    monkeypatch.setattr(mf, "_DEVICE_PARAMS", {})
    monkeypatch.setattr(mf, "_DEVICE_PARAMS_MAX", 2)
    cpu = torch.device("cpu")
    a = mf._device_params([1.0, 2.5], cpu)
    assert a.dtype == torch.float32 and a.tolist() == [1.0, 2.5]
    assert mf._device_params([1.0, 2.5], cpu) is a
    b = mf._device_params([1.0, 3.5], cpu)
    assert b is not a and mf._device_params([1.0, 3.5], cpu) is b
    mf._device_params([0.0], cpu)  # a third: the oldest goes
    assert list(mf._DEVICE_PARAMS) == [((1.0, 3.5), cpu), ((0.0,), cpu)]
    assert mf._device_params([1.0, 2.5], cpu) is not a
