"""The generic fused MPC kernel's CUDA source, built and run on the CPU.

``csrc/mpc_fused_kernel.cu`` is built with g++ under the block emulation of
``cuda_on_cpu`` (every thread of a block a fiber: one warp at M <= 32, 128
threads above; ``__syncthreads`` a barrier over the block, the dynamic
shared memory a buffer of the launch's size filled with NaN bytes) and held
to ``solve_fused_batch_reference``, its plain PyTorch version, on the same
float32 inputs with the full 8x3 budget:

- bit for bit at Quad3D N=10 (the fused path's shape, M=40) and N=16
  (M=64, the widest admitted), and at SingleIntegrator2D and
  DoubleIntegrator2D at N=10 and N=9 (M=20 and 18, M=18 an odd number of
  2x2 tiles a side): these use +, -, *, /, sqrt, floor and min/max only,
  which the CPU rounds as the card does once the plain version gets a
  correctly rounded ``torch.sqrt``.  Every shipped model has an even m, so
  no M leaves a tile half outside H;
- bit for bit beyond a block's shared memory, at the RTI budget: Quad3D
  N=30 (M=120; Jr, Jc and the arrays that reuse Jr's space in the global
  workspace) and, with the IEEE build below, VTOL2D N=30 (Jc alone there)
  and DynamicUnicycle2D N=64 (M=128, the widest); the workspace is filled
  with NaN bytes as shared memory is;
- within the kernel-class envelope of ``chip_smoke.py``'s phase 10 (max
  |du| and |dxs| < 5e-3, viol atol 1e-3) at DynamicUnicycle2D N=8 and
  VTOL2D N=16, whose ``sinf``/``cosf``/``powf``/``expf``/``atan2f`` come
  from the C library on the CPU and from PyTorch's own kernels in the plain
  version; whether the bits agree is printed.

A build with ``cuda_on_cpu``'s IEEE math (sinf, cosf, expf and atan2f the
float64 functions rounded once, the plain version patched alike) is bit for
bit the plain version at every other instantiation: DynamicUnicycle2D N=8,
VTOL2D N=16 (B=16, the constraint-stressed starts), and at N=10
Unicycle2D, KinematicBicycle2D, its C3BF and DPCBF variants (moving
obstacles), Quad2D and Manipulator2D (unit cost weights: the package has
none for it); and on the two edge cases of the bicycles: a speed at v_max
with a = 0 (the clip's tie) and a robot at rest, whose C3BF / DPCBF
solution is NaN in the plain version and in the kernel alike.

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


def _build(tmp_path_factory, ieee_math, source="mpc_fused_kernel.cu"):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    lib = cuda_on_cpu.build(CSRC / source, tmp_path_factory.mktemp("fused_cpu"),
                            ieee_math=ieee_math)
    lib.mpc_fused_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mpc_fused_launch.restype = ctypes.c_int
    for fn in (lib.mpc_fused_shared_bytes, lib.mpc_fused_workspace_floats,
               lib.mpc_fused_block_threads):
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    lib.emu_block_threads.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def cpu_lib(tmp_path_factory):
    """``csrc/mpc_fused_kernel.cu`` built for the CPU under the block emulation."""
    return _build(tmp_path_factory, ieee_math=False)


@pytest.fixture(scope="module")
def clock_lib(tmp_path_factory):
    """``csrc/mpc_fused_clock.cu``, the instantiations with the phase clock,
    built for the CPU under the block emulation."""
    return _build(tmp_path_factory, ieee_math=False, source="mpc_fused_clock.cu")


@pytest.fixture(scope="module")
def ieee_lib(tmp_path_factory):
    """The same source built with ``cuda_on_cpu``'s IEEE math."""
    return _build(tmp_path_factory, ieee_math=True)


def launch(lib, model_name, spec, args, cfg, clock=None):
    """One launch of the CPU build as ``solve_fused_batch`` makes it on a
    card, the workspace of a wide layout filled with NaN bytes as the
    emulation fills shared memory; (U (B, N, m), xs (B, N+1, n), viol (B,)).
    ``clock``: the phase clock's totals (a tensor), or none."""
    pb = mf._problem(model_name, spec, cfg)
    B, M = args[0].shape[0], pb.N * pb.m
    params = torch.tensor(mf.kernel_params(model_name, spec, entry.DT, cfg), dtype=torch.float32)
    U0 = mf._warm_start(args[4]).reshape(B, M).contiguous()
    U = torch.full((B, M), float("nan"))
    xs = torch.full((B, (pb.N + 1) * pb.n), float("nan"))
    viol = torch.full((B,), float("nan"))
    ws_floats = lib.mpc_fused_workspace_floats(*mf._shape_args(model_name, spec, entry.DT, cfg))
    ws = torch.full((B * ws_floats,), -1, dtype=torch.int32).view(torch.float32)  # NaN bytes
    err = lib.mpc_fused_launch(
        mf.MODEL_IDS[model_name], *(t.contiguous().data_ptr() for t in args[:4]),
        U0.data_ptr(), params.data_ptr(), U.data_ptr(), xs.data_ptr(), viol.data_ptr(),
        ws.data_ptr() if ws_floats else None,
        None if clock is None else clock.data_ptr(), B, pb.N, pb.K, len(pb.bounded),
        params.numel(), cfg.outer_iters, cfg.newton_iters, None)
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


def vtol_problems(B, seed=11, N=16):
    """chip_smoke.py's phase 10c starts: cruise at 10-13 m/s near (7, 38)."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(5, 10, (B, 1)), rng.uniform(36, 40, (B, 1)),
                         rng.uniform(-0.1, 0.1, (B, 1)), rng.uniform(10, 13, (B, 1)),
                         rng.uniform(-0.5, 0.5, (B, 1)), np.zeros((B, 1))], axis=1)
    goals = torch.tensor([80.0, 40.0, 0, 0, 0, 0]).repeat(B, 1)
    obs = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5)[None].repeat(B, 1, 1)
    return (torch.as_tensor(xs, dtype=torch.float32), goals, obs, torch.zeros((B, 4)),
            torch.zeros((B, N, 4)))


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
    assert cpu_lib.emu_block_threads() == (32 if U[0].numel() <= 32 else 128)
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
    136,996 bytes.  An obstacle takes 12 floats (the moving circle's
    velocity and r + radius among them).  Neither needs a workspace.

    VTOL2D N=30 (M=120, NR=300, NC=330) would take 375,728 bytes, above a
    block's 232,448: its scaled Jc (M NC floats) goes to the workspace and
    the rest, Jr's 144,000 bytes among it, stays in shared memory, one block
    an SM.  At Quad3D N=30 (NR=480) that is still too large, and Jr with
    the arrays that reuse its space goes there too."""
    sm_bytes, reserved, block_max = 233_472, 1_024, 232_448
    sizes, ws = {}, {}
    for model_name, N in ((QUAD_3D, 10), (VTOL_2D, 16), (VTOL_2D, 30), (QUAD_3D, 30)):
        spec, cfg = make_spec(model_name), mpc_cbf.MPCConfig(horizon=N, num_obs=5)
        shape = mf._shape_args(model_name, spec, entry.DT, cfg)
        sizes[model_name, N] = cpu_lib.mpc_fused_shared_bytes(*shape)
        ws[model_name, N] = cpu_lib.mpc_fused_workspace_floats(*shape)
    assert (sizes[QUAD_3D, 10], sizes[VTOL_2D, 16]) == (44_932, 111_072)
    assert ws[QUAD_3D, 10] == ws[VTOL_2D, 16] == 0
    assert sm_bytes // (sizes[QUAD_3D, 10] + reserved) == 5
    assert sm_bytes // (sizes[VTOL_2D, 16] + reserved) == 2
    assert sizes[VTOL_2D, 30] == 375_728 - 120 * 330 * 4 == 217_328
    assert ws[VTOL_2D, 30] == 120 * 330
    assert sm_bytes // (sizes[VTOL_2D, 30] + reserved) == 1
    NR, NC = 30 * 16, 30 * 5  # Quad3D: no bounded state
    assert ws[QUAD_3D, 30] == 120 * (NR + NC)
    assert sizes[QUAD_3D, 30] <= block_max and sizes[VTOL_2D, 30] <= block_max
    assert cpu_lib.mpc_fused_threads() == 128


@pytest.mark.parametrize("model_name,N,threads", [
    (DYNAMIC_UNICYCLE_2D, 10, 32),  # M=20, the benchmark cells' shape
    (DYNAMIC_UNICYCLE_2D, 16, 32),  # M=32, the widest in one warp
    (DYNAMIC_UNICYCLE_2D, 17, 128),  # M=34
    (QUAD_3D, 10, 128),  # M=40
    (VTOL_2D, 30, 128),  # M=120, the wide layout
])
def test_block_is_one_warp_up_to_a_decision_width_of_32(cpu_lib, model_name, N, threads):
    """The launch's threads a block follow the decision width alone: one
    warp at M <= 32, 128 threads above it and in the wide layout; 128 stays
    the width limit."""
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=N, num_obs=5)
    shape = mf._shape_args(model_name, spec, entry.DT, cfg)
    assert cpu_lib.mpc_fused_block_threads(*shape) == threads
    assert (cpu_lib.mpc_fused_workspace_floats(*shape) > 0) == (model_name == VTOL_2D)
    assert cpu_lib.mpc_fused_threads() == 128


def test_benchmark_cells_shape_in_one_warp_is_bit_identical(ieee_lib, monkeypatch):
    """DynamicUnicycle2D N=10, K=5, one bound row (the speed), as the
    benchmark cells run it (M=20, NR=60, NC=70): one-warp blocks, and the
    plain version's bits; its layout lets 14 blocks into an SM's 228 KB (1 KB
    of it reserved a block)."""
    cuda_on_cpu.ieee_math(monkeypatch)
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    pb = mf._problem(DYNAMIC_UNICYCLE_2D, spec, cfg)
    assert (pb.N * pb.m, pb.N * (pb.n + pb.m), pb.N * (pb.K + 2 * len(pb.bounded))) == (20, 60, 70)
    shape = mf._shape_args(DYNAMIC_UNICYCLE_2D, spec, entry.DT, cfg)
    smem = ieee_lib.mpc_fused_shared_bytes(*shape)
    assert smem == 15_224 and 233_472 // (smem + 1_024) == 14
    args = entry.build_fused_step(4, model_name=DYNAMIC_UNICYCLE_2D, horizon=10, device="cpu")[1]
    U, xs, viol = launch(ieee_lib, DYNAMIC_UNICYCLE_2D, spec, args, cfg)
    assert ieee_lib.emu_block_threads() == 32
    plain = mf.solve_fused_batch_reference(DYNAMIC_UNICYCLE_2D, spec, *args, entry.DT, cfg)
    assert torch.isfinite(plain.U).all() and (plain.U != args[4]).any()
    assert torch.equal(U, plain.U)
    assert torch.equal(xs, plain.xs)
    assert torch.equal(viol, plain.viol)


@pytest.mark.parametrize("model_name,N,narrow", [
    (DYNAMIC_UNICYCLE_2D, 10, True),
    (QUAD_3D, 10, False),
])
def test_narrow_launch_count_counts_one_warp_launches(cpu_lib, monkeypatch, model_name, N,
                                                      narrow):
    """Each launch adds one to ``LAUNCH_COUNT``, and one to
    ``NARROW_LAUNCH_COUNT`` where the kernel runs it in one warp (M <= 32)."""
    monkeypatch.setattr(mf, "LAUNCH_COUNT", 0)
    monkeypatch.setattr(mf, "NARROW_LAUNCH_COUNT", 0)
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=N, num_obs=5)
    shape = mf._shape_args(model_name, spec, entry.DT, cfg)
    for i in range(1, 3):
        mf._count_launch(cpu_lib, shape)
        assert (mf.LAUNCH_COUNT, mf.NARROW_LAUNCH_COUNT) == (i, i if narrow else 0)


@pytest.mark.parametrize("model_name,N,lib_name", [
    (QUAD_3D, 30, "cpu_lib"),  # M=120: Jr, Jc, L, the candidates and their rows in the workspace
    (VTOL_2D, 30, "ieee_lib"),  # M=120: Jc alone there
    (DYNAMIC_UNICYCLE_2D, 64, "ieee_lib"),  # M=128, every thread a variable: both there
])
def test_wide_layout_is_bit_identical_to_plain_version(request, monkeypatch, model_name, N,
                                                       lib_name):
    """Past a block's shared memory, at the RTI budget, B=2.  The workspace
    starts as NaN bytes, so a read of a workspace entry before its write
    shows."""
    lib = request.getfixturevalue(lib_name)
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig.rti(horizon=N, num_obs=5)
    if model_name == QUAD_3D:
        monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
        args = entry.build_fused_step(2, horizon=N, device="cpu")[1]
    elif model_name == VTOL_2D:
        cuda_on_cpu.ieee_math(monkeypatch)
        args = vtol_problems(2, N=N)
    else:
        cuda_on_cpu.ieee_math(monkeypatch)
        spec = make_spec(model_name, a_max=1.0, w_max=0.5)
        args = entry.build_fused_step(2, model_name=model_name, horizon=N, device="cpu")[1]
    shape = mf._shape_args(model_name, spec, entry.DT, cfg)
    pb = mf._problem(model_name, spec, cfg)
    M, NR, NC = N * pb.m, N * (pb.n + pb.m), N * (pb.K + 2 * len(pb.bounded))
    want = M * NC if model_name == VTOL_2D else M * (NR + NC)
    assert lib.mpc_fused_workspace_floats(*shape) == want
    U, xs, viol = launch(lib, model_name, spec, args, cfg)
    plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    assert torch.isfinite(plain.U).all() and (plain.U != args[4]).any()
    assert torch.equal(U, plain.U)
    assert torch.equal(xs, plain.xs)
    assert torch.equal(viol, plain.viol)


def test_launch_refuses_a_missing_workspace_and_a_width_past_a_block(cpu_lib):
    """A wide layout without its workspace, and M=132 (more variables than
    threads), return cudaErrorInvalidValue (1) and write nothing."""
    for N in (30, 33):
        spec, cfg = make_spec(QUAD_3D), mpc_cbf.MPCConfig.rti(horizon=N, num_obs=5)
        args = entry.build_fused_step(1, horizon=N, device="cpu")[1]
        pb = mf._problem(QUAD_3D, spec, cfg)
        params = torch.tensor(mf.kernel_params(QUAD_3D, spec, entry.DT, cfg))
        U = torch.full((1, N * pb.m), float("nan"))
        ws = torch.full((120 * 1000,), float("nan"))
        err = cpu_lib.mpc_fused_launch(
            mf.MODEL_IDS[QUAD_3D], *(t.contiguous().data_ptr() for t in args[:4]),
            args[4].contiguous().data_ptr(), params.data_ptr(), U.data_ptr(), U.data_ptr(),
            U.data_ptr(), None if N == 30 else ws.data_ptr(), None, 1, N, pb.K,
            len(pb.bounded), params.numel(), cfg.outer_iters, cfg.newton_iters, None)
        assert err == 1
        assert torch.isnan(U).all()


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


def _same(a, b):
    """Equal bits, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))


@pytest.mark.parametrize("model_name,N", [
    (DYNAMIC_UNICYCLE_2D, 8),
    (VTOL_2D, 16),
    ("Unicycle2D", 10),
    ("KinematicBicycle2D", 10),
    ("KinematicBicycle2D_C3BF", 10),
    ("KinematicBicycle2D_DPCBF", 10),
    ("Quad2D", 10),
    ("Manipulator2D", 10),
])
def test_cuda_source_with_ieee_math_is_bit_identical_to_plain_version(ieee_lib, monkeypatch,
                                                                      model_name, N):
    cuda_on_cpu.ieee_math(monkeypatch)
    monkeypatch.setitem(mpc_cbf._WEIGHTS, "Manipulator2D", ([1.0] * 3, [0.5] * 3))
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=N, num_obs=5)
    if model_name == DYNAMIC_UNICYCLE_2D:
        spec = make_spec(model_name, a_max=1.0, w_max=0.5)
        args = entry.build_step(3, device="cpu")[1]
    elif model_name == VTOL_2D:
        args = vtol_problems(16)
    else:
        args = entry.build_fused_step(3, model_name=model_name, horizon=N, device="cpu")[1]
    U, xs, viol = launch(ieee_lib, model_name, spec, args, cfg)
    plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    assert torch.isfinite(plain.U).all() and (plain.U != args[4]).any()
    assert torch.equal(U, plain.U)
    assert torch.equal(xs, plain.xs)
    assert torch.equal(viol, plain.viol)


@pytest.mark.parametrize("model_name", ["KinematicBicycle2D", "KinematicBicycle2D_C3BF",
                                        "KinematicBicycle2D_DPCBF"])
def test_cuda_source_on_bicycle_edge_cases_is_bit_identical(ieee_lib, monkeypatch, model_name):
    """Robot 0 cruises at v_max with a cold warm start (a = 0: the speed
    clip's tie), robot 1 is at rest (C3BF / DPCBF: v_rel = 0 against the
    static dummies, NaN in the plain version)."""
    cuda_on_cpu.ieee_math(monkeypatch)
    spec = make_spec(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=6, num_obs=5)
    args = list(entry.build_fused_step(3, model_name=model_name, horizon=6, device="cpu")[1])
    args[0] = args[0].clone()
    args[0][0, 3] = spec.v_max
    args[0][1, 3] = 0.0
    U, xs, viol = launch(ieee_lib, model_name, spec, args, cfg)
    plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    assert _same(U, plain.U) and _same(xs, plain.xs) and _same(viol, plain.viol)
    nan_rows = torch.isnan(plain.U).flatten(1).any(1).tolist()
    assert nan_rows == [False, model_name != "KinematicBicycle2D", False]


class ActiveRows(torch.overrides.TorchFunctionMode):
    """Per problem, the constraint rows that enter H in the plain version's
    Newton steps: the true entries of its tests ``act0 > 0.0`` on the
    (B, NC) activations, summed over the steps."""

    def __init__(self, nc):
        super().__init__()
        self.nc, self.rows = nc, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in (torch.Tensor.gt, torch.Tensor.__gt__) and len(args) == 2
                and isinstance(args[1], float) and args[1] == 0.0 and args[0].ndim == 2
                and args[0].shape[-1] == self.nc):
            self.rows = self.rows + out.sum(-1)
        return out


@pytest.mark.parametrize("model_name,N", [
    (DOUBLE_INTEGRATOR_2D, 10),  # the shared layout
    (QUAD_3D, 30),  # Jr and Jc in the workspace
])
def test_phase_clock_keeps_the_bits_and_counts_each_block(cpu_lib, clock_lib, monkeypatch,
                                                          model_name, N):
    """DoubleIntegrator2D near two circles at the full 8x3 budget (N=10,
    B=3; M=20, a one-warp block) and Quad3D at the RTI budget past a block's
    shared memory (N=30, B=2; 128 threads), launched with the clock's library
    and with the plain one: the same
    bits as the plain version each time.  Only the clock's library writes the
    totals: one slot a problem, whose ten phase totals add up to the block's
    cycles exactly, each Newton-step phase entered outer x newton times, and
    whose active rows are those the plain version forms (155 on the second
    double integrator, 48 and 30 on the quadrotors)."""
    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
    spec = make_spec(model_name)
    if model_name == DOUBLE_INTEGRATOR_2D:
        B, cfg = 3, mpc_cbf.MPCConfig(horizon=N, num_obs=5)
        args = integrator_problems(model_name, N, B, CIRCLES)
    else:
        B, cfg = 2, mpc_cbf.MPCConfig.rti(horizon=N, num_obs=5)
        args = entry.build_fused_step(B, horizon=N, device="cpu")[1]
    k = len(mf.PHASES)
    fields, slots = clock_lib.mpc_fused_trace_fields(), clock_lib.mpc_fused_trace_slots()
    assert fields == 2 * k + 2 and slots >= 4096
    totals = torch.zeros((slots, fields), dtype=torch.int64)
    on = launch(clock_lib, model_name, spec, args, cfg, totals)
    assert clock_lib.emu_block_threads() == (32 if model_name == DOUBLE_INTEGRATOR_2D else 128)
    after_on = totals.clone()
    off = launch(cpu_lib, model_name, spec, args, cfg)
    assert torch.equal(totals, after_on)
    pb = mf._problem(model_name, spec, cfg)
    with ActiveRows(pb.N * pb.K + 2 * pb.N * len(pb.bounded)) as rows:
        plain = mf.solve_fused_batch_reference(model_name, spec, *args, entry.DT, cfg)
    assert (plain.U != args[4]).any()
    for outs in (off, on):
        for got, want in zip(outs, (plain.U, plain.xs, plain.viol)):
            assert torch.equal(got, want)
    assert not totals[B:].any()
    t = totals[:B]
    cycles, entries, total = t[:, :k], t[:, k:2 * k], t[:, 2 * k + 1]
    assert (cycles >= 0).all() and (total > 0).all()
    assert torch.equal(cycles.sum(1), total)
    steps = cfg.outer_iters * cfg.newton_iters
    for i, phase in enumerate(mf.PHASES):
        want = {"prologue": 1, "multipliers": cfg.outer_iters, "epilogue": 1}.get(phase, steps)
        assert (entries[:, i] == want).all(), phase
    assert rows.rows.sum() > 0
    assert torch.equal(t[:, 2 * k], rows.rows)


def test_each_library_refuses_the_others_clock_argument(cpu_lib, clock_lib):
    """The plain library takes no clock buffer and the clock's library needs
    one: either launch fails with cudaErrorInvalidValue and writes nothing."""
    spec, cfg = make_spec(QUAD_3D), mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    args = entry.build_fused_step(1, horizon=10, device="cpu")[1]
    pb = mf._problem(QUAD_3D, spec, cfg)
    params = torch.tensor(mf.kernel_params(QUAD_3D, spec, entry.DT, cfg))
    totals = torch.zeros((clock_lib.mpc_fused_trace_slots(), clock_lib.mpc_fused_trace_fields()),
                         dtype=torch.int64)
    for lib, trace in ((cpu_lib, totals.data_ptr()), (clock_lib, None)):
        U = torch.full((1, 10 * pb.m), float("nan"))
        err = lib.mpc_fused_launch(
            mf.MODEL_IDS[QUAD_3D], *(t.contiguous().data_ptr() for t in args[:4]),
            args[4].contiguous().data_ptr(), params.data_ptr(), U.data_ptr(), U.data_ptr(),
            U.data_ptr(), None, trace, 1, 10, pb.K, len(pb.bounded), params.numel(),
            cfg.outer_iters, cfg.newton_iters, None)
        assert err == 1
        assert torch.isnan(U).all() and not totals.any()
