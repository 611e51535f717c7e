"""The QP kernels' module: its plain PyTorch versions, wrapper and sources.

On the CPU the wrapper ``solve_qp_batch`` runs ``solve_qp_batch_reference``,
the plain PyTorch version of ``csrc/qp_admm_kernel.cu`` (the same
operations in the same order) and of ``csrc/qp_finish_kernel.cu``
(``_finish_plain``).  It is held against the JAX
``solve_qp_batch_pallas`` run in Pallas interpret mode, as the JAX
package's own tests run it (``tests/test_qp_kernel.py``), at the full
1600-iteration budget: |dx| < 1e-3 on problems both solve (two float32
solves of one problem by different operation orders); and against the
analytic optima at 1e-5.  Both CUDA sources are built for the CPU under
the warp emulation of ``cuda_on_cpu`` and held to their plain versions
bit for bit, and the wrapper's CUDA path runs on the CPU through those
builds; ``_finish_plain`` is held against ``qp.finish``.  On a card the
``gpu``-marked tests and ``chip_smoke.py`` check the kernels.  On a
machine without JAX run those with ``--noconftest``.
"""

import contextlib
import ctypes
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_on_cpu
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.solvers import qp as tqp
from safe_control_tpu_torch.solvers import qp_kernel as qpk

torch.set_num_threads(1)

CSRC = Path(qpk.__file__).resolve().parent.parent / "csrc"


def random_qps(seed, B, n, m, one_sided=3):
    """Random QPs (some infeasible), the JAX kernel test's construction."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    c = rng.normal(size=(B, m))
    l = c - rng.uniform(0.1, 2.0, size=(B, m))
    u = c + rng.uniform(0.1, 2.0, size=(B, m))
    u[:, :one_sided] = np.inf
    return [a.astype(np.float32) for a in (P, q, A, l, u)]


def cbf_qps(B=8, seed=5):
    """CBF-QP-shaped problems: n=2, 3 CBF rows, 2 inert dummy rows, a box."""
    rng = np.random.default_rng(seed)
    a_rows = rng.normal(size=(B, 5, 2))
    a_rows[:, 3:] = 0.0
    b = rng.normal(size=(B, 5)) * 0.5
    b[:, 3:] = 1.0
    A = np.concatenate([a_rows, np.tile(np.eye(2), (B, 1, 1))], axis=1)
    l = np.concatenate([-b, -np.ones((B, 2))], axis=1)
    u = np.concatenate([np.full((B, 5), np.inf), np.ones((B, 2))], axis=1)
    P = np.tile(2.0 * np.eye(2), (B, 1, 1))
    q = -2.0 * rng.uniform(-1.5, 1.5, (B, 2))
    return [a.astype(np.float32) for a in (P, q, A, l, u)]


@pytest.mark.parametrize("case", ["random", "cbf"])
def test_reference_matches_jax_pallas_kernel(case):
    # JAX is imported here, not at the top, so that this file also collects
    # on a machine without JAX, where the gpu-marked test runs.
    import jax.numpy as jnp

    from safe_control_tpu.solvers.qp_kernel import solve_qp_batch_pallas

    qps = random_qps(0, 8, 3, 10) if case == "random" else cbf_qps()
    want = solve_qp_batch_pallas(*(jnp.asarray(a) for a in qps), iters=1600, interpret=True)
    want = [np.asarray(t) for t in want]
    before = qpk.LAUNCH_COUNT
    got = qpk.solve_qp_batch(*interop.qp_from_numpy(*qps))  # CPU: the plain version
    assert qpk.LAUNCH_COUNT == before
    for g, w in zip(got, want):
        assert g.shape == w.shape
    ok = (want[2] < 1e-4) & (got.prim_res.numpy() < 1e-4)
    assert ok.sum() >= 4
    assert np.abs(got.x.numpy() - want[0])[ok].max() < 1e-3
    np.testing.assert_array_equal(got.prim_res.numpy() < 1e-3, want[2] < 1e-3)
    ref = qpk.solve_qp_batch_reference(*interop.qp_from_numpy(*qps))
    assert torch.equal(got.x, ref.x) and torch.equal(got.y, ref.y)


def test_reference_matches_general_solve_qp():
    """Kernel rho rule vs the general one: the same solution where both solve."""
    P, q, A, l, u = random_qps(3, 16, 4, 12)
    Ax = np.einsum("bmn,bn->bm", A, np.random.default_rng(4).normal(size=(16, 4)))
    l, u = Ax - (u - l) / 2, Ax + (u - l) / 2  # feasible: the bounds bracket A x_star
    u[:, :3] = np.inf
    qps = interop.qp_from_numpy(P, q, A, l, u)
    k = qpk.solve_qp_batch_reference(*qps, iters=800)
    g = tqp.solve_qp(*qps, iters=800)
    ok = (k.prim_res < 1e-4) & (g.prim_res < 1e-4)
    assert ok.sum() >= 8
    assert (k.x - g.x).abs()[ok].max() < 1e-3


def test_analytic_projection_and_active_inequality():
    # min ||x - t||^2 s.t. x in [-1, 1]^2  =>  clamp(t)
    t = torch.tensor([[2.0, 0.3], [-3.0, 0.0], [0.5, -0.2], [9.0, -9.0]])
    eye = torch.eye(2).expand(4, 2, 2)
    sol = qpk.solve_qp_batch(2.0 * eye, -2.0 * t, eye, -torch.ones(4, 2), torch.ones(4, 2),
                             iters=200)
    np.testing.assert_allclose(sol.x.numpy(), np.clip(t.numpy(), -1, 1), atol=1e-5)
    # min ||u||^2 s.t. a'u >= b, b > 0:  u = a b / |a|^2
    a = torch.tensor([[1.0, 2.0]])
    sol = qpk.solve_qp_batch(2.0 * torch.eye(2)[None], torch.zeros((1, 2)), a[:, None, :],
                             torch.full((1, 1), 3.0), torch.full((1, 1), float("inf")), iters=300)
    np.testing.assert_allclose(sol.x[0].numpy(), a[0].numpy() * 3.0 / 5.0, atol=1e-5)
    assert sol.prim_res[0] < 1e-5


def test_stage_remainder_is_dropped():
    """per_stage = max(iters // 8, 1): 1607 iterations run as 1600, and fewer
    than 8 as one sweep a stage."""
    qps = interop.qp_from_numpy(*cbf_qps(4))
    assert torch.equal(qpk.solve_qp_batch(*qps, iters=1607).x, qpk.solve_qp_batch(*qps).x)
    assert torch.equal(qpk.solve_qp_batch(*qps, iters=3).x, qpk.solve_qp_batch(*qps, iters=8).x)


def test_clip_on_infinite_and_inert_bounds():
    """The kernel clips with fminf(fmaxf(v, lo), hi); on the CBF rows' +inf
    upper bounds, the -inf of free rows and the -1e6 of inert rows after
    equilibration that is what torch.clamp gives."""
    v = torch.tensor([-2e6, -1e6, -3.0, 0.0, 2.5, 1e6, 3e7, float("inf"), float("-inf")])
    for lo, hi in ((-1e6, float("inf")), (float("-inf"), float("inf")), (-1.0, 1.0),
                   (float("-inf"), 2.0)):
        lo_t, hi_t = torch.full_like(v, lo), torch.full_like(v, hi)
        assert torch.equal(torch.clamp(v, lo_t, hi_t), torch.fmin(torch.fmax(v, lo_t), hi_t))
    # an inert dummy row 0 u + 1 >= 0 equilibrates to l = -1e6, u = +inf
    s = tqp.equilibrate(*interop.qp_from_numpy(*cbf_qps(2)))
    assert torch.all(s.l[:, 3:5] == -1e6) and torch.isinf(s.u[:, :5]).all()


def test_wrapper_rejects_bad_inputs():
    good = list(interop.qp_from_numpy(*cbf_qps(4)))
    bad = list(good)
    bad[1] = good[1][:2]
    with pytest.raises(ValueError, match="shape"):
        qpk.solve_qp_batch(*bad)
    wide = interop.qp_from_numpy(*random_qps(1, 2, 9, 12))
    with pytest.raises(ValueError, match="n <= 8"):
        qpk.solve_qp_batch(*wide)
    mixed = list(good)
    mixed[3] = torch.empty(good[3].shape, device="meta")
    with pytest.raises(ValueError, match="meta"):
        qpk.solve_qp_batch(*mixed)
    mixed_dtype = list(good)
    mixed_dtype[0] = good[0].double()
    with pytest.raises(ValueError, match="float64"):
        qpk.solve_qp_batch(*mixed_dtype)


def cuda_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/qp_admm_kernel.cu``."""
    text = (CSRC / "qp_admm_kernel.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_cuda_source_constants_match_module():
    text = (CSRC / "qp_admm_kernel.cu").read_text()
    consts = cuda_constants()
    assert consts["N_STAGES"] == qpk.N_STAGES == 8
    assert consts["MAX_N"] == qpk.MAX_N
    # the launch shape: groups of 8 to 32 lanes tile whole warps and blocks
    assert consts["THREADS"] == qpk.THREADS
    assert qpk.THREADS % 32 == 0 and 32 % consts["MIN_GROUP"] == 0 and consts["MAX_GROUP"] == 32
    for n in range(1, qpk.MAX_N + 1):  # every n the wrapper accepts is instantiated
        assert f"case {n}: QP_N({n})" in text or f"default: QP_N({n})" in text


@pytest.fixture(scope="module")
def cpu_lib(tmp_path_factory):
    """``csrc/qp_admm_kernel.cu`` built for the CPU under the warp emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    lib = cuda_on_cpu.build(CSRC / "qp_admm_kernel.cu", tmp_path_factory.mktemp("qp_cpu"))
    lib.qp_admm_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.qp_admm_launch.restype = ctypes.c_int
    lib.qp_admm_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.qp_admm_shape.restype = None
    return lib


def test_launch_shape_matches_cuda_source(cpu_lib, monkeypatch):
    """``launch_shape`` asks the built library's ``qp_admm_shape`` (here the
    CPU build of the same source): its values at the paths' shapes, and
    over every input the rule reads (n, m and B on both sides of each group
    width's threshold) a shape the kernel can run, its rows all in a lane's
    slots or all in global memory."""
    from safe_control_tpu_torch import _build

    monkeypatch.setattr(_build, "load_qp_admm_kernel", lambda: cpu_lib)
    assert qpk.launch_shape(4096, 2, 7) == (8, 1)  # the CBF-QP path: four problems a warp
    assert qpk.launch_shape(32767, 2, 7) == (8, 1)
    assert qpk.launch_shape(32768, 2, 7) == (1, 8)  # from 2^18 lanes: one lane, 8 slots
    assert qpk.launch_shape(2**19, 2, 10) == (1, 10)  # the DPCBF sweep: no slot past m
    assert qpk.launch_shape(16383, 2, 10) == (16, 1)
    assert qpk.launch_shape(16384, 2, 10) == (1, 10)
    assert qpk.launch_shape(1365, 2, 10) == (16, 1)  # anchor 5's groups
    assert qpk.launch_shape(4096, 2, 12) == (16, 1)  # the DI fleet
    assert qpk.launch_shape(2**19, 2, 12) == (1, 12)  # the widest n=2 in one lane
    assert qpk.launch_shape(2**19, 2, 13) == (16, 1)  # past it, a group at any batch
    assert qpk.launch_shape(2**19, 3, 10) == (1, 10)  # the widest n=3 in one lane
    assert qpk.launch_shape(2**19, 3, 11) == (16, 1)
    assert qpk.launch_shape(2**19, 3, 8) == (1, 8)
    assert qpk.launch_shape(2**19, 2, 6) == (8, 1)  # below 7 rows: groups, as not measured
    for n in (1, 4, 5):  # n outside 2-3: groups at any batch, as not measured
        assert qpk.launch_shape(2**19, n, 8) == (8, 1)
    for n in range(6, qpk.MAX_N + 1):  # P, L and A'A alone leave no room for rows
        assert qpk.launch_shape(2**19, n, 7) == (8, 1)
    assert qpk.launch_shape(4096, 3, 153) == (32, 8)  # Manipulator2D: a warp, rows in registers
    assert qpk.launch_shape(2**19, 3, 153) == (32, 8)
    assert qpk.launch_shape(4096, 2, 257) == (32, 0)  # past 256 rows: in global memory
    lanes = cuda_constants()["LANE_MIN_LANES"]
    batches = sorted({1, 4096, qpk.MAX_BATCH, 2**19}
                     | {lanes // w + d for w in (8, 16, 32) for d in (-1, 0, 1)})
    for B in batches:
        for n in range(1, qpk.MAX_N + 1):
            for m in range(1, 600):
                G, R = qpk.launch_shape(B, n, m)
                if G == 1:
                    assert R == m + m % 2, (B, n, m)
                else:
                    assert G in (8, 16, 32) and R in (0, 1, 2, 4, 8), (B, n, m)
                    assert R == 0 or R * G >= m, (B, n, m)


@pytest.mark.parametrize("batch,n,m,iters", [
    (9, 2, 7, 1600),   # the CBF-QP path: two full warps of 4 groups, and 3 copies of the last
    (3, 3, 153, 16),   # Manipulator2D scale: a warp a problem, 5 of 8 register slots used
    (9, 2, 5, 200),    # m not a multiple of G: 3 idle lanes a group
    (5, 4, 40, 40),    # G = 32, the second slot partly filled
    (2, 2, 300, 8),    # past 256 rows: a lane's rows in global memory
    (16384, 2, 10, 400),  # the DPCBF sweep's QPs, one lane a problem: 128 full blocks
    (16387, 2, 10, 400),  # ... and a ragged last block of 3 lanes
    (9, 2, 10, 400),   # ... and below the batch of one lane: G = 16, 6 idle lanes a group
    (16384, 2, 12, 100),  # the DI fleet's m in one lane: the widest at n=2
    (32768, 2, 1, 16),  # one row, below the one-lane shape's rows: G = 8
    (32769, 2, 7, 16),  # m odd in one lane, a ragged last block of 1 lane
    (16384, 2, 11, 8),  # the widest n=2 slots with the last empty
    (16384, 3, 10, 8),  # the widest n=3 in one lane
    (32768, 3, 8, 8),   # n=3 in 8 slots, all full
    (32769, 3, 7, 8),   # ... and m odd, a ragged last block of 1 lane
])
def test_cuda_source_on_the_cpu_matches_plain_version(cpu_lib, monkeypatch, batch, n, m, iters):
    """The kernel's CUDA source, built for the CPU under the warp emulation
    (no FMA contraction, as ``-fmad=false`` on the card), against the plain
    sweep ``_sweep_plain`` on the same equilibrated problems: bit for bit,
    since the kernel uses only +, -, *, /, sqrtf and min/max and takes every
    sum over rows in index order, in one lane by a loop and in a group by
    shuffle.  The shapes of ``launch_shape`` each: one lane (full and
    ragged blocks, m odd and even, each instantiation at n=2 and 3) and groups of
    8, 16 and 32, rows in registers and in global memory.  The plain
    version gets the correctly rounded square root that ``sqrtf`` and the
    card's ``torch.sqrt`` compute: PyTorch's float32 CPU ``torch.sqrt``
    (its AVX-512 kernel) is not always (2.0936923 gives 1.4469596, IEEE
    1.4469597), which moves the rho of 1 of the 9 problems at n=2, m=7."""
    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
    if (n, m) in ((2, 10), (2, 12)):
        s = tqp.equilibrate(*sweep_scale_qps(batch, m - 2, seed=batch))
    else:
        qps = cbf_qps(batch) if (n, m) == (2, 7) else random_qps(m, batch, n, m)
        s = tqp.equilibrate(*interop.qp_from_numpy(*qps))
    x = torch.full((batch, n), float("nan"))
    z = torch.full((batch, m), float("nan"))
    y = torch.full((batch, m), float("nan"))
    args = (iters, 1.0, 1e-6, 1.6)
    assert cpu_lib.qp_admm_launch(*(t.data_ptr() for t in (s.P, s.q, s.A, s.l, s.u, x, z, y)),
                                  batch, n, m, max(iters // qpk.N_STAGES, 1),
                                  *(qpk._f32(a) for a in args[1:]), None) == 0
    x_p, y_p = qpk._sweep_plain(s.P, s.q, s.A, s.l, s.u, *args)
    assert torch.isfinite(x_p).all()
    assert torch.equal(x, x_p) and torch.equal(y, y_p)


def test_lane_launch_count_is_registered_and_traced(cpu_lib, tmp_path, monkeypatch):
    """``LANE_LAUNCH_COUNT`` is registered beside ``LAUNCH_COUNT``, so that
    captures keep it and ``trace_to`` reports its rise in ``port_counters``;
    a launch adds one to it where the launch shape (the library's rule,
    here the CPU build's) is one lane."""
    from safe_control_tpu_torch import _build
    from safe_control_tpu_torch.core import graphs
    from safe_control_tpu_torch.utils import profiling

    monkeypatch.setattr(_build, "load_qp_admm_kernel", lambda: cpu_lib)
    assert graphs.COUNTERS[qpk.__name__] == ("LAUNCH_COUNT", "LANE_LAUNCH_COUNT",
                                             "FINISH_LAUNCH_COUNT")
    monkeypatch.setattr(qpk, "LAUNCH_COUNT", 0)
    monkeypatch.setattr(qpk, "LANE_LAUNCH_COUNT", 0)
    with profiling.trace_to(str(tmp_path / "trace")):
        for B, n, m in ((2**19, 2, 10), (2**19, 2, 10), (32768, 2, 7), (4096, 2, 7),
                        (2**19, 3, 118)):  # three in one lane, one in groups, one in a warp
            qpk._count_launch(B, n, m)
    counters = json.loads((tmp_path / "trace" / "trace.json").read_text())["port_counters"]
    assert counters[f"{qpk.__name__}.LAUNCH_COUNT"] == 5
    assert counters[f"{qpk.__name__}.LANE_LAUNCH_COUNT"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("batch,m", [(1, 7), (17, 7), (64, 7), (4097, 7), (256, 153),
                                     (4097, 10), (131, 12), (32769, 7), (16387, 10),
                                     (16513, 12)])
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch, batch, m):
    """On a card: the kernel against its plain version on the same inputs,
    the CBF-QP path's shape with a lone group, a partly filled warp and a
    ragged block, the sweep's (m=10) and the DI fleet's (m=12) QPs on
    ragged blocks, in groups and (from 32,768 and 16,384 problems) one lane
    a problem, and the Manipulator2D scale (feasible QPs, 300 iterations);
    the CUDA path never runs the plain sweep, the plain finish or
    ``qp.finish``, and launches each kernel once."""
    if m == 7:
        qps, iters, tol = cbf_qps(batch), 1600, 1e-3
    elif m in (10, 12):
        qps = [t.numpy() for t in sweep_scale_qps(batch, m - 2, seed=batch)]
        iters, tol = (400 if m == 10 else 1600), 1e-3
    else:
        P, q, A, l, u = random_qps(7, batch, 3, m, one_sided=100)
        Ax = np.einsum("bmn,bn->bm", A, np.random.default_rng(8).normal(size=(batch, 3)))
        l, u = Ax - (u - l) / 2, Ax + (u - l) / 2  # feasible: the bounds bracket A x_star
        u[:, :100] = np.inf
        qps, iters, tol = (P, q, A, l, u), 300, 2e-3
    ins = [t.to(cuda_device) for t in interop.qp_from_numpy(*qps)]
    plain = qpk.solve_qp_batch_reference(*ins, iters=iters)
    before = qpk.LAUNCH_COUNT

    def refuse(*a, **k):
        raise AssertionError("the CUDA path ran the plain version")

    before_finish = qpk.FINISH_LAUNCH_COUNT
    monkeypatch.setattr(qpk, "solve_qp_batch_reference", refuse)
    monkeypatch.setattr(qpk, "_sweep_plain", refuse)
    monkeypatch.setattr(qpk, "_finish_plain", refuse)
    monkeypatch.setattr(tqp, "finish", refuse)
    kern = qpk.solve_qp_batch(*ins, iters=iters)
    torch.cuda.synchronize()
    assert qpk.LAUNCH_COUNT == before + 1
    assert qpk.FINISH_LAUNCH_COUNT == before_finish + 1
    if m < 100:
        assert (kern.x - plain.x).abs().max().item() < tol
        assert torch.equal(kern.prim_res < 1e-3, plain.prim_res < 1e-3)
    else:
        both = (kern.prim_res < 1e-4) & (plain.prim_res < 1e-4)
        assert int(both.sum()) * 4 >= 3 * batch
        assert (kern.x - plain.x).abs().amax(-1)[both].max().item() < tol
    with pytest.raises(NotImplementedError):
        qpk.solve_qp_batch(*(t.double() for t in ins))


def test_wrapper_refuses_a_batch_past_the_kernels_int_indices():
    """The kernel's B and its block and problem indices are 32-bit ints: a
    launch of more problems is refused before anything is built or copied
    (stride-0 views: nothing of that size is made)."""
    P, q, A, l, u = interop.qp_from_numpy(*cbf_qps(1))
    big = qpk.MAX_BATCH + 1
    views = [t.expand((big,) + t.shape[1:]) for t in (P, q, A, l, u)]
    with pytest.raises(ValueError, match="at most"):
        qpk._sweep_cuda(*views, 400, 1.0, 1e-6, 1.6)
    assert qpk.MAX_BATCH + qpk.THREADS == 2**31


def sweep_scale_qps(B, k, seed):
    """CBF-QP-shaped problems at n=2: ``k`` CBF rows, about a quarter of
    them inert (0 u + 1 >= 0, the padded obstacles), and the input box."""
    g = torch.Generator().manual_seed(seed)
    a_rows = torch.randn((B, k, 2), generator=g)
    b = 0.5 * torch.randn((B, k), generator=g)
    inert = torch.rand((B, k), generator=g) < 0.25
    a_rows[inert] = 0.0
    b[inert] = 1.0
    A = torch.cat([a_rows, torch.eye(2).expand(B, 2, 2)], dim=1)
    l = torch.cat([-b, torch.full((B, 2), -1.0)], dim=1)
    u = torch.cat([torch.full((B, k), float("inf")), torch.ones((B, 2))], dim=1)
    P = (2.0 * torch.eye(2)).expand(B, 2, 2).contiguous()
    q = -2.0 * (3.0 * torch.rand((B, 2), generator=g) - 1.5)
    return P, q, A, l, u


@pytest.mark.gpu
def test_kernel_at_the_sweep_scale_matches_plain_version_bit_for_bit(cuda_device):
    """B2 at the DPCBF sweep's scale: B = 2^19, n=2, m=10 (8 CBF rows and
    the box), 400 iterations, one lane a problem: 4,096 blocks of 128
    problems.  Its x and y on a seeded sample of problems, the first and
    the last block's among them, against the plain sweep on those problems
    alone: bit for bit.  The launch counts in ``LANE_LAUNCH_COUNT`` too."""
    B, k, iters = 2**19, 8, 400
    G, R = qpk.launch_shape(B, 2, k + 2)
    assert (G, R) == (1, 10)
    ins = [t.to(cuda_device) for t in sweep_scale_qps(B, k, seed=2**31 + 19)]
    s = tqp.equilibrate(*ins)
    args = (iters, 1.0, 1e-6, 1.6)
    before = (qpk.LAUNCH_COUNT, qpk.LANE_LAUNCH_COUNT)
    x, y = qpk._sweep_cuda(s.P, s.q, s.A, s.l, s.u, *args)
    torch.cuda.synchronize()
    assert (qpk.LAUNCH_COUNT, qpk.LANE_LAUNCH_COUNT) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    per_block = qpk.THREADS // G
    rng = np.random.default_rng(2**31 + 29)
    rows = sorted(set(rng.choice(B, 4096, replace=False).tolist())
                  | set(range(per_block)) | set(range(B - per_block, B)))
    idx = torch.tensor(rows, device=cuda_device)
    x_p, y_p = qpk._sweep_plain(*(t[idx] for t in (s.P, s.q, s.A, s.l, s.u)), *args)
    assert torch.equal(x[idx], x_p) and torch.equal(y[idx], y_p)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


# ---- the finish kernel (csrc/qp_finish_kernel.cu) ------------------------------


def finish_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/qp_finish_kernel.cu``."""
    text = (CSRC / "qp_finish_kernel.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


@pytest.fixture(scope="module")
def finish_lib(tmp_path_factory):
    """``csrc/qp_finish_kernel.cu`` built for the CPU under the emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    from safe_control_tpu_torch import _build

    return _build.bind_qp_finish(cuda_on_cpu.build(CSRC / "qp_finish_kernel.cu",
                                                   tmp_path_factory.mktemp("finish_cpu")))


@pytest.fixture
def cpu_finish(finish_lib, monkeypatch):
    """``qpk._finish_cuda``, the wrapper's launch, on CPU tensors through the
    CPU build (the null stream)."""
    from safe_control_tpu_torch import _build

    monkeypatch.setattr(_build, "load_qp_finish_kernel", lambda: finish_lib)
    monkeypatch.setattr(qpk, "_current_stream", lambda device: contextlib.nullcontext(None))
    return qpk._finish_cuda


def iterate(qps, iters):
    """The problems, their scaling and the plain sweep's iterate."""
    s = tqp.equilibrate(*qps)
    x, y = qpk._sweep_plain(s.P, s.q, s.A, s.l, s.u, iters, 1.0, 1e-6, 1.6)
    return s, x, y


def mixed_qps(batch, n, m):
    """Random QPs on 20 of their rows, the rest free, but for problems 0,
    16 and 19 (80 consistent equality rows each, from row 20) and 5 (40):
    active sets of n + 80 and n + 40 unknowns whose polished points are
    kept, with small ones beside them."""
    P, q, A, l, u = random_qps(m + n, batch, n, m)
    l[:, 20:], u[:, 20:] = -np.inf, np.inf
    rng = np.random.default_rng(m)
    for b, rows in ((0, 80), (16, 80), (19, 80), (5, 40)):
        l[b, :20], u[b, :20] = -np.inf, np.inf
        l[b, 20:20 + rows] = u[b, 20:20 + rows] = A[b, 20:20 + rows] @ rng.normal(size=n)
    return P, q, A, l, u


def test_finish_source_constants_and_workspace_rule(finish_lib):
    """The source takes every n the wrapper accepts.  A block's inputs and
    systems stay in shared memory (no workspace) at the CBF-QP paths'
    shapes, one thread a problem up to 48 KB a block and one block a
    problem past that while the largest system, (n + m) x (n + m + 1),
    fits its 16 KB; past that a launch's workspace holds a slice of that
    size for each of its blocks, at most one a problem and at most 2^24
    floats (but one block)."""
    text = (CSRC / "qp_finish_kernel.cu").read_text()
    consts = finish_constants()
    assert consts["MAX_N"] == qpk.MAX_N
    assert consts["BLOCK_THREADS"] % 32 == 0 and consts["BLOCK_SYSTEM_FLOATS"] == 4096
    for n in range(1, qpk.MAX_N + 1):
        assert f"case {n}: QP_FINISH_N({n})" in text or f"default: QP_FINISH_N({n})" in text
    ws = finish_lib.qp_finish_workspace
    for n, m in ((2, 7), (2, 10), (2, 12), (3, 10), (1, 14), (2, 1),  # one thread a problem
                 (2, 13), (3, 11), (1, 15), (8, 40), (2, 61)):      # one block a problem
        assert ws(2**19, n, m) == 0, (n, m)
    for n, m in ((2, 62), (3, 118), (3, 153), (2, 300), (8, 600)):
        per = (n + m) * (n + m + 1)
        for B in (1, 33, 4096, 2**19):
            floats = ws(B, n, m)
            blocks = floats // per
            assert floats == blocks * per and 1 <= blocks <= B, (n, m, B)
            assert blocks == min(B, max(1, 2**24 // per)), (n, m, B)
    assert ws(0, 2, 300) == 0


@pytest.mark.parametrize("case,batch,n,m,iters", [
    ("cbf", 9, 2, 7, 1600),        # the CBF-QP path's shape
    ("sweep", 300, 2, 10, 400),    # the DPCBF sweep's: 10 blocks, the last ragged
    ("fleet", 70, 2, 12, 200),     # the DI fleet's, the widest n=2 on chip
    ("n3", 40, 3, 10, 200),        # the widest n=3 on chip
    ("n1", 33, 1, 7, 200),
    ("workspace", 33, 2, 13, 200),  # past the on-chip size: a block a problem
    ("manipulator", 5, 3, 118, 40),  # systems of 41-54 unknowns in shared memory
    ("rows300", 3, 2, 300, 8),       # systems of 114-133 unknowns in the workspace
    ("no_polish", 300, 2, 10, 400),
    ("mixed", 20, 8, 1000, 40),      # both, 16 blocks looping over 20 problems
])
def test_finish_source_on_the_cpu_matches_plain_version(cpu_finish, case, batch, n, m, iters):
    """The finish kernel's CUDA source built for the CPU, launched through
    the wrapper, against ``_finish_plain`` on the same iterates: x, y and
    both residuals bit for bit (the kernel uses +, -, *, /, fmaf and
    comparisons, in the plain version's order; ``_fma`` rounds once as
    fmaf does).  The CBF-QP paths' shapes one thread a problem, and one
    block a problem past them: its system in shared memory, in the
    workspace, and both in one launch whose first four blocks take two
    problems each.  There problems 0, 16 and 19 hold 80 consistent equality
    rows (88 unknowns, in the workspace) and problem 5 holds 40 (48, in
    shared memory), each polished point kept, so that the large systems'
    solutions reach x and y; the others hold 20 random rows."""
    if case in ("sweep", "fleet", "no_polish"):
        qps = sweep_scale_qps(batch, m - 2, seed=batch + m)
    elif case == "mixed":
        qps = interop.qp_from_numpy(*mixed_qps(batch, n, m))
    else:
        qps = interop.qp_from_numpy(*(cbf_qps(batch) if case == "cbf"
                                      else random_qps(m + n, batch, n, m)))
    s, x, y = iterate(qps, iters)
    polish = case != "no_polish"
    got = cpu_finish(*qps, s, x, y, polish)
    want = qpk._finish_plain(*qps, s, x, y, polish)
    for g, w in zip(got, want):
        assert torch.isfinite(w).any()
        assert torch.equal(g, w)
    if case == "mixed":
        ok = qpk._polish_plain(s.P, s.q, s.A, s.l, s.u, x, y, 1e-8, 1e-4)[2]
        assert ok[[0, 5, 16, 19]].all()


def special_problems(m):
    """Five problems at n=2, built in scaled units (d = e = 1): no active
    row; every row active; an exactly singular KKT system; a polished point
    less feasible than the iterate; bounds infinite on either side.  Rows
    past the first four (``m`` > 4) are free (infinite bounds) and zero."""
    inf = float("inf")
    P = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[2.0, 0.5], [0.5, 1.0]],
                      [[-1e-8, 0.0], [0.0, 1.0]], [[1.0, 0.0], [0.0, 1.0]],
                      [[2.0, 0.0], [0.0, 2.0]]])
    q = torch.tensor([[-0.5, 0.2], [0.3, -0.7], [0.1, 0.4], [-5.0, 0.0], [-2.0, -2.0]])
    A = torch.zeros((5, m, 2))
    A[0, :4] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, -1.0]])
    A[1, :4] = torch.tensor([[1.0, 0.5], [0.0, 1.0], [-1.0, 2.0], [0.3, -1.0]])
    A[2, :4] = torch.tensor([[0.0, 1.0], [0.0, 2.0], [0.0, -1.0], [0.0, 0.5]])
    A[3, :4] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, 1.0]])
    A[4, :4] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, -1.0]])
    l = torch.full((5, m), -inf)
    u = torch.full((5, m), inf)
    l[:3, :4], u[:3, :4] = -10.0, 10.0
    l[3, :2] = torch.tensor([0.0, 1.0])
    u[4, 1:3] = torch.tensor([0.5, 3.0])
    l[4, 3] = -1.0
    x = torch.tensor([[0.5, -0.2], [0.4, 0.1], [0.3, 0.1], [1.0, 2.0], [1.0, 0.5]])
    y = torch.zeros((5, m))
    y[1, :4] = 1.0  # every row's upper bound active by its multiplier
    y[2, 0] = 1.0
    y[3, 0] = -1.0  # row 0's lower bound active by its multiplier; row 1 left inactive
    y[4, 1] = 0.8
    ones = torch.ones
    s = tqp.Scaled(P=P, q=q, A=A, l=l, u=u, d=ones((5, m)), e=ones((5, 2)))
    return (P, q, A, l, u), s, x, y


@pytest.mark.parametrize("m", [4, 14])  # on chip; in the workspace
def test_finish_special_cases_on_the_cpu(cpu_finish, m):
    """Problems with no active row, every row active, an exactly singular
    KKT system (P00 + reg is 0 and no active row has a first column), a
    polished point rejected as less feasible, and infinite bounds: the CPU
    build bit for bit against ``_finish_plain``, and each as it should
    come out: the first and the last kept (y 0 on inactive rows), the
    singular and the less feasible one left at the iterate."""
    qps, s, x, y = special_problems(m)
    got = cpu_finish(*qps, s, x, y, True)
    want = qpk._finish_plain(*qps, s, x, y, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, ok = qpk._polish_plain(s.P, s.q, s.A, s.l, s.u, x, y, 1e-8, 1e-4)
    assert ok.tolist() == [True, True, False, False, True]
    assert torch.equal(got.x[2:4], x[2:4]) and torch.equal(got.y[2:4], y[2:4])
    assert torch.equal(got.y[0], torch.zeros(m)) and got.y[4, 0] == 0 and got.y[4, 1] > 0
    assert torch.allclose(got.x[0], torch.tensor([0.5, -0.2]), atol=1e-6)
    assert torch.allclose(got.x[4], torch.tensor([1.0, 0.5]), atol=1e-6)
    assert got.prim_res[3] == 0 and got.prim_res[4] < 1e-6
    if m > 4:  # the free rows change nothing
        small = cpu_finish(*special_problems(4)[0], *special_problems(4)[1:], True)
        assert torch.equal(got.x, small.x) and torch.equal(got.prim_res, small.prim_res)


@pytest.mark.parametrize("case,batch,n,m,iters", [
    ("cbf", 64, 2, 7, 1600), ("sweep", 400, 2, 10, 400), ("fleet", 200, 2, 12, 1600),
    ("random", 64, 3, 10, 1600),
])
def test_finish_plain_matches_general_finish(case, batch, n, m, iters):
    """``_finish_plain`` against ``qp.finish`` on the same iterates, on the
    problems both solve (primal residual under 1e-4): x within 1e-5,
    y within 1e-4 (1 + |y|), the primal residual within 1e-6 and the dual
    within 1e-4 (1 + |terms|).  Tolerances, not bits: the two take the
    same operations, but ``torch.linalg.solve_ex`` (LAPACK's getrf on the
    CPU) may take its sums in another order than the kernel's LU, and
    ``qp.finish`` sums A'y and Ax by ``torch.sum``.  Where the active
    rows outnumber the variables on an infeasible problem, the system is
    singular but for reg and the two answers are each its rounding's:
    those problems are not compared."""
    if case == "cbf":
        qps = interop.qp_from_numpy(*cbf_qps(batch))
    elif case == "random":
        qps = interop.qp_from_numpy(*random_qps(0, batch, n, m))
    else:
        qps = sweep_scale_qps(batch, m - 2, seed=batch)
    s, x, y = iterate(qps, iters)
    got = qpk._finish_plain(*qps, s, x, y, True)
    want = tqp.finish(*qps, s, x, y, True)
    both = (got.prim_res < 1e-4) & (want.prim_res < 1e-4)
    assert int(both.sum()) >= 16
    P, q, A = qps[:3]
    terms = ((P * got.x[:, None, :]).abs().sum(-1) + q.abs()
             + (A * got.y[..., None]).abs().sum(-2)).amax(-1)
    assert (got.x - want.x).abs()[both].max() < 1e-5
    assert ((got.y - want.y).abs() <= 1e-4 * (1 + want.y.abs()))[both].all()
    assert (got.prim_res - want.prim_res).abs()[both].max() < 1e-6
    assert ((got.dual_res - want.dual_res).abs() <= 1e-4 * (1 + terms))[both].all()


def test_finish_launch_count_is_registered_and_traced(cpu_lib, cpu_finish, tmp_path,
                                                      monkeypatch):
    """``FINISH_LAUNCH_COUNT`` is registered beside ``LAUNCH_COUNT``, so
    that captures and replays keep it and ``trace_to`` reports its rise in
    ``port_counters``.  The wrapper's CUDA path, run on the CPU through
    both kernels' CPU builds, launches the sweep once and the finish once a
    call, never runs ``qp.finish`` or a plain version, and gives the plain
    path's answer bit for bit."""
    from safe_control_tpu_torch import _build
    from safe_control_tpu_torch.core import graphs
    from safe_control_tpu_torch.utils import profiling

    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
    qps = sweep_scale_qps(64, 8, seed=2**31 + 23)
    want = qpk.solve_qp_batch_reference(*qps, iters=400)
    monkeypatch.setattr(_build, "load_qp_admm_kernel", lambda: cpu_lib)

    def refuse(*a, **k):
        raise AssertionError("the kernels' path ran qp.finish or a plain version")

    for module, name in ((tqp, "finish"), (tqp, "_finish"), (qpk, "_finish_plain"),
                         (qpk, "_sweep_plain"), (qpk, "solve_qp_batch_reference")):
        monkeypatch.setattr(module, name, refuse)
    assert graphs.COUNTERS[qpk.__name__] == ("LAUNCH_COUNT", "LANE_LAUNCH_COUNT",
                                             "FINISH_LAUNCH_COUNT")
    assert (qpk.__name__, "FINISH_LAUNCH_COUNT") in graphs._counts()
    for name in ("LAUNCH_COUNT", "LANE_LAUNCH_COUNT", "FINISH_LAUNCH_COUNT"):
        monkeypatch.setattr(qpk, name, 0)
    with profiling.trace_to(str(tmp_path / "trace")):
        for calls in (1, 2, 3):
            got = qpk._solve_cuda(*qps, 400, 1.0, 1e-6, 1.6, True)
            assert (qpk.LAUNCH_COUNT, qpk.FINISH_LAUNCH_COUNT) == (calls, calls)
    counters = json.loads((tmp_path / "trace" / "trace.json").read_text())["port_counters"]
    assert counters[f"{qpk.__name__}.LAUNCH_COUNT"] == 3
    assert counters[f"{qpk.__name__}.FINISH_LAUNCH_COUNT"] == 3
    assert counters[f"{qpk.__name__}.LANE_LAUNCH_COUNT"] == 0  # 64 problems: groups
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,m,iters", [(2**19, 2, 10, 400), (256, 3, 153, 300),
                                             (64, 2, 300, 8), (4096, 3, 13, 1600),
                                             (20, 8, 1000, 40)])
def test_finish_kernel_matches_plain_version_on_card(cuda_device, batch, n, m, iters):
    """On a card: the finish kernel against ``_finish_plain`` on B2's
    iterates, bit for bit: the DPCBF sweep's scale (2^19 problems, n=2,
    m=10, one thread a problem), and a block a problem at m=153, 300 rows,
    n=3 m=13, and ``mixed_qps``' systems in shared memory and in the
    workspace, kept.  One launch a call."""
    if m == 10:
        qps = sweep_scale_qps(batch, m - 2, seed=2**31 + 41)
    elif m == 1000:
        qps = interop.qp_from_numpy(*mixed_qps(batch, n, m))
    else:
        qps = interop.qp_from_numpy(*random_qps(m, batch, n, m))
    ins = [t.to(cuda_device) for t in qps]
    s = tqp.equilibrate(*ins)
    x, y = qpk._sweep_cuda(s.P, s.q, s.A, s.l, s.u, iters, 1.0, 1e-6, 1.6)
    before = qpk.FINISH_LAUNCH_COUNT
    got = qpk._finish_cuda(*ins, s, x, y, True)
    torch.cuda.synchronize()
    assert qpk.FINISH_LAUNCH_COUNT == before + 1
    want = qpk._finish_plain(*ins, s, x, y, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,k", [(65536, 8), (4097, 5)])
def test_finish_kernel_rounds_as_solve_ex_on_card(cuda_device, batch, k):
    """On a card, at n=2 (where a sum of two terms has one order): the
    finish kernel's x, y and primal residual equal ``qp.finish``'s, whose
    polish solves the full masked KKT system by ``torch.linalg.solve_ex``,
    bit for bit, infeasible problems and degenerate active sets included.
    The kernel's LU rounds as the batched LU of cuBLAS that solve_ex runs;
    the general path and the benchmark's plain reference polish by it."""
    ins = [t.to(cuda_device) for t in sweep_scale_qps(batch, k, seed=2**31 + k)]
    s = tqp.equilibrate(*ins)
    x, y = qpk._sweep_cuda(s.P, s.q, s.A, s.l, s.u, 400, 1.0, 1e-6, 1.6)
    got = qpk._finish_cuda(*ins, s, x, y, True)
    want = tqp.finish(*ins, s, x, y, True)
    assert bool((want.prim_res > 1e-3).any())  # infeasible problems among them
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
