"""The QP ADMM kernel module: its plain PyTorch version, wrapper and source.

On the CPU the wrapper ``solve_qp_batch`` runs ``solve_qp_batch_reference``,
the plain PyTorch version of ``csrc/qp_admm_kernel.cu`` (the same
operations in the same order).  It is held against the JAX
``solve_qp_batch_pallas`` run in Pallas interpret mode, as the JAX
package's own tests run it (``tests/test_qp_kernel.py``), at the full
1600-iteration budget: |dx| < 1e-3 on problems both solve (two float32
solves of one problem by different operation orders); and against the
analytic optima at 1e-5.  The CUDA source itself is built for the CPU
under the warp emulation of ``cuda_on_cpu`` and held to the plain sweep
bit for bit; on a card the ``gpu``-marked tests and ``chip_smoke.py``
check the kernel.  On a machine without JAX run those with
``--noconftest``.
"""

import ctypes
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


def test_cuda_source_constants_match_module():
    text = (CSRC / "qp_admm_kernel.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["N_STAGES"]) == qpk.N_STAGES == 8
    assert int(consts["MAX_N"]) == qpk.MAX_N
    # the launch shape: groups of 8 to 32 lanes tile whole warps and blocks
    for name in ("THREADS", "MIN_GROUP", "MAX_GROUP", "MAX_REG_ROWS"):
        assert int(consts[name]) == getattr(qpk, name), name
    assert qpk.THREADS % 32 == 0 and 32 % qpk.MIN_GROUP == 0 and qpk.MAX_GROUP == 32
    assert qpk.launch_shape(7) == (8, 1)  # the CBF-QP path: four problems a warp
    assert qpk.launch_shape(153) == (32, 8)  # Manipulator2D scale: a warp, rows in registers
    assert qpk.launch_shape(257) == (32, 0)  # past 256 rows: in global memory
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
    lib.qp_admm_shape.restype = None
    return lib


def test_launch_shape_matches_cuda_source(cpu_lib):
    g, r = ctypes.c_int(), ctypes.c_int()
    for m in range(1, 600):
        cpu_lib.qp_admm_shape(m, ctypes.byref(g), ctypes.byref(r))
        assert (g.value, r.value) == qpk.launch_shape(m), m


@pytest.mark.parametrize("batch,n,m,iters", [
    (9, 2, 7, 1600),   # the CBF-QP path: two full warps of 4 groups, and 3 copies of the last
    (3, 3, 153, 16),   # Manipulator2D scale: a warp a problem, 5 of 8 register slots used
    (9, 2, 5, 200),    # m not a multiple of G: 3 idle lanes a group
    (5, 4, 40, 40),    # G = 32, the second slot partly filled
    (2, 2, 300, 8),    # past 256 rows: a lane's rows in global memory
])
def test_cuda_source_on_the_cpu_matches_plain_version(cpu_lib, monkeypatch, batch, n, m, iters):
    """The kernel's CUDA source, built for the CPU under the warp emulation
    (no FMA contraction, as ``-fmad=false`` on the card), against the plain
    sweep ``_sweep_plain`` on the same equilibrated problems: bit for bit,
    since the kernel uses only +, -, *, /, sqrtf and min/max and takes every
    sum over rows in index order by shuffle.  The plain version gets the
    correctly rounded square root that ``sqrtf`` and the card's
    ``torch.sqrt`` compute: PyTorch's float32 CPU ``torch.sqrt`` (its
    AVX-512 kernel) is not always (2.0936923 gives 1.4469596, IEEE
    1.4469597), which moves the rho of 1 of the 9 problems at n=2, m=7."""
    monkeypatch.setattr(torch, "sqrt", cuda_on_cpu.ieee_sqrt)
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


@pytest.mark.gpu
@pytest.mark.parametrize("batch,m", [(1, 7), (17, 7), (64, 7), (4097, 7), (256, 153)])
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch, batch, m):
    """On a card: the kernel against its plain version on the same inputs,
    the CBF-QP path's shape with a lone group, a partly filled warp and a
    ragged block, and the Manipulator2D scale (feasible QPs, 300
    iterations); the CUDA path never runs the plain sweep."""
    if m == 7:
        qps, iters, tol = cbf_qps(batch), 1600, 1e-3
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

    monkeypatch.setattr(qpk, "solve_qp_batch_reference", refuse)
    monkeypatch.setattr(qpk, "_sweep_plain", refuse)
    kern = qpk.solve_qp_batch(*ins, iters=iters)
    torch.cuda.synchronize()
    assert qpk.LAUNCH_COUNT == before + 1
    if m == 7:
        assert (kern.x - plain.x).abs().max().item() < tol
        assert torch.equal(kern.prim_res < 1e-3, plain.prim_res < 1e-3)
    else:
        both = (kern.prim_res < 1e-4) & (plain.prim_res < 1e-4)
        assert int(both.sum()) * 4 >= 3 * batch
        assert (kern.x - plain.x).abs().amax(-1)[both].max().item() < tol
    with pytest.raises(NotImplementedError):
        qpk.solve_qp_batch(*(t.double() for t in ins))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)
