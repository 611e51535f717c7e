"""The fused DU kernel module: its plain PyTorch version, wrapper and sources.

On the CPU the wrapper ``solve_du_batch`` runs ``solve_du_batch_reference``,
the plain PyTorch version of ``csrc/mpc_du_kernel.cu`` (the same hand-derived
tangents, the same order of operations).  It is held against the JAX
``mpc_cbf.solve`` — the comparison the JAX package makes for its own kernel
(``tests/test_mpc_du_kernel.py``) — at the shipped geometry (N=8, K=5) and
the full 8x3 budget: |du| < 5e-3 and viol atol 1e-3 in float32, on the JAX
test's batch form (zero u_prev and warm start; with a random warm start two
float32 solves drift apart by up to their own 1e-2-scale distance from the
float64 answer, see ``tests/test_torch_mpc_cbf.py``).  In float64
the same hand-derived math must reproduce the JAX float64 solve to 1e-6,
which a wrong tangent would break.  The CUDA kernel itself is checked by the
``gpu``-marked test on a card and by ``chip_smoke.py``.
"""

import ctypes
import math
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_on_cpu
from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.solvers import mpc_cbf as jmpc
from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

torch.set_num_threads(1)

B, N, DT = 16, 8, 0.05
SPEC = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
PARAMS = (DT, SPEC.mpc_cbf_alpha1, SPEC.mpc_cbf_alpha2, SPEC.cbf_beta, SPEC.radius,
          SPEC.v_max, SPEC.a_max, SPEC.w_max)
CSRC = Path(duk.__file__).resolve().parent.parent / "csrc"


def problems(seed=0, warm=True, B=B):
    """``B`` problems; ``warm=False`` zeroes u_prev and the warm start, the
    form of the JAX package's own kernel-parity batch."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(0, 3, (B, 2)), rng.uniform(-1, 1, (B, 1)),
                         rng.uniform(0, 0.8, (B, 1))], axis=1)
    goals = np.tile(np.array([5.0, 1.0, 0.0, 0.0]), (B, 1))
    obs1 = np.asarray(pad_obstacles(jnp.asarray(
        [[2.5, 0.8, 0.4, 0, 0, 0, 0],
         [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], jnp.float32), 5))  # superellipsoid row
    obs = np.tile(obs1[None], (B, 1, 1))
    u_prevs = rng.uniform(-0.2, 0.2, (B, 2)) * warm
    Uw = rng.uniform(-0.3, 0.3, (B, N, 2)) * warm
    return xs, goals, obs, u_prevs, Uw


def jax_solve(inputs, dtype):
    cfg = jmpc.MPCConfig(horizon=N, num_obs=5)

    def one(x, goal, ob, up, U):
        r = jmpc.solve(DYNAMIC_UNICYCLE_2D, SPEC, x, goal, ob, up,
                       jmpc.MPCState(U=U, lam=jnp.zeros((56,), dtype)), DT, cfg)
        return r.u, r.viol

    with jax.enable_x64(dtype == jnp.float64):
        return [np.asarray(a) for a in
                jax.jit(jax.vmap(one))(*(jnp.asarray(a, dtype) for a in inputs))]


def _t(inputs, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype).contiguous() for a in inputs]


def test_reference_f32_within_envelope_of_jax_solve():
    inputs = problems(warm=False)
    u_ref, viol_ref = jax_solve(inputs, jnp.float32)
    before = duk.LAUNCH_COUNT
    res = duk.solve_du_batch(*_t(inputs), PARAMS)  # CPU: the plain version
    assert duk.LAUNCH_COUNT == before
    assert res.u.shape == (B, 2) and res.U.shape == (B, N, 2) and res.viol.shape == (B,)
    assert np.abs(res.u.numpy() - u_ref).max() < 5e-3
    np.testing.assert_allclose(res.viol.numpy(), viol_ref, atol=1e-3)
    ref = duk.solve_du_batch_reference(*_t(inputs), PARAMS)
    assert torch.equal(res.U, ref.U) and torch.equal(res.viol, ref.viol)


def test_hand_derived_math_matches_jax_f64():
    """The reference's hand-derived tangents, run in float64, against the
    JAX float64 solve (which differentiates by ``jax.linearize``).  Only the
    float32-rounded spec scalars separate the two (measured ~2e-8)."""
    inputs = problems(seed=1)
    u_ref, viol_ref = jax_solve(inputs, jnp.float64)
    xs, goals, obs, ups, Uw = _t(inputs, torch.float64)
    U0 = duk._warm_start(Uw, SPEC.a_max, SPEC.w_max)
    U, viol = duk._solve_plain(xs, goals, obs, ups, U0, PARAMS)
    assert np.abs(U.numpy().reshape(B, N, 2)[:, 0] - u_ref).max() < 1e-6
    assert np.abs(viol.numpy() - viol_ref).max() < 1e-6


def test_wrapper_rejects_bad_inputs():
    good = _t(problems())
    with pytest.raises(NotImplementedError):
        duk.solve_du_batch(*_t(problems(), torch.float64), PARAMS)
    bad_shape = list(good)
    bad_shape[2] = good[2][:, :4].contiguous()  # 4 obstacle slots
    with pytest.raises(ValueError, match="shape"):
        duk.solve_du_batch(*bad_shape, PARAMS)
    bad_batch = list(good)
    bad_batch[1] = good[1][:8]
    with pytest.raises(ValueError, match="shape"):
        duk.solve_du_batch(*bad_batch, PARAMS)
    mixed = list(good)
    mixed[3] = torch.empty((B, 2), device="meta")
    with pytest.raises(ValueError, match="meta"):
        duk.solve_du_batch(*mixed, PARAMS)
    strided = list(good)
    strided[0] = torch.zeros((B, 8))[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        duk.solve_du_batch(*strided, PARAMS)


def test_warm_start_shift_and_clip():
    Uw = torch.arange(B * N * 2, dtype=torch.float32).reshape(B, N, 2) / 100.0
    U0 = duk._warm_start(Uw, 1.0, 0.5).reshape(B, N, 2)
    want = torch.cat([Uw[:, 1:], Uw[:, -1:]], dim=1)
    want = torch.stack([want[..., 0].clamp(-1.0, 1.0), want[..., 1].clamp(-0.5, 0.5)], -1)
    assert torch.equal(U0, want)


def _header_constants():
    text = (CSRC / "mpc_du_kernel.h").read_text()
    consts = {}
    for m in re.finditer(r"constexpr (?:int|float) (\w+) = (?:\(float\))?\(?([-\w.*+/ ()e]+?)\)?;",
                         text):
        consts[m.group(1)] = m.group(2)
    return consts


def test_cuda_header_constants_match_module():
    """The CUDA source's constants are the Python module's, rounded alike."""
    c = _header_constants()
    f32 = lambda expr: np.float32(eval(expr, {"M": 16}))
    ints = {}  # in the header's order, with C's integer division
    for name in ("N", "K", "M", "NR", "NC", "LANES", "THREADS", "PROBLEMS_PER_BLOCK",
                 "OUTER", "NEWTON"):
        ints[name] = int(eval(c[name].replace("/", "//"), {}, ints))
        assert ints[name] == getattr(duk, name), name
    # the launch shape: a group of LANES lanes per problem, one per variable
    assert duk.LANES == duk.M and duk.PROBLEMS_PER_BLOCK * duk.LANES == duk.THREADS
    assert 32 % duk.LANES == 0 and duk.THREADS % 32 == 0  # groups tile whole warps
    for name, val in (("RHO0", duk.RHO0), ("RHO_GROWTH", duk.RHO_GROWTH),
                      ("RHO_MAX", duk.RHO_MAX), ("REG", duk.REG),
                      ("NOISE_EPS", duk.NOISE_EPS), ("PI_F", math.pi),
                      ("TWOPI_F", 2.0 * math.pi)):
        assert f32(c[name]) == np.float32(val), name
    assert int(c["NUM_ALPHAS"]) == len(duk.ALPHAS)
    for i, a in enumerate(duk.ALPHAS):
        assert f32(c[f"ALPHA_{i}"]) == np.float32(a)
    for i, s in enumerate(duk.SQ):
        assert f32(c[f"SQ_{i}"]) == np.float32(s)
    for i, s in enumerate(duk.SR):
        assert f32(c[f"SR_{i}"]) == np.float32(s)
    # the float32 noise constant is 4 eps, which the plain version uses
    assert np.float32(duk.NOISE_EPS) == 4 * np.finfo(np.float32).eps
    # input-move Hessian entries, as the plain version rounds them
    assert f32(c["IH_DIAG"]) == np.float32(duk._input_hess(0, 0))
    assert f32(c["IH_DIAG_LAST"]) == np.float32(duk._input_hess(15, 15))
    assert f32(c["IH_OFF"]) == np.float32(duk._input_hess(0, 2))
    assert duk._input_hess(0, 1) == 0.0 and duk._input_hess(1, 3) == duk._input_hess(0, 2)


def test_cuda_source_on_the_cpu_matches_plain_version(tmp_path):
    """The kernel's CUDA source itself, built for the CPU under the warp
    emulation of ``cuda_on_cpu`` (no FMA contraction, as ``-fmad=false``
    on the card), against its plain version at B=9: a
    full block of 8 problems and a block whose one warp has a second group
    that solves a copy and stores nothing.  Not bit for bit: the CPU's libm
    rounds sin, cos and pow unlike PyTorch's CPU kernels (measured 8.7e-5 in
    u), so the kernel-class envelope holds; a wrong index of the factor in
    the back substitution gives 0.15."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    lib = cuda_on_cpu.build(CSRC / "mpc_du_kernel.cu", tmp_path)
    lib.mpc_du_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_float] * 8
                                  + [ctypes.c_void_p])
    batch = 9
    ins = _t([a[:batch] for a in problems()])
    U0 = duk._warm_start(ins[4], SPEC.a_max, SPEC.w_max)
    U = torch.full((batch, duk.M), float("nan"))
    viol = torch.full((batch,), float("nan"))
    assert lib.mpc_du_launch(*(t.data_ptr() for t in (*ins[:4], U0, U, viol)), batch,
                             *(float(p) for p in PARAMS), None) == 0
    plain = duk.solve_du_batch_reference(*ins, PARAMS)
    assert np.abs(U.numpy() - plain.U.reshape(batch, duk.M).numpy()).max() < 5e-3
    np.testing.assert_allclose(viol.numpy(), plain.viol.numpy(), atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 17, 64, 4097])
def test_kernel_matches_plain_version_on_card(cuda_device, monkeypatch, batch):
    """On a card: the kernel against its plain version on the same inputs,
    with a partly filled warp and block at 1, 17 and 4097 problems; the CUDA
    path never runs the plain version."""
    ins = [t.to(cuda_device) for t in _t(problems(B=batch))]
    plain = duk.solve_du_batch_reference(*ins, PARAMS)
    before = duk.LAUNCH_COUNT

    def refuse(*a, **k):
        raise AssertionError("the CUDA path ran the plain version")

    monkeypatch.setattr(duk, "solve_du_batch_reference", refuse)
    monkeypatch.setattr(duk, "_solve_plain", refuse)
    kern = duk.solve_du_batch(*ins, PARAMS)
    torch.cuda.synchronize()
    assert duk.LAUNCH_COUNT == before + 1
    assert (kern.u - plain.u).abs().max().item() < 5e-3
    assert (kern.viol - plain.viol).abs().max().item() <= 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)
