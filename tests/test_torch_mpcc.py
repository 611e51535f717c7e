"""Port parity: the AL Gauss-Newton core (``solvers/al_gn.py``) and MPCC.

- ``al_gn.solve`` against JAX's on a small NLP (a residual with a bilinear
  and a trigonometric row, a disc constraint and an active box bound),
  three starts, float64: within 1e-6;
- ``mpcc.solve`` against JAX's at horizon 8 and a 3x2 budget, the cold
  start (the global closest-point search) and a warm second call: float64
  |du| <= 1e-6 over the whole predicted input, float32 <= 5e-3;
- ``closest_path_psi``, global and windowed (and a window that holds no
  point), and ``path_reference``, on a hairpin path that folds back;
- the D-step Cholesky: the factor bit for bit ``chol_factor``'s, the solve
  within float64 rounding of ``chol_solve``;
- slow: the MPCC anchors of ``tests/data/parity_goldens_r4.npz`` at the
  accuracy budget (30 x 8) in float64, the applied input within 1e-3 of the
  golden (as ``tests/test_parity_anchors_r4.py``).

The JAX side runs the same float64 or float32 inputs under ``jax.jit``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec
from safe_control_tpu.solvers import al_gn as jal
from safe_control_tpu.solvers import mpcc as jm
from safe_control_tpu_torch import interop
from safe_control_tpu_torch.solvers import al_gn as tal
from safe_control_tpu_torch.solvers import mpcc as tm
from safe_control_tpu_torch.solvers.chol import (
    chol_factor,
    chol_factor_steps,
    chol_solve,
    chol_solve_steps,
)

torch.set_num_threads(1)

DT = 0.05
DATA = os.path.join(os.path.dirname(__file__), "data", "parity_goldens_r4.npz")


# ------------------------------------------------------------------ al_gn
def _nlp(lib):
    """(residual, constraints) of a small NLP on U (D=4), in jnp or torch."""
    if lib is jnp:
        res = lambda u: jnp.stack([u[0] - 1.0, u[1] - 2.0, u[0] * u[1] - 1.5,
                                   jnp.sin(u[2]) + u[3], 0.3 * u[3]])
        con = lambda u: jnp.stack([1.5 - u[0] * u[0] - u[1] * u[1], u[2] + 0.5])
        return res, con
    res = lambda u: torch.stack([u[..., 0] - 1.0, u[..., 1] - 2.0, u[..., 0] * u[..., 1] - 1.5,
                                 torch.sin(u[..., 2]) + u[..., 3], 0.3 * u[..., 3]], dim=-1)
    con = lambda u: torch.stack([1.5 - u[..., 0] * u[..., 0] - u[..., 1] * u[..., 1],
                                 u[..., 2] + 0.5], dim=-1)
    return res, con


NLP_STARTS = np.array([[0.0, 0.0, 0.0, 0.0], [2.0, -1.0, 1.0, 0.5], [0.5, 0.9, -0.4, 2.0]])
NLP_LB = np.array([-2.0, -2.0, -1.0, -0.2])
NLP_UB = np.array([2.0, 1.0, 1.0, 2.0])


def test_al_gn_solve_matches_jax_in_float64():
    cfg = tal.ALGNConfig(outer_iters=6, newton_iters=3)
    U, c = tal.solve(*_nlp(torch), torch.tensor(NLP_STARTS), torch.tensor(NLP_LB),
                     torch.tensor(NLP_UB), cfg)
    with jax.enable_x64(True):
        jcfg = jal.ALGNConfig(outer_iters=6, newton_iters=3)
        run = jax.jit(lambda u0: jal.solve(*_nlp(jnp), u0, jnp.asarray(NLP_LB),
                                           jnp.asarray(NLP_UB), jcfg))
        for b, u0 in enumerate(NLP_STARTS):
            ju, jc = run(jnp.asarray(u0))
            np.testing.assert_allclose(U[b].numpy(), np.asarray(ju), atol=1e-6, rtol=0)
            np.testing.assert_allclose(c[b].numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    # the disc constraint and the box bound u1 <= 1 bind somewhere
    assert (c[:, 0].abs() < 1e-3).any()
    assert torch.isclose(U[:, 1], torch.tensor(1.0, dtype=U.dtype), atol=1e-6).any()


# ------------------------------------------------------------------- MPCC
def _path(dtype):
    sx = np.linspace(0.0, 80.0, 241)
    jp = jm.make_path(sx, np.full_like(sx, 2.0))
    return jp, interop.path_from_jax(jp, dtype=dtype)


MPCC_STATES = [
    [5.0, 2.3, 0.05, 0.1, 0.02, 10.0, 0.01, 300.0],
    [12.0, 1.2, -0.2, -0.3, 0.05, 8.0, -0.05, -500.0],
]


def _mpcc_pair(x8, dtype):
    """JAX's and the port's (cold, warm) solves of one state at horizon 8
    and the 3x2 budget; the warm call starts 0.1 further along."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    al = jal.ALGNConfig(outer_iters=3, newton_iters=2)
    jcfg = jm.MPCCConfig(horizon=8, v_ref=10.0, al=al)
    tcfg = interop.mpcc_config_from_jax(jcfg)
    js, ts = make_spec(DRIFTING_CAR), interop.spec_from_jax(make_spec(DRIFTING_CAR))
    jp, tp = _path(dtype)
    jp = jm.Path(*(jnp.asarray(np.asarray(a), jdt) for a in jp))
    solve = jax.jit(lambda x, s, up: jm.solve(js, x, jp, s, up, DT, jcfg))
    x = np.asarray(x8)
    j1 = solve(jnp.asarray(x, jdt), jm.init_state(jcfg, dtype=jdt), jnp.zeros(2, jdt))
    j2 = solve(jnp.asarray(x + 0.1, jdt), j1.state, j1.u)
    t1 = tm.solve(ts, torch.tensor(x, dtype=dtype)[None], tp,
                  tm.init_state(tcfg, 1, device="cpu", dtype=dtype),
                  torch.zeros((1, 2), dtype=dtype), DT, tcfg)
    t2 = tm.solve(ts, torch.tensor(x + 0.1, dtype=dtype)[None], tp, t1.state, t1.u, DT, tcfg)
    return (j1, j2), (t1, t2)


@pytest.mark.parametrize("x8", MPCC_STATES, ids=["left", "right"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6), (torch.float32, 5e-3)],
                         ids=["f64", "f32"])
def test_mpcc_solve_matches_jax(x8, dtype, tol):
    with jax.enable_x64(dtype == torch.float64):
        js_, ts_ = _mpcc_pair(x8, dtype)
        for j, t in zip(js_, ts_):
            np.testing.assert_allclose(t.us[0].numpy(), np.asarray(j.us), atol=tol, rtol=0)
            np.testing.assert_allclose(t.u[0].numpy(), np.asarray(j.u), atol=tol, rtol=0)
            np.testing.assert_allclose(t.xs[0].numpy(), np.asarray(j.xs), atol=100 * tol, rtol=0)
            assert float(t.state.psi[0]) == pytest.approx(float(j.state.psi), abs=1e-6)
            assert bool(t.state.initialized[0]) and bool(j.state.initialized)
            assert float(t.viol[0]) == pytest.approx(float(j.viol), abs=tol)
        # the warm call moved off the cold solution
        assert not torch.equal(ts_[0].us, ts_[1].us)


def _hairpin(dtype):
    """Out along y = 0 to x = 20, round a half circle, back along y = 6."""
    a = np.linspace(0.0, 20.0, 81)
    th = np.linspace(-np.pi / 2, np.pi / 2, 41)[1:-1]
    px = np.concatenate([a, 20.0 + 3.0 * np.cos(th), a[::-1]])
    py = np.concatenate([np.zeros(81), 3.0 + 3.0 * np.sin(th), np.full(81, 6.0)])
    jp = jm.make_path(px, py)
    return jp, interop.path_from_jax(jp, dtype=dtype)


def test_closest_path_psi_global_and_windowed_match_jax():
    jp, tp = _hairpin(torch.float32)
    cfg = jm.MPCCConfig(search_window=8.0, search_back=2.0)
    tcfg = interop.mpcc_config_from_jax(cfg)
    # near the outbound leg, but the inbound leg (y = 6) is as close to
    # (10, 3.2); the window decides; psi_now = 500 leaves the window empty
    pos = np.array([[10.0, 3.2], [10.0, 2.8], [19.0, 5.5], [3.0, 4.0], [10.0, 3.0]])
    psi_now = np.array([8.0, 60.0, 25.0, 500.0, 0.0], dtype=np.float32)
    for glob in (False, True):
        want = [float(jm.closest_path_psi(jp, jnp.asarray(p), jnp.asarray(s), cfg,
                                          global_search=glob)) for p, s in zip(pos, psi_now)]
        got = tm.closest_path_psi(tp, torch.tensor(pos, dtype=torch.float32),
                                  torch.tensor(psi_now), tcfg, global_search=glob)
        assert got.tolist() == want
    mask = torch.tensor([True, False, True, False, False])
    got = tm.closest_path_psi(tp, torch.tensor(pos, dtype=torch.float32), torch.tensor(psi_now),
                              tcfg, global_search=mask)
    want = [float(jm.closest_path_psi(jp, jnp.asarray(p), jnp.asarray(s), cfg,
                                      global_search=bool(g)))
            for p, s, g in zip(pos, psi_now, mask.tolist())]
    assert got.tolist() == want


def test_path_reference_matches_jax():
    with jax.enable_x64(True):
        jp, tp = _hairpin(torch.float64)
        jp = jm.Path(*(jnp.asarray(np.asarray(a), jnp.float64) for a in jp))
        psi = np.array([-1.0, 0.0, 3.3, 20.0, 21.7, 27.05, 40.0, 1e3])
        want = jax.vmap(lambda p: jnp.stack(jm.path_reference(jp, p)))(jnp.asarray(psi))
        got = torch.stack(tm.path_reference(tp, torch.tensor(psi)), dim=-1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)


def test_mpcc_state_and_config_mirror_jax():
    cfg = jm.MPCCConfig(horizon=6)
    tcfg = interop.mpcc_config_from_jax(cfg)
    assert tcfg == tm.MPCCConfig(horizon=6)
    st = tm.init_state(tcfg, 2, device="cpu")
    jst = jm.init_state(cfg)
    assert st.U.shape == (2,) + jst.U.shape
    np.testing.assert_array_equal(st.U[1].numpy(), np.asarray(jst.U))
    assert not st.initialized.any() and float(st.psi.abs().max()) == 0.0
    x9 = torch.tensor([[1.0, 2.0, 0.3, 0.1, 0.05, 8.0, 0.1, 500.0, 4.0]], dtype=torch.float64)
    u3 = torch.tensor([[0.2, 100.0, 2.5]], dtype=torch.float64)
    with jax.enable_x64(True):
        want = jm._aug_step(jnp.asarray(x9[0].numpy()), jnp.asarray(u3[0].numpy()),
                            make_spec(DRIFTING_CAR), DT)
    got = tm._aug_step(x9, u3, interop.spec_from_jax(make_spec(DRIFTING_CAR)), DT)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-12, rtol=1e-12)


# --------------------------------------------------------- D-step Cholesky
@pytest.mark.parametrize("D", [5, 20, 90])
def test_step_cholesky_matches_column_loop(D):
    rng = np.random.default_rng(D)
    M = rng.normal(size=(3, D, D))
    H = torch.tensor(M @ M.transpose(0, 2, 1) + 0.1 * np.eye(D))
    H[2, 0, 0] = -1.0  # an indefinite pivot: clamped, not raised
    g = torch.tensor(rng.normal(size=(3, D)))
    assert torch.equal(chol_factor_steps(H), chol_factor(H))
    assert torch.equal(chol_factor_steps(H.float()), chol_factor(H.float()))
    L = chol_factor(H)
    np.testing.assert_allclose(chol_solve_steps(L, g)[:2].numpy(), chol_solve(H, g)[:2].numpy(),
                               rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ MPCC anchors
@pytest.mark.slow
def test_mpcc_anchors_reference_precision():
    """The MPCC anchors at the accuracy budget (30 outer x 8 Newton) in
    float64: the applied [delta_dot, tau_dot] within 1e-3 of the golden."""
    data = np.load(DATA)
    pxy = data["mpcc_path_xy"]
    with jax.enable_x64(True):
        jp = jm.make_path(pxy[:, 0], pxy[:, 1])
    path = tm.Path(s=torch.tensor(np.asarray(jp.s), dtype=torch.float64),
                   x=torch.tensor(pxy[:, 0]), y=torch.tensor(pxy[:, 1]),
                   theta=torch.tensor(np.asarray(jp.theta), dtype=torch.float64))
    cfg = tm.MPCCConfig(horizon=30, v_ref=10.0, al=tal.ALGNConfig(outer_iters=30, newton_iters=8))
    spec = interop.spec_from_jax(make_spec(DRIFTING_CAR))
    B = len(data["mpcc_x8"])
    st = tm.init_state(cfg, B, device="cpu", dtype=torch.float64)
    st = st._replace(psi=torch.tensor(data["mpcc_psi"]),
                     initialized=torch.tensor(data["mpcc_init"]))
    r = tm.solve(spec, torch.tensor(data["mpcc_x8"]), path, st, torch.tensor(data["mpcc_uprev"]),
                 DT, cfg)
    devs = np.abs(r.u.numpy() - data["mpcc_gold"]).max(axis=1)
    assert devs.max() < 1e-3, f"mpcc f64 deviations {devs}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mpcc_float64_on_card_matches_cpu(cuda_device):
    """The same float64 solve on the card and on the CPU: |du| <= 1e-6."""
    cfg = tm.MPCCConfig(horizon=8, v_ref=10.0, al=tal.ALGNConfig(outer_iters=3, newton_iters=2))
    spec = interop.spec_from_jax(make_spec(DRIFTING_CAR))
    outs = []
    for dev in ("cpu", cuda_device):
        _, tp = _path(torch.float64)
        tp = tm.Path(*(a.to(dev) for a in tp))
        r = tm.solve(spec, torch.tensor([MPCC_STATES[0]], dtype=torch.float64, device=dev), tp,
                     tm.init_state(cfg, 1, device=dev, dtype=torch.float64),
                     torch.zeros((1, 2), dtype=torch.float64, device=dev), DT, cfg)
        outs.append(r.us.cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
