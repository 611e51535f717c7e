"""Port parity: barrier values, the discrete-time HOCBF value and the
continuous-time CBF-QP rows.

Random positions from a numpy seed against circle, superellipsoid and dummy
obstacle rows, in float64; values must agree with the JAX package to
rtol 1e-10.  The superellipsoid branch is evaluated (and not selected) on
circle and dummy rows, so values and ``torch.func.jacfwd`` derivatives must
stay finite there.  The CBF-QP rows (A, b) of ``ct_cbf_row`` for
DoubleIntegrator2D, SingleIntegrator2D and DynamicUnicycle2D, both modes,
must agree with the JAX rows within 1e-9 (relative to the row's size, which
reaches 1e9 on dummy rows in 'hard' mode) and stay finite; the r=2 rows
differentiate twice through the ``torch.where`` of ``h_point``.  The
Unicycle2D rows (the heading sigmoid), Manipulator2D's 23-row link-circle
blocks, the KinematicBicycle2D family's and Quad2D's rows are held to 1e-9
likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.barriers import geometry as jgeo
from safe_control_tpu.barriers import hocbf as jhocbf
from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    KINEMATIC_BICYCLE_2D,
    KINEMATIC_BICYCLE_2D_C3BF,
    KINEMATIC_BICYCLE_2D_DPCBF,
    MANIPULATOR_2D,
    QUAD_2D,
    SINGLE_INTEGRATOR_2D,
    UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.dynamics import get_model as jget_model
from safe_control_tpu_torch.barriers import geometry as tgeo
from safe_control_tpu_torch.barriers import hocbf as thocbf
from safe_control_tpu_torch.core import spec as tspec
from safe_control_tpu_torch.dynamics import get_model

torch.set_num_threads(1)

R, BETA, DT = 0.25, 1.01, 0.05
OBS = {
    "circle": [2.0, 1.0, 0.4, 0.0, 0.0, 0.0, 0.0],
    "superellipsoid": [1.5, -0.5, 0.8, 0.4, 4.0, 0.4, 1.0],
    "dummy": [1000.0, 1000.0, 0.0, 0.0, 0.0, 0.0, 0.0],
}


def _positions(B=128, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 4.0, (B, 2))


@pytest.mark.parametrize("kind", list(OBS))
def test_geometry_values_match_jax_f64(kind):
    p = _positions()
    ob = np.tile(np.asarray(OBS[kind]), (p.shape[0], 1))
    with jax.enable_x64(True):
        jp, jo = jnp.asarray(p), jnp.asarray(ob)
        want = {
            "h_circle": jax.vmap(lambda a, o: jgeo.h_circle(a, o, R, BETA))(jp, jo),
            "h_superellipsoid": jax.vmap(lambda a, o: jgeo.h_superellipsoid(a, o, R))(jp, jo),
            "h_point": jax.vmap(lambda a, o: jgeo.h_point(a, o, R, BETA))(jp, jo),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    tp, to = torch.as_tensor(p), torch.as_tensor(ob)
    got = {
        "h_circle": tgeo.h_circle(tp, to, R, BETA),
        "h_superellipsoid": tgeo.h_superellipsoid(tp, to, R),
        "h_point": tgeo.h_point(tp, to, R, BETA),
    }
    for name in want:
        g = got[name].numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want[name], rtol=1e-10, atol=0, err_msg=name)


@pytest.mark.parametrize("kind", list(OBS))
def test_dt_h_and_hocbf_value_match_jax_f64(kind):
    rng = np.random.default_rng(2)
    B = 64
    x = np.concatenate([_positions(B, 4), rng.uniform(-3, 3, (B, 1)), rng.uniform(0, 1, (B, 1))],
                       axis=1)
    u = rng.uniform(-1, 1, (B, 2))
    ob = np.tile(np.asarray(OBS[kind]), (B, 1))
    js = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    ts = tspec.make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    jm, tm = jget_model(DYNAMIC_UNICYCLE_2D), get_model(DYNAMIC_UNICYCLE_2D)
    with jax.enable_x64(True):
        jx, ju, jo = (jnp.asarray(a) for a in (x, u, ob))
        want_h = np.asarray(jax.vmap(
            lambda s, o: jhocbf.dt_h(jm, DYNAMIC_UNICYCLE_2D, s, o, js))(jx, jo))
        want_c = np.asarray(jax.vmap(
            lambda s, a, o: jhocbf.dt_hocbf_value(jm, DYNAMIC_UNICYCLE_2D, s, a, o, js, DT)
        )(jx, ju, jo))
    tx, tu, to = (torch.as_tensor(a) for a in (x, u, ob))
    np.testing.assert_allclose(thocbf.dt_h(tm, DYNAMIC_UNICYCLE_2D, tx, to, ts).numpy(),
                               want_h, rtol=1e-10, atol=0)
    np.testing.assert_allclose(
        thocbf.dt_hocbf_value(tm, DYNAMIC_UNICYCLE_2D, tx, tu, to, ts, DT).numpy(),
        want_c, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", list(OBS))
def test_barrier_jacobians_finite(kind):
    """Value and forward-mode Jacobian of h_point and the HOCBF row are finite."""
    tm = get_model(DYNAMIC_UNICYCLE_2D)
    ts = tspec.make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    ob = torch.tensor(OBS[kind], dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        p = torch.as_tensor(_positions(16, 5), dtype=dtype)
        o = ob.to(dtype)
        J = torch.func.vmap(torch.func.jacfwd(lambda q: tgeo.h_point(q, o, R, BETA)))(p)
        assert torch.isfinite(tgeo.h_point(p, o, R, BETA)).all()
        assert torch.isfinite(J).all() and J.shape == (16, 2)
        x = torch.cat([p, torch.full((16, 1), 0.3, dtype=dtype),
                       torch.full((16, 1), 0.5, dtype=dtype)], dim=1)
        u = torch.full((2,), 0.2, dtype=dtype)
        row = lambda uu: thocbf.dt_hocbf_value(tm, DYNAMIC_UNICYCLE_2D, x, uu, o, ts, DT)
        Ju = torch.func.jacfwd(row)(u)
        assert torch.isfinite(row(u)).all() and torch.isfinite(Ju).all()


N_STATES = {DOUBLE_INTEGRATOR_2D: 4, SINGLE_INTEGRATOR_2D: 2, DYNAMIC_UNICYCLE_2D: 4}


def _row_states(name, B=32, seed=6):
    rng = np.random.default_rng(seed)
    n = N_STATES[name]
    return np.concatenate([_positions(B, seed), rng.uniform(-1, 1, (B, n - 2))], axis=1)


@pytest.mark.parametrize("mode", ["cbf", "hard"])
@pytest.mark.parametrize("name", list(N_STATES))
def test_ct_cbf_row_matches_jax_f64(name, mode):
    """Rows of every (robot, obstacle slot) pair at once: x (B,1,n) against
    obs (K,7) broadcast to (B,K)."""
    x = _row_states(name)
    obs = np.asarray(list(OBS.values()))
    js, ts = make_spec(name), tspec.make_spec(name)
    jm, tm = jget_model(name), get_model(name)
    with jax.enable_x64(True):
        row = lambda s, o: jhocbf.ct_cbf_row(jm, name, s, o, js, DT, mode)
        jA, jb = jax.vmap(lambda s: jax.vmap(lambda o: row(s, o))(jnp.asarray(obs)))(jnp.asarray(x))
        jA, jb = np.asarray(jA), np.asarray(jb)
    tA, tb = thocbf.ct_cbf_row(tm, name, torch.as_tensor(x)[:, None, :], torch.as_tensor(obs),
                               ts, DT, mode)
    assert tA.shape == jA.shape and tb.shape == jb.shape
    assert torch.isfinite(tA).all() and torch.isfinite(tb).all()
    np.testing.assert_allclose(tA.numpy(), jA, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", [DOUBLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D])
def test_second_derivative_finite_on_dummy_rows(name):
    """r=2 rows on dummy obstacles, with the robot far away and exactly at
    the dummy position (1000, 1000), in float32 and float64."""
    tm, ts = get_model(name), tspec.make_spec(name)
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(_row_states(name, 8), dtype=dtype)
        x[0, :2] = 1000.0
        x[1, :2] = torch.tensor([1000.0, 999.5])
        dummy = torch.tensor(OBS["dummy"], dtype=dtype)
        h, hdot, grad = thocbf.ct_terms(tm, name, x, dummy, ts)
        A, b = thocbf.ct_cbf_row(tm, name, x, dummy, ts, DT)
        for t in (h, hdot, grad, A, b):
            assert torch.isfinite(t).all()
        assert grad.shape == (8, 4) and A.shape == (8, 2)


def test_ct_rows_of_a_batched_spec():
    """Tensor spec fields (B, 1) broadcast against (B, K) rows."""
    name = DOUBLE_INTEGRATOR_2D
    tm = get_model(name)
    x = torch.as_tensor(_row_states(name, 4))[:, None, :]
    obs = torch.as_tensor(np.asarray(list(OBS.values())))
    radii = [0.2, 0.25, 0.3, 0.35]
    base = tspec.make_spec(name)
    batched = base.replace(radius=torch.tensor(radii, dtype=torch.float64)[:, None])
    A, b = thocbf.ct_cbf_row(tm, name, x, obs, batched, DT)
    for i, r in enumerate(radii):
        Ai, bi = thocbf.ct_cbf_row(tm, name, x[i], obs, base.replace(radius=r), DT)
        np.testing.assert_allclose(A[i].numpy(), Ai.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b[i].numpy(), bi.numpy(), rtol=1e-12, atol=1e-12)


def _rows_close(got, want):
    """Finite, and within 1e-9 of the JAX rows relative to the row's size."""
    g, w = (np.asarray(a) for a in got), (np.asarray(a) for a in want)
    for a, b in zip(g, w):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_unported_barriers_raise():
    """The two barrier branches that wait for their models in the JAX
    package's layout, now held to it: Unicycle2D's ``ct_h`` with the heading
    sigmoid (and its rows), and Manipulator2D's ``ct_cbf_rows_multi``, in
    both modes, float64."""
    rng = np.random.default_rng(6)
    x_uni = np.concatenate([_positions(32, 7), rng.uniform(-4, 4, (32, 1))], axis=1)
    x_arm = rng.uniform(-2, 2, (32, 3))
    for name, x in ((UNICYCLE_2D, x_uni), (MANIPULATOR_2D, x_arm)):
        js, ts = make_spec(name), tspec.make_spec(name)
        jm, tm = jget_model(name), get_model(name)
        for kind, ob in OBS.items():
            if name == UNICYCLE_2D and kind == "dummy":
                # 1000 m away the sigmoid's exp overflows: NaN or inf / inf in
                # both packages, whose quotient rules then part ways; the
                # CBF-QP makes a dummy's row inert.
                continue
            for mode in ("cbf", "hard"):
                with jax.enable_x64(True):
                    jo = jnp.asarray(ob)
                    if name == UNICYCLE_2D:
                        want_h = jax.vmap(lambda xx: jhocbf.ct_h(jm, name, xx, jo, js))(
                            jnp.asarray(x))
                        want = jax.vmap(lambda xx: jhocbf.ct_cbf_row(
                            jm, name, xx, jo, js, DT, mode))(jnp.asarray(x))
                    else:
                        want = jax.vmap(lambda xx: jhocbf.ct_cbf_rows_multi(
                            jm, xx, jo, js, DT, mode))(jnp.asarray(x))
                    want = [np.asarray(w) for w in want]
                tx, to = torch.as_tensor(x), torch.tensor(ob, dtype=torch.float64)
                if name == UNICYCLE_2D:
                    got_h = thocbf.ct_h(tm, name, tx, to, ts)
                    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-12,
                                               atol=1e-12)
                    got = thocbf.ct_cbf_row(tm, name, tx, to, ts, DT, mode)
                else:
                    got = thocbf.ct_cbf_rows_multi(tm, tx, to, ts, DT, mode)
                    assert got[0].shape == (32, 23, 3) and got[1].shape == (32, 23)
                _rows_close(got, want)


@pytest.mark.parametrize("name", [KINEMATIC_BICYCLE_2D, KINEMATIC_BICYCLE_2D_C3BF,
                                  KINEMATIC_BICYCLE_2D_DPCBF, QUAD_2D])
def test_new_model_rows_match_jax_f64(name):
    """The CBF-QP rows of the bicycles (r=2 circle / superellipsoid, and the
    r=1 C3BF and DPCBF barriers against moving circles) and of Quad2D (r=2),
    both modes."""
    rng = np.random.default_rng(8)
    jm, tm = jget_model(name), get_model(name)
    n = jm.N_STATES
    x = np.concatenate([_positions(32, 9), rng.uniform(-3, 3, (32, 1)),
                        rng.uniform(0.3, 2.0, (32, 1)), rng.uniform(-1, 1, (32, n - 4))], axis=1)
    js, ts = make_spec(name), tspec.make_spec(name)
    obs = dict(OBS, moving=[2.0, 1.0, 0.4, -0.6, 0.3, 0.0, 0.0])
    for ob in obs.values():
        for mode in ("cbf", "hard"):
            with jax.enable_x64(True):
                want = jax.vmap(lambda xx: jhocbf.ct_cbf_row(
                    jm, name, xx, jnp.asarray(ob), js, DT, mode))(jnp.asarray(x))
            got = thocbf.ct_cbf_row(tm, name, torch.as_tensor(x), torch.tensor(ob, dtype=torch.float64),
                                    ts, DT, mode)
            _rows_close(got, want)
