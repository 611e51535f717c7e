"""Port parity: barrier values and the discrete-time HOCBF value.

Random positions from a numpy seed against circle, superellipsoid and dummy
obstacle rows, in float64; values must agree with the JAX package to
rtol 1e-10.  The superellipsoid branch is evaluated (and not selected) on
circle and dummy rows, so values and ``torch.func.jacfwd`` derivatives must
stay finite there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_tpu.barriers import geometry as jgeo
from safe_control_tpu.barriers import hocbf as jhocbf
from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
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
