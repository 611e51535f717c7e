"""Discrete-time HOCBF values (port of the ``dt_*`` half of ``barriers/hocbf.py``).

h_k, dh = h(x1) - h(x0), ddh = h(x2) - 2 h(x1) + h(x0) with
x1 = step(x0, u), x2 = step(x1, u).  The continuous-time ``ct_*`` rows
belong to the CBF-QP path and are not ported yet.
"""

from __future__ import annotations

from types import ModuleType

from safe_control_tpu_torch.barriers import geometry
from safe_control_tpu_torch.core import spec as spec_mod


def dt_h(model: ModuleType, model_name: str, x, obs, spec):
    """Discrete-time barrier value used inside the MPC rollout.

    Unicycle2D uses the plain circle; other models switch circle or
    superellipsoid by the obstacle flag.  Broadcasts ``x (..., n)`` against
    ``obs (..., 7)``.
    """
    if hasattr(model, "dt_h"):
        return model.dt_h(x, obs, spec)
    p = model.barrier_pos(x)
    if model_name == spec_mod.UNICYCLE_2D:
        return geometry.h_circle(p, obs, spec.radius, spec.cbf_beta)
    return geometry.h_point(p, obs, spec.radius, spec.cbf_beta)


def dt_hocbf_value(model: ModuleType, model_name: str, x, u, obs, spec, dt):
    """Discrete-time HOCBF constraint value (>= 0 required).

    r=1: dh + alpha h_k;  r=2: ddh + (a1+a2) dh + a1 a2 h_k.
    """
    h_fn = lambda xx: dt_h(model, model_name, xx, obs, spec)
    h_k = h_fn(x)
    x1 = model.step(x, u, spec, dt)
    h_k1 = h_fn(x1)
    if model.REL_DEG == 1:
        return (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k
    x2 = model.step(x1, u, spec, dt)
    h_k2 = h_fn(x2)
    d_h = h_k1 - h_k
    dd_h = h_k2 - 2.0 * h_k1 + h_k
    a1, a2 = spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2
    return dd_h + (a1 + a2) * d_h + a1 * a2 * h_k
