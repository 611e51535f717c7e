"""HOCBF rows and values (port of ``safe_control_tpu/barriers/hocbf.py``).

Continuous time, for the CBF-QP filters: one ``h(x)`` per model and its
derivatives from ``torch.func`` (``grad`` under ``vmap`` over robots and
obstacle slots, the counterpart of ``jax.value_and_grad``):

- relative degree 1:  row  A = dh g,  b = dh f + alpha h
- relative degree 2:  hdot(x) = dh(x) f(x) (drift only),
  row  A = dhdot g,  b = dhdot f + (a1 + a2) hdot + a1 a2 h
- 'hard' mode rows use h/dt (r=1) or h/dt^2 + 2 hdot/dt (r=2).

Discrete time, for the MPC rollout: h_k, dh = h(x1) - h(x0),
ddh = h(x2) - 2 h(x1) + h(x0) with x1 = step(x0, u), x2 = step(x1, u).

The Unicycle2D heading-sigmoid barrier and the multi-row blocks of
Manipulator2D wait for their models (ROADMAP A.5) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from safe_control_tpu_torch.barriers import geometry
from safe_control_tpu_torch.core import spec as spec_mod


def ct_h(model: ModuleType, model_name: str, x, obs, spec):
    """Continuous-time barrier value h(x); broadcasts ``x (..., n)`` against
    ``obs (..., 7)``."""
    if hasattr(model, "ct_h"):
        return model.ct_h(x, obs, spec)
    if model_name == spec_mod.UNICYCLE_2D:
        raise NotImplementedError(
            "ct_h: the Unicycle2D heading-sigmoid barrier is not yet ported "
            "to safe_control_tpu_torch (it comes with the Unicycle2D model)"
        )
    return geometry.h_point(model.barrier_pos(x), obs, spec.radius, spec.cbf_beta)


def tensor_fields(spec) -> dict:
    """The fields of a batched spec that hold tensors."""
    return {
        f.name: getattr(spec, f.name)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)
    }


def ct_terms(model: ModuleType, model_name: str, x, obs, spec):
    """``(h, hdot, grad)`` of the continuous-time barrier, elementwise.

    ``grad`` is dh/dx for relative degree 1 (``hdot`` is then None) and
    dhdot/dx for relative degree 2.  ``x (..., n)`` and ``obs (..., 7)``
    broadcast against each other and against the tensor fields of a batched
    spec; the result carries the broadcast leading shape.
    """
    fields = tensor_fields(spec)
    lead = torch.broadcast_shapes(
        x.shape[:-1], obs.shape[:-1], *(v.shape for v in fields.values())
    )
    n = x.shape[-1]
    names = list(fields)

    def flat(t, tail):
        return t.expand(lead + tail).reshape((-1,) + tail)

    def one(xx, oo, *vals):
        s = spec.replace(**dict(zip(names, vals))) if names else spec
        h_fn = lambda z: ct_h(model, model_name, z, oo, s)
        if model.REL_DEG == 1:
            dh, h = torch.func.grad_and_value(h_fn)(xx)
            return h, dh
        hdot_fn = lambda z: (torch.func.grad(h_fn)(z) * model.f(z, s)).sum(-1)
        dhd, hdot = torch.func.grad_and_value(hdot_fn)(xx)
        return h_fn(xx), hdot, dhd

    out = torch.func.vmap(one)(
        flat(x, (n,)), flat(obs, (obs.shape[-1],)), *(flat(v, ()) for v in fields.values())
    )
    h = out[0].reshape(lead)
    grad = out[-1].reshape(lead + (n,))
    hdot = out[1].reshape(lead) if model.REL_DEG == 2 else None
    return h, hdot, grad


def ct_cbf_row(model: ModuleType, model_name: str, x, obs, spec, dt, mode="cbf"):
    """Continuous-time CBF-QP rows ``(A_row (..., m), b (...))``: ``A_row u + b >= 0``.

    Broadcasts as :func:`ct_terms`.  Products with f and g are written as
    elementwise sums, so no matrix product (and no TF32) is involved.
    """
    h, hdot, grad = ct_terms(model, model_name, x, obs, spec)
    f_x = model.f(x, spec)
    g_x = model.g(x, spec)
    a_row = (grad[..., :, None] * g_x).sum(-2)
    b_f = (grad * f_x).sum(-1)
    if model.REL_DEG == 1:
        if mode == "hard":
            return a_row, h / dt + b_f
        return a_row, b_f + spec.cbf_alpha * h
    if mode == "hard":
        return a_row, h / dt**2 + 2.0 * hdot / dt + b_f
    gamma1 = spec.cbf_alpha1 + spec.cbf_alpha2
    gamma2 = spec.cbf_alpha1 * spec.cbf_alpha2
    return a_row, b_f + gamma1 * hdot + gamma2 * h


def ct_cbf_rows_multi(model: ModuleType, x, obs, spec, dt, mode="cbf"):
    """Multi-row r=1 CBF blocks (Manipulator2D's link circles)."""
    raise NotImplementedError(
        "ct_cbf_rows_multi: multi-row barriers (Manipulator2D) are not yet ported "
        "to safe_control_tpu_torch (they come with the Manipulator2D model)"
    )


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
