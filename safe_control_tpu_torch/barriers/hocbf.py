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

Model-specific shapes: Unicycle2D's continuous-time barrier subtracts the
heading sigmoid and its discrete-time one is the plain circle; the C3BF and
DPCBF bicycles bring their own ``ct_h`` / ``dt_h``; Manipulator2D's link
circles give a block of rows per obstacle (``ct_cbf_rows_multi``).
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from safe_control_tpu_torch.barriers import geometry
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.dynamics import unicycle2d


def ct_h(model: ModuleType, model_name: str, x, obs, spec):
    """Continuous-time barrier value h(x); broadcasts ``x (..., n)`` against
    ``obs (..., 7)``."""
    if hasattr(model, "ct_h"):
        return model.ct_h(x, obs, spec)
    p = model.barrier_pos(x)
    h = geometry.h_point(p, obs, spec.radius, spec.cbf_beta)
    if model_name == spec_mod.UNICYCLE_2D:
        s = ((p[..., 0] - obs[..., 0]) * torch.cos(x[..., 2])
             + (p[..., 1] - obs[..., 1]) * torch.sin(x[..., 2]))
        h = h - unicycle2d.sigma(s)
    return h


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
    """Multi-row r=1 CBF blocks ``(A (..., C, m), b (..., C))`` for one
    obstacle, for models with ``ct_multi_h(x, obs, spec) -> (..., C)``
    (Manipulator2D's link circles): row j is A_j = dh_j g and
    b_j = dh_j f + alpha h_j, or h_j/dt + dh_j f in 'hard' mode.  The
    Jacobian is ``torch.func.jacfwd`` under ``vmap``; ``x`` and ``obs``
    broadcast as in :func:`ct_terms` (a spec of plain floats).
    """
    if tensor_fields(spec):
        raise ValueError("ct_cbf_rows_multi takes a spec of plain floats, not per-robot tensors")
    lead = torch.broadcast_shapes(x.shape[:-1], obs.shape[:-1])
    n = x.shape[-1]
    xf = x.expand(lead + (n,)).reshape(-1, n)
    of = obs.expand(lead + (obs.shape[-1],)).reshape(-1, obs.shape[-1])

    def one(xx, oo):  # (dh/dx (C, n), h (C,)) of one state and obstacle
        return torch.func.jacfwd(lambda z: (model.ct_multi_h(z, oo, spec),) * 2,
                                 has_aux=True)(xx)

    Jh, h = torch.func.vmap(one)(xf, of)
    C = h.shape[-1]
    h = h.reshape(lead + (C,))
    Jh = Jh.reshape(lead + (C, n))
    f_x = model.f(x, spec)[..., None, :]
    g_x = model.g(x, spec)[..., None, :, :]
    a_rows = (Jh[..., :, :, None] * g_x).sum(-2)
    b_f = (Jh * f_x).sum(-1)
    if mode == "hard":
        return a_rows, h / dt + b_f
    return a_rows, b_f + spec.cbf_alpha * h


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
