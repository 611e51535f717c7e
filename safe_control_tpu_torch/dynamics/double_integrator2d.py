"""DoubleIntegrator2D: X=[x, y, vx, vy], U=[ax, ay], relative degree 2.

Port of ``safe_control_tpu/dynamics/double_integrator2d.py``, batched over
any leading axes: ``x`` is ``(..., 4)`` and ``u`` is ``(..., 2)``.
``u_lb``/``u_ub`` also take a batched spec (``(B,)`` tensor fields).
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.dynamics.base import masked_apply, spec_vector

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def _norm2(v):
    """Euclidean norm over a last axis of 2, summed as ``v0^2 + v1^2``."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _cap(v, v_mag, cap):
    """Scale ``v`` down to norm ``cap`` where its norm ``v_mag`` exceeds it."""
    scale = torch.where(v_mag > cap, cap / torch.clamp_min(v_mag, 1e-9),
                        torch.ones_like(v_mag))
    return v * scale[..., None]


def f(x, spec):
    zero = torch.zeros_like(x[..., 0])
    return torch.stack([x[..., 2], x[..., 3], zero, zero], dim=-1)


def g(x, spec):
    gm = torch.tensor(
        [[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], dtype=x.dtype, device=x.device
    )
    return gm.expand(x.shape[:-1] + (N_STATES, N_CONTROLS))


def step(x, u, spec, dt):
    # g @ u as an elementwise product and sum: exact, and never a TF32 matmul.
    gu = (g(x, spec) * u[..., None, :]).sum(-1)
    x = x + (f(x, spec) + gu) * dt
    # Velocity-magnitude clamp, branch-free.
    return masked_apply(x, lambda v: _cap(v, _norm2(v), spec.v_max), 2, 4)


def nominal_input(x, goal, spec, d_min=0.05):
    pos_err = goal[..., :2] - x[..., :2]
    pos_err = torch.sign(pos_err) * torch.clamp_min(torch.abs(pos_err) - d_min, 0.0)
    v_des = spec.nominal_k_v * pos_err
    v_des = _cap(v_des, _norm2(v_des), spec.v_max)
    a = spec.nominal_k_a * (v_des - x[..., 2:4])
    return _cap(a, _norm2(a), spec.a_max)


def stop(x, spec):
    return spec.nominal_k_a * (0.0 - x[..., 2:4])


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.ax_max, -spec.ay_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.ax_max, spec.ay_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (
        torch.full((N_STATES,), -inf, device=device, dtype=dtype),
        torch.full((N_STATES,), inf, device=device, dtype=dtype),
    )


def barrier_pos(x):
    return x[..., :2]
