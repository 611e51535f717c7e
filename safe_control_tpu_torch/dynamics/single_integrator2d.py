"""SingleIntegrator2D: X=[x, y], U=[vx, vy], relative degree 1.

Port of ``safe_control_tpu/dynamics/single_integrator2d.py``, batched over
any leading axes: ``x`` is ``(..., 2)`` and ``u`` is ``(..., 2)``.
``u_lb``/``u_ub`` also take a batched spec (``(B,)`` tensor fields).
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.dynamics.base import spec_vector

N_STATES = 2
N_CONTROLS = 2
REL_DEG = 1


def f(x, spec):
    return torch.zeros_like(x)


def g(x, spec):
    eye = torch.eye(N_STATES, dtype=x.dtype, device=x.device)
    return eye.expand(x.shape[:-1] + (N_STATES, N_CONTROLS))


def step(x, u, spec, dt):
    return x + u * dt


def nominal_input(x, goal, spec, d_min=0.05, k_v=1.0):
    pos_err = goal[..., :2] - x[..., :2]
    pos_err = torch.sign(pos_err) * torch.clamp_min(torch.abs(pos_err) - d_min, 0.0)
    v_des = k_v * pos_err
    v_mag = torch.sqrt(v_des[..., 0] * v_des[..., 0] + v_des[..., 1] * v_des[..., 1])
    scale = torch.where(v_mag > spec.v_max, spec.v_max / torch.clamp_min(v_mag, 1e-9),
                        torch.ones_like(v_mag))
    return v_des * scale[..., None]


def stop(x, spec):
    return torch.zeros_like(x)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.v_max, -spec.v_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.v_max, spec.v_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    inf = float("inf")
    return (
        torch.full((N_STATES,), -inf, device=device, dtype=dtype),
        torch.full((N_STATES,), inf, device=device, dtype=dtype),
    )


def barrier_pos(x):
    return x[..., :2]
