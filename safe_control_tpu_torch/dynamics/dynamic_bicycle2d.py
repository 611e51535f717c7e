"""DynamicBicycle2D: the Fiala brush-tire model for high-slip (drifting) motion.

Port of ``safe_control_tpu/dynamics/dynamic_bicycle2d.py``, batched over any
leading axes: X = [r, beta, V, delta, tau] (body-fixed), U = [delta_dot,
tau_dot].  The slip angles carry the ``V >= 0.1`` guard; the Fiala lateral
force selects its linear or saturated branch with ``torch.where`` (the
tangent is the chosen branch's, as ``jnp.where``'s); the longitudinal force
saturates by ``tanh``; the Euler step ends in the 5-way state clamp.

Every ``jnp.maximum`` / ``jnp.clip`` is ``torch.maximum`` / ``minimum``
against a tensor, whose derivative at a tie is 0.5 as JAX's.  A division by
a spec constant is a product with its reciprocal and powers are products,
so that the fused kernel's model (``csrc/mpc_fused_models.h``) can repeat
every rounding.  The friction ``spec.mu`` may be a float or a tensor (the
drift simulator's plant friction), as may any other spec field.
"""

from __future__ import annotations

import torch

from safe_control_tpu_torch.dynamics.base import spec_vector
from safe_control_tpu_torch.dynamics.kinematic_bicycle2d import clip_tie, max_tie

N_STATES = 5
N_CONTROLS = 2
REL_DEG = 2  # not used: the model runs under shielding, not CBF-QP

GRAVITY = 9.81


def normal_forces(spec):
    """Static axle normal forces (Fz_f, Fz_r)."""
    L = spec.a_cg + spec.b_cg
    Fz_f = spec.mass * GRAVITY * spec.b_cg / L
    Fz_r = spec.mass * GRAVITY * spec.a_cg / L
    return Fz_f, Fz_r


def slip_angles(r, beta, V, delta, spec):
    """Front and rear slip angles with the V >= 0.1 guard."""
    V_safe = max_tie(V, 0.1)
    cb = torch.cos(beta)
    sb = torch.sin(beta)
    alpha_f = torch.atan2(V * sb + spec.a_cg * r, V_safe * cb) - delta
    alpha_r = torch.atan2(V * sb - spec.b_cg * r, V_safe * cb)
    return alpha_f, alpha_r


def lateral_force(alpha, Cc, Fz, Fx, spec):
    """The Fiala brush model with the friction circle, branch by ``where``."""
    mu_fz = spec.mu * Fz
    Fy_max = torch.sqrt(max_tie(mu_fz * mu_fz - spec.gamma_stab * (Fx * Fx), 1.0))
    alpha_sl = torch.atan((3.0 * Fy_max) * (1.0 / Cc))
    tan_a = torch.tan(alpha)
    Fy_linear = (
        (-Cc) * tan_a
        + ((Cc * Cc) / (3.0 * Fy_max)) * torch.abs(tan_a) * tan_a
    ) - ((Cc * Cc * Cc) / (27.0 * (Fy_max * Fy_max))) * (tan_a * tan_a * tan_a)
    Fy_sat = (-Fy_max) * torch.sign(alpha)
    return torch.where(torch.abs(alpha) < alpha_sl, Fy_linear, Fy_sat)


def longitudinal_force(tau, Fz, spec):
    """tanh soft saturation at the friction limit."""
    F_lim = spec.mu * Fz
    if isinstance(F_lim, torch.Tensor):
        F_lim_safe = max_tie(F_lim, 1.0)
    else:
        F_lim_safe = max(F_lim, 1.0)
    return F_lim * torch.tanh(tau * (1.0 / (spec.r_w * F_lim_safe)))


def tire_forces(r, beta, V, delta, tau, spec):
    """(Fx_f, Fy_f, Fx_r, Fy_r): rear-wheel drive, no front drive force."""
    alpha_f, alpha_r = slip_angles(r, beta, V, delta, spec)
    Fz_f, Fz_r = normal_forces(spec)
    Fx_f = torch.zeros_like(tau)
    Fx_r = longitudinal_force(tau, Fz_r, spec)
    Fy_f = lateral_force(alpha_f, spec.cc_f, Fz_f, Fx_f, spec)
    Fy_r = lateral_force(alpha_r, spec.cc_r, Fz_r, Fx_r, spec)
    return Fx_f, Fy_f, Fx_r, Fy_r


def _rates(x, spec):
    """(r_dot, beta_dot, V_dot) of the body state ``x (..., 5)``."""
    r, beta, V, delta, tau = (x[..., i] for i in range(5))
    Fx_f, Fy_f, Fx_r, Fy_r = tire_forces(r, beta, V, delta, tau, spec)
    V_safe = max_tie(V, 0.1)
    sd, cd = torch.sin(delta), torch.cos(delta)
    sdb, cdb = torch.sin(delta - beta), torch.cos(delta - beta)
    sb, cb = torch.sin(beta), torch.cos(beta)
    r_dot = (spec.a_cg * (Fx_f * sd + Fy_f * cd) - spec.b_cg * Fy_r) * (1.0 / spec.izz)
    beta_dot = (
        ((Fx_f * sdb + Fy_f * cdb) - Fx_r * sb) + Fy_r * cb
    ) / (spec.mass * V_safe) - r
    V_dot = (((Fx_f * cdb - Fy_f * sdb) + Fx_r * cb) + Fy_r * sb) * (1.0 / spec.mass)
    return r_dot, beta_dot, V_dot


def f(x, spec):
    r_dot, beta_dot, V_dot = _rates(x, spec)
    zero = torch.zeros_like(r_dot)
    return torch.stack([r_dot, beta_dot, V_dot, zero, zero], dim=-1)


def g(x, spec):
    zero = torch.zeros_like(x[..., 0])
    one = torch.ones_like(zero)
    rows = [[zero, zero]] * 3 + [[one, zero], [zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def clamp_state(parts, spec):
    """The 5-way state clamp of the components ``(r, beta, V, delta, tau)``."""
    r, beta, V, delta, tau = parts
    return torch.stack([
        clip_tie(r, -spec.r_max, spec.r_max),
        clip_tie(beta, -spec.beta_max, spec.beta_max),
        clip_tie(V, spec.v_min, spec.v_max),
        clip_tie(delta, -spec.delta_max, spec.delta_max),
        clip_tie(tau, -spec.tau_max, spec.tau_max),
    ], dim=-1)


def step(x, u, spec, dt):
    """Euler ``x + (f + g u) dt`` component by component, then the clamp."""
    x = x.expand(torch.broadcast_shapes(x.shape, u.shape[:-1] + (N_STATES,)))
    r_dot, beta_dot, V_dot = _rates(x, spec)
    return clamp_state((
        x[..., 0] + r_dot * dt,
        x[..., 1] + beta_dot * dt,
        x[..., 2] + V_dot * dt,
        x[..., 3] + u[..., 0] * dt,
        x[..., 4] + u[..., 1] * dt,
    ), spec)


def nominal_input(x, goal, spec):
    # Needs the global position: the DriftingCar wrapper has the law.
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def stop(x, spec):
    """Brake and centre the steering."""
    return torch.stack([
        -torch.sign(x[..., 3]) * spec.delta_dot_max * 0.5,
        -torch.sign(x[..., 4]) * spec.tau_dot_max * 0.5,
    ], dim=-1)


def has_stopped(x, spec, tol=0.5):
    return torch.abs(x[..., 2]) < tol


def rotate_to(x, theta_des, spec):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def global_velocity(x):
    """Body-frame (vx, vy) from V and beta."""
    return x[..., 2] * torch.cos(x[..., 1]), x[..., 2] * torch.sin(x[..., 1])


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([-spec.delta_dot_max, -spec.tau_dot_max], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.delta_dot_max, spec.tau_dot_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    return (
        spec_vector([-spec.r_max, -spec.beta_max, spec.v_min, -spec.delta_max, -spec.tau_max],
                    device=device, dtype=dtype),
        spec_vector([spec.r_max, spec.beta_max, spec.v_max, spec.delta_max, spec.tau_max],
                    device=device, dtype=dtype),
    )


def barrier_pos(x):
    # The body-fixed state has no global position (DriftingCar has one).
    return x[..., :2] * 0.0

