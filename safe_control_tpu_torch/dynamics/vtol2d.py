"""VTOL2D: X=[x, z, theta, vx, vz, w], U=[d_front, d_rear, d_pusher, d_elev].

Port of ``safe_control_tpu/dynamics/vtol2d.py``, batched over any leading
axes: ``x`` is ``(..., 6)`` and ``u`` is ``(..., 4)``.  The full 2-D aero:
body-frame velocity and angle of attack, the sigmoid-blended linear /
flat-plate lift (exponents clamped to +-40), lift, drag and moment, the
wind-to-inertial rotation by theta + alpha, and three linear rotors.  ``f``
is the unforced (delta_e = 0) aero plus gravity; the columns of ``g`` are
the rotor partials and the elevator's delta_e = 1 aero increment.

VTOL is MPC-only: ``nominal_input``, ``stop`` and ``rotate_to`` return
zeros, and the discrete barrier is the relative-degree-2 circle.

Divisions by the mass and the inertia are products with their reciprocals,
and ``g u`` is summed column by column, so that the fused kernel's model
(``csrc/mpc_fused_models.h``) can repeat every rounding on the card.
"""

from __future__ import annotations

import math

import torch

from safe_control_tpu_torch.barriers.geometry import h_circle
from safe_control_tpu_torch.dynamics.base import angle_normalize, masked_apply, spec_vector

N_STATES = 6
N_CONTROLS = 4
REL_DEG = 2

GRAVITY = 9.81


def _body_velocity(xdot, zdot, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return c * xdot + s * zdot, -s * xdot + c * zdot


def _airspeed_and_alpha(x):
    u_b, w_b = _body_velocity(x[..., 3], x[..., 4], x[..., 2])
    return torch.sqrt(u_b * u_b + w_b * w_b), torch.atan2(-w_b, u_b)


def _lift_blending(alpha, spec):
    """Sigmoid-blended linear / flat-plate lift coefficient.  The exponents
    are clamped to +-40 so that near-zero airspeed cannot give inf / inf."""
    cl_lin = spec.c_l0 + spec.c_lalpha * alpha
    cl_nl = 2.0 * torch.sin(alpha) * torch.cos(alpha)
    t1 = torch.exp(torch.clamp(-spec.m_blend * (alpha - spec.alpha_0), -40.0, 40.0))
    t2 = torch.exp(torch.clamp(spec.m_blend * (alpha + spec.alpha_0), -40.0, 40.0))
    sigma = (1.0 + t1 + t2) / ((1.0 + t1) * (1.0 + t2))
    return (1.0 - sigma) * cl_lin + sigma * cl_nl


def _lift_drag_moment(V, alpha, delta_e, spec):
    cl = _lift_blending(alpha, spec) + spec.c_ldelta_e * delta_e
    cd = spec.c_d0 + spec.c_dalpha * (alpha * alpha) + spec.c_ddelta_e * delta_e
    cm = spec.c_m0 + spec.c_malpha * alpha + spec.c_mdelta_e * delta_e
    qbar = 0.5 * spec.rho_air * (V * V)
    return (
        qbar * spec.s_wing * cl,
        qbar * spec.s_wing * cd,
        qbar * spec.s_wing * cm * spec.chord,
    )


def _wind_to_inertial(theta, alpha, fx_w, fz_w):
    h = theta + alpha
    c, s = torch.cos(h), torch.sin(h)
    return c * fx_w - s * fz_w, s * fx_w + c * fz_w


def f(x, spec):
    theta = x[..., 2]
    V, alpha = _airspeed_and_alpha(x)
    L0, D0, M0 = _lift_drag_moment(V, alpha, 0.0, spec)
    fx_a, fz_a = _wind_to_inertial(theta, alpha, -D0, L0)
    inv_m, inv_i = 1.0 / spec.mass, 1.0 / spec.inertia
    return torch.stack(
        [
            x[..., 3],
            x[..., 4],
            x[..., 5],
            fx_a * inv_m,
            (fz_a - spec.mass * GRAVITY) * inv_m,
            M0 * inv_i,
        ],
        dim=-1,
    )


def g(x, spec):
    """(..., 6, 4): rows 0-2 zero; rows 3-5 the force / moment partials."""
    theta = x[..., 2]
    V, alpha = _airspeed_and_alpha(x)
    c, s = torch.cos(theta), torch.sin(theta)
    inv_m, inv_i = 1.0 / spec.mass, 1.0 / spec.inertia
    # Rotors: front/rear along +body_z, pusher along +body_x.
    fx = [-s * spec.k_front, -s * spec.k_rear, c * spec.k_pusher]
    fz = [c * spec.k_front, c * spec.k_rear, s * spec.k_pusher]
    mom = [spec.ell_f * spec.k_front / spec.inertia,
           -spec.ell_r * spec.k_rear / spec.inertia, 0.0]
    # Elevator partial: the delta_e = 1 aero increment.
    L_de, D_de, M_de = _lift_drag_moment(V, alpha, 1.0, spec)
    fx_e, fz_e = _wind_to_inertial(theta, alpha, -D_de, L_de)
    zero = torch.zeros_like(theta)
    rows = [
        [zero] * 4, [zero] * 4, [zero] * 4,
        [v * inv_m for v in fx] + [fx_e * inv_m],
        [v * inv_m for v in fz] + [fz_e * inv_m],
        [torch.full_like(theta, v) for v in mom] + [M_de * inv_i],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def step(x, u, spec, dt):
    """Euler step, g u summed left to right over the controls; theta wrapped."""
    gm = g(x, spec)
    gu = gm[..., 0] * u[..., None, 0]
    for j in range(1, N_CONTROLS):
        gu = gu + gm[..., j] * u[..., None, j]
    x = x + (f(x, spec) + gu) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(x, goal, spec):
    # VTOL is MPC-only; the reference returns zeros.
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def stop(x, spec):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def has_stopped(x, spec, tol=0.05):
    return torch.linalg.vector_norm(x[..., 3:5], dim=-1) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    return torch.zeros(x.shape[:-1] + (N_CONTROLS,), dtype=x.dtype, device=x.device)


def dt_h(x, obs, spec):
    return h_circle(x[..., :2], obs, spec.radius, spec.cbf_beta)


def u_lb(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.throttle_min] * 3 + [spec.elevator_min], device=device, dtype=dtype)


def u_ub(spec, *, device=None, dtype=torch.float32):
    return spec_vector([spec.throttle_max] * 3 + [spec.elevator_max], device=device, dtype=dtype)


def state_bounds(spec, *, device=None, dtype=torch.float32):
    """MPC state bounds on pitch (radians), vx and vz."""
    inf = float("inf")
    pitch = spec.pitch_max * math.pi / 180.0
    return (
        torch.tensor([-inf, -inf, -pitch, -spec.v_max, -spec.descent_speed_max, -inf],
                     device=device, dtype=dtype),
        torch.tensor([inf, inf, pitch, spec.v_max, inf, inf], device=device, dtype=dtype),
    )


def barrier_pos(x):
    return x[..., :2]
