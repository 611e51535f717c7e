"""The port's entry points: batched control steps on its main paths.

``build_step`` is the counterpart of ``__graft_entry__._build_step``: the
same configuration (horizon 8, K=5 obstacle slots, the 8 outer x 3 Newton
budget) and the same inputs, drawn from ``np.random.default_rng(0)`` in the
same order, so the arrays equal the JAX ones bit for bit.  The step solves
through ``mpc_cbf.solve_batch`` and integrates with ``model.step``; on a
CUDA device with ``use_fused_kernel=True`` that launches the fused CUDA
kernel.

``build_fused_step`` is one batched MPC-CBF control step through
``mpc_cbf.solve_dispatch``, Quad3D at N=10 by default: on a CUDA device
with ``use_fused_kernel=True`` the solve is one launch of the generic fused
kernel (``solvers/mpc_fused.py``).

``build_cbf_qp_step`` is one batched CBF-QP safety-filter step
(DoubleIntegrator2D by default, K=5, 1600 ADMM iterations): nominal input,
``cbf_qp.solve_batch``, integrate.  With ``backend='auto'`` a CUDA float32
batch of 128 or more launches the QP ADMM kernel.  The JAX package has no
such entry; its tests compose the same step from JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_tpu_torch.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    QUAD_3D,
    make_spec,
)
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers import cbf_qp, mpc_cbf

DT = 0.05

# The CBF-QP step's obstacles: two circles and one superellipsoid.
CBF_QP_OBSTACLES = [
    [3.0, 3.0, 0.4, 0.0, 0.0, 0.0, 0.0],
    [2.0, 4.0, 0.3, 0.0, 0.0, 0.0, 0.0],
    [1.5, 2.5, 0.5, 0.3, 4.0, 0.4, 1.0],
]


def build_step(batch, horizon=8, num_obs=5, *, device="cuda", dtype=torch.float32,
               use_fused_kernel=True):
    """Return ``(control_step, (xs, goals, obs, u_prevs, Us))``.

    ``control_step(xs, goals, obs, u_prevs, Us)`` returns
    ``(x_next, u, U)``: the integrated next states, the first controls and
    the solved control trajectories (the next step's warm start).
    """
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    model = get_model(DYNAMIC_UNICYCLE_2D)
    cfg = mpc_cbf.MPCConfig(
        horizon=horizon, num_obs=num_obs, use_fused_kernel=use_fused_kernel
    )
    n_con = mpc_cbf._num_constraints(model, cfg)

    def control_step(xs, goals, obs, u_prevs, Us):
        """One batched MPC-CBF control step: solve + integrate."""
        lam = torch.zeros((xs.shape[0], n_con), device=xs.device, dtype=xs.dtype)
        st = mpc_cbf.MPCState(U=Us, lam=lam)
        res = mpc_cbf.solve_batch(
            DYNAMIC_UNICYCLE_2D, spec, xs, goals, obs, u_prevs, st, DT, cfg
        )
        x_next = model.step(xs, res.u, spec, DT)
        return x_next, res.u, res.state.U

    rng = np.random.default_rng(0)
    xs_np = np.concatenate(
        [
            rng.uniform(0, 4, (batch, 2)),
            rng.uniform(-np.pi, np.pi, (batch, 1)),
            rng.uniform(0, 0.8, (batch, 1)),
        ],
        axis=1,
    )
    xs = torch.as_tensor(xs_np, dtype=dtype, device=device)
    goals = torch.tensor([5.0, 5.0, 0.0, 0.0], dtype=dtype, device=device).repeat(batch, 1)
    obs_one = pad_obstacles(
        [[3.0, 3.0, 0.4, 0, 0, 0, 0], [2.0, 4.0, 0.3, 0, 0, 0, 0]],
        num_obs, device=device, dtype=dtype,
    )
    obs = obs_one[None].repeat(batch, 1, 1)
    u_prevs = torch.zeros((batch, 2), dtype=dtype, device=device)
    Us = torch.zeros((batch, horizon, 2), dtype=dtype, device=device)
    return control_step, (xs, goals, obs, u_prevs, Us)


def build_fused_step(batch, model_name=QUAD_3D, horizon=10, num_obs=5, *, device="cuda",
                     dtype=torch.float32, use_fused_kernel=True):
    """Return ``(control_step, (xs, goals, obs, u_prevs, Us))``.

    ``control_step(xs, goals, obs, u_prevs, Us)`` solves through
    ``mpc_cbf.solve_dispatch`` at the MPCConfig defaults (8 outer x 3 Newton)
    and integrates with ``model.step``; it returns ``(x_next, u, U)``.

    Quad3D inputs from ``np.random.default_rng(0)``: x, y uniform in [0, 3],
    z uniform in [4.5, 5.5], every other component 0; goal (6, 2, 5, 0, ...);
    the obstacle circle (3, 1, 0.5) padded with dummies to ``num_obs``.
    DynamicUnicycle2D takes ``build_step``'s inputs, so that this path and
    the DU kernel's see the same problems.
    """
    spec = make_spec(model_name, a_max=1.0, w_max=0.5) if model_name == DYNAMIC_UNICYCLE_2D \
        else make_spec(model_name)
    model = get_model(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=horizon, num_obs=num_obs, use_fused_kernel=use_fused_kernel)
    n_con = mpc_cbf._num_constraints(model, cfg)

    def control_step(xs, goals, obs, u_prevs, Us):
        """One batched MPC-CBF control step: solve + integrate."""
        lam = torch.zeros((xs.shape[0], n_con), device=xs.device, dtype=xs.dtype)
        st = mpc_cbf.MPCState(U=Us, lam=lam)
        res = mpc_cbf.solve_dispatch(model_name, spec, xs, goals, obs, u_prevs, st, DT, cfg)
        x_next = model.step(xs, res.u, spec, DT)
        return x_next, res.u, res.state.U

    if model_name == DYNAMIC_UNICYCLE_2D:
        _, args = build_step(batch, horizon, num_obs, device=device, dtype=dtype)
        return control_step, args
    if model_name != QUAD_3D:
        raise ValueError(f"build_fused_step has inputs for Quad3D and DynamicUnicycle2D, "
                         f"not {model_name}")
    rng = np.random.default_rng(0)
    n, m = model.N_STATES, model.N_CONTROLS
    xs_np = np.zeros((batch, n))
    xs_np[:, :2] = rng.uniform(0, 3, (batch, 2))
    xs_np[:, 2] = rng.uniform(4.5, 5.5, batch)
    xs = torch.as_tensor(xs_np, dtype=dtype, device=device)
    goal = torch.zeros(n, dtype=dtype, device=device)
    goal[:3] = torch.tensor([6.0, 2.0, 5.0], dtype=dtype, device=device)
    goals = goal.repeat(batch, 1)
    obs_one = pad_obstacles([[3.0, 1.0, 0.5, 0, 0, 0, 0]], num_obs, device=device, dtype=dtype)
    obs = obs_one[None].repeat(batch, 1, 1)
    u_prevs = torch.zeros((batch, m), dtype=dtype, device=device)
    Us = torch.zeros((batch, horizon, m), dtype=dtype, device=device)
    return control_step, (xs, goals, obs, u_prevs, Us)


def build_cbf_qp_step(batch, num_obs=5, *, device="cuda", dtype=torch.float32,
                      model_name=DOUBLE_INTEGRATOR_2D, mode="cbf", iters=1600,
                      backend="auto"):
    """Return ``(control_step, (xs, goals, obs))``.

    ``control_step(xs, goals, obs)`` returns ``(x_next, u, feasible, h_min)``.
    Inputs from ``np.random.default_rng(0)``: positions uniform in [0, 4]^2,
    the remaining state components uniform in [-0.5, 0.5], goal (5, 5); the
    obstacles are ``CBF_QP_OBSTACLES`` padded with dummies to ``num_obs``.
    """
    spec = make_spec(model_name)
    model = get_model(model_name)

    def control_step(xs, goals, obs):
        """One batched CBF-QP control step: nominal input, filter, integrate."""
        u_ref = model.nominal_input(xs, goals, spec)
        res = cbf_qp.solve_batch(model_name, spec, xs, u_ref, obs, DT,
                                 backend=backend, mode=mode, iters=iters)
        x_next = model.step(xs, res.u, spec, DT)
        return x_next, res.u, res.feasible, res.h_min

    rng = np.random.default_rng(0)
    n = model.N_STATES
    xs_np = np.concatenate(
        [rng.uniform(0, 4, (batch, 2)), rng.uniform(-0.5, 0.5, (batch, n - 2))], axis=1
    )
    xs = torch.as_tensor(xs_np, dtype=dtype, device=device)
    goals = torch.zeros((batch, n), dtype=dtype, device=device)
    goals[:, :2] = 5.0
    obs_one = pad_obstacles(CBF_QP_OBSTACLES, num_obs, device=device, dtype=dtype)
    obs = obs_one[None].repeat(batch, 1, 1)
    return control_step, (xs, goals, obs)
