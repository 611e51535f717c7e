"""Generic fused MPC-CBF solve, one CUDA thread block per problem.

Port of ``safe_control_tpu/solvers/mpc_fused.py``.  The whole
augmented-Lagrangian Gauss-Newton solve of ``mpc_cbf.solve`` — rollout,
forward-mode Jacobians, H = 2 Jr'Jr + rho Jca'Jca, the masked Cholesky, the
six-step noise-aware line search and the multiplier update — runs for any
registered model whose decision vector has M = N m <= 64 entries, in one
kernel launch for the batch (``csrc/mpc_fused_kernel.cu``).  Infinite state
bounds are clamped to +-1e6, as the JAX kernel does.

The CUDA kernel takes the Jacobian columns by forward-mode dual numbers, one
thread per decision variable: thread d rolls the model out on (value,
d/dU_d) pairs, which is what ``torch.func.jvp`` under ``vmap`` over the M
basis tangents computes here in ``solve_fused_batch_reference``, the plain
PyTorch version.  The dual rules are PyTorch's forward-mode formulas, and
every sum of the plain version runs in the kernel's order, so that the two
can agree to rounding on the card.

``solve_fused_batch`` launches the kernel on CUDA float32 tensors and runs
the plain version on CPU tensors.  ``mpc_cbf.solve_dispatch`` routes to it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.barriers.hocbf import dt_h as hocbf_dt_h
from safe_control_tpu_torch.barriers.hocbf import tensor_fields
from safe_control_tpu_torch.core import spec as spec_mod
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.dynamics import quad3d
from safe_control_tpu_torch.solvers import mpc_cbf as mpc_mod
from safe_control_tpu_torch.solvers.chol import chol_factor

# Models with a CUDA instantiation, and their id in the kernel's C entry point.
MODEL_IDS = {
    spec_mod.SINGLE_INTEGRATOR_2D: 0,
    spec_mod.DOUBLE_INTEGRATOR_2D: 1,
    spec_mod.DYNAMIC_UNICYCLE_2D: 2,
    spec_mod.QUAD_3D: 3,
    spec_mod.VTOL_2D: 4,
}
MAX_DECISION = 64  # N * m, as the JAX package's fused_available
BOUND_CLAMP = 1e6  # infinite single-sided state bounds become +-1e6
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)

# Kernel launches made by ``solve_fused_batch`` (CPU calls do not count),
# and calls of ``solve_fused_batch`` on any device.
LAUNCH_COUNT = 0
DISPATCH_COUNT = 0

# The kernel's parameter block on each device, by its values: a call with a
# configuration seen before copies nothing to the card (a copy from pageable
# host memory would make the host wait for the launch before it).
_DEVICE_PARAMS: dict = {}
_DEVICE_PARAMS_MAX = 64


class FusedResult(NamedTuple):
    u: torch.Tensor  # (B, m) first controls
    U: torch.Tensor  # (B, N, m)
    xs: torch.Tensor  # (B, N+1, n) predicted states
    viol: torch.Tensor  # (B,)


def fused_available(model_name: str, cfg: mpc_mod.MPCConfig) -> bool:
    """The JAX package's rule — M = N m <= 64, no optimal decay, no polish,
    no ``newton_f64`` — for a model that has a CUDA instantiation."""
    if model_name not in MODEL_IDS:
        return False
    if cfg.horizon * get_model(model_name).N_CONTROLS > MAX_DECISION:
        return False
    return not cfg.optimal_decay and cfg.polish_iters == 0 and not cfg.newton_f64


class _Problem(NamedTuple):
    """The static structure of one configuration (float64 Python values)."""

    model: object
    n: int
    m: int
    N: int
    K: int
    Q: tuple  # cost weights (state, input move)
    R: tuple
    lbu: tuple
    ubu: tuple
    bounded: tuple  # (state index, clamped lower, clamped upper)


def _problem(model_name, spec, cfg) -> _Problem:
    model = get_model(model_name)
    q, r = mpc_mod._WEIGHTS[model_name]
    lbu = model.u_lb(spec, device="cpu", dtype=torch.float64).tolist()
    ubu = model.u_ub(spec, device="cpu", dtype=torch.float64).tolist()
    lb_x, ub_x = (b.tolist() for b in model.state_bounds(spec, device="cpu", dtype=torch.float64))
    bounded = tuple(
        (i, max(lo, -BOUND_CLAMP), min(hi, BOUND_CLAMP))
        for i, (lo, hi) in enumerate(zip(lb_x, ub_x))
        if math.isfinite(lo) or math.isfinite(hi)
    )
    return _Problem(model, model.N_STATES, model.N_CONTROLS, cfg.horizon, cfg.num_obs,
                    tuple(q), tuple(r), tuple(lbu), tuple(ubu), bounded)


def _warm_start(U_warm):
    """Shift the previous solution by one stage (the clip happens inside)."""
    return torch.cat([U_warm[:, 1:], U_warm[:, -1:]], dim=1)


def _check_inputs(pb: _Problem, xs, goals, obs, u_prevs, U_warm) -> None:
    B = xs.shape[0] if xs.ndim == 2 else -1
    shapes = dict(xs=(B, pb.n), goals=(B, pb.n), obs=(B, pb.K, 7), u_prevs=(B, pb.m),
                  U_warm=(B, pb.N, pb.m))
    for name, t in zip(shapes, (xs, goals, obs, u_prevs, U_warm)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if t.dtype != xs.dtype:
            raise ValueError(f"{name} is {t.dtype}, xs {xs.dtype}")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xs.device}")


def solve_fused_batch(model_name, spec, xs, goals, obs, u_prevs, U_warm, dt,
                      cfg: mpc_mod.MPCConfig) -> FusedResult:
    """Batched fused MPC-CBF solve.

    ``xs`` (B, n), ``goals`` (B, n), ``obs`` (B, K, 7), ``u_prevs`` (B, m)
    and ``U_warm`` (B, N, m), the PREVIOUS solution, which is shifted by one
    stage here as ``mpc_cbf.solve`` does.  ``spec`` holds plain floats.
    CPU tensors go to ``solve_fused_batch_reference``; CUDA tensors must be
    float32 and launch the kernel on the current stream.
    """
    global LAUNCH_COUNT, DISPATCH_COUNT
    DISPATCH_COUNT += 1
    if not fused_available(model_name, cfg):
        raise ValueError(f"the fused kernel does not take {model_name} with {cfg}")
    if tensor_fields(spec):
        raise ValueError("the fused kernel takes a spec of plain floats, not per-robot tensors")
    pb = _problem(model_name, spec, cfg)
    _check_inputs(pb, xs, goals, obs, u_prevs, U_warm)
    if xs.device.type == "cpu":
        return solve_fused_batch_reference(model_name, spec, xs, goals, obs, u_prevs, U_warm,
                                           dt, cfg)
    if xs.dtype != torch.float32:
        raise NotImplementedError(f"the fused CUDA kernel is float32 only, got {xs.dtype}")

    from safe_control_tpu_torch import _build

    lib = _build.load_mpc_fused_kernel()
    B, M = xs.shape[0], pb.N * pb.m
    ins = [t.contiguous() for t in (xs, goals, obs, u_prevs)]
    U0 = _warm_start(U_warm).reshape(B, M).contiguous()
    params = _device_params(kernel_params(model_name, spec, dt, cfg), xs.device)
    U_out = torch.empty((B, M), dtype=torch.float32, device=xs.device)
    xs_out = torch.empty((B, (pb.N + 1) * pb.n), dtype=torch.float32, device=xs.device)
    viol = torch.empty((B,), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.mpc_fused_launch(
            MODEL_IDS[model_name], *(t.data_ptr() for t in ins), U0.data_ptr(),
            params.data_ptr(), U_out.data_ptr(), xs_out.data_ptr(), viol.data_ptr(),
            B, pb.N, pb.K, len(pb.bounded), params.numel(), cfg.outer_iters, cfg.newton_iters,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mpc_fused_kernel launch failed: CUDA error {err}")
    LAUNCH_COUNT += 1
    U = U_out.reshape(B, pb.N, pb.m)
    return FusedResult(u=U[:, 0].contiguous(), U=U, xs=xs_out.reshape(B, pb.N + 1, pb.n),
                       viol=viol)


def _device_params(values: list, device: torch.device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``, made once per values and
    device (the oldest are dropped past ``_DEVICE_PARAMS_MAX``)."""
    key = (tuple(values), device)
    params = _DEVICE_PARAMS.get(key)
    if params is None:
        if len(_DEVICE_PARAMS) >= _DEVICE_PARAMS_MAX:
            del _DEVICE_PARAMS[next(iter(_DEVICE_PARAMS))]
        params = _DEVICE_PARAMS[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return params


def shared_memory_bytes(model_name, spec, dt, cfg) -> int:
    """Dynamic shared memory of one block of the CUDA kernel (asks the
    built library, which sizes the launch by the same layout)."""
    from safe_control_tpu_torch import _build

    return _build.load_mpc_fused_kernel().mpc_fused_shared_bytes(
        *_shape_args(model_name, spec, dt, cfg))


def blocks_per_sm(model_name, spec, dt, cfg) -> int:
    """Blocks of the CUDA kernel that fit on one SM of the current card at
    once, by the CUDA occupancy calculator after the launch's settings."""
    from safe_control_tpu_torch import _build

    blocks = _build.load_mpc_fused_kernel().mpc_fused_blocks_per_sm(
        *_shape_args(model_name, spec, dt, cfg))
    if blocks < 0:
        raise RuntimeError(f"mpc_fused_blocks_per_sm failed: CUDA error {-blocks}")
    return blocks


def _shape_args(model_name, spec, dt, cfg) -> tuple:
    """(model id, N, K, bound rows, parameter count): a configuration as
    the kernel's C entry points take it."""
    pb = _problem(model_name, spec, cfg)
    return (MODEL_IDS[model_name], pb.N, pb.K, len(pb.bounded),
            len(kernel_params(model_name, spec, dt, cfg)))


def solve_fused_single(model_name, spec, x0, goal, obs, u_prev, mpc_state, dt,
                       cfg: mpc_mod.MPCConfig) -> mpc_mod.MPCResult:
    """One robot through ``solve_fused_batch``, with ``mpc_cbf.solve``'s
    result contract: ``x0`` (n,), ``goal`` (n,), ``obs`` (K, 7), ``u_prev``
    (m,), ``mpc_state.U`` (N, m).  ``state.lam`` is reported as zeros,
    which is equivalent because ``solve`` cold-starts the multipliers."""
    res = solve_fused_batch(model_name, spec, x0[None], goal[None], obs[None], u_prev[None],
                            mpc_state.U[None], dt, cfg)
    return mpc_mod.MPCResult(
        u=res.u[0],
        state=mpc_mod.MPCState(U=res.U[0], lam=torch.zeros_like(mpc_state.lam)),
        xs=res.xs[0],
        feasible=res.viol[0] <= cfg.viol_tol,
        viol=res.viol[0],
    )


def _model_params(model_name, spec, dt) -> list:
    """The model's constants as the kernel's model templates read them
    (``csrc/mpc_fused_models.h``), computed in float64 as the PyTorch model
    computes them before they meet a float32 tensor."""
    if model_name == spec_mod.DOUBLE_INTEGRATOR_2D:
        return [spec.v_max]
    if model_name == spec_mod.QUAD_3D:
        rows = [c for row in quad3d.input_rows(spec) for c in row]
        return rows + [dt / 2, dt / 6]
    if model_name == spec_mod.VTOL_2D:
        s = spec
        return [
            s.c_l0, s.c_lalpha, -s.m_blend, s.m_blend, s.alpha_0,
            s.c_ldelta_e * 0.0, s.c_ldelta_e * 1.0,
            s.c_d0, s.c_dalpha, s.c_ddelta_e * 0.0, s.c_ddelta_e * 1.0,
            s.c_m0, s.c_malpha, s.c_mdelta_e * 0.0, s.c_mdelta_e * 1.0,
            0.5 * s.rho_air, s.s_wing, s.chord,
            1.0 / s.mass, 1.0 / s.inertia, s.mass * 9.81,
            s.k_front, s.k_rear, s.k_pusher,
            s.ell_f * s.k_front / s.inertia, -s.ell_r * s.k_rear / s.inertia,
        ]
    return []


def kernel_params(model_name, spec, dt, cfg) -> list:
    """The kernel's float parameter block, in the order ``mpc_fused_kernel.cu``
    reads it: the solver budget, the CBF gains, radius and beta, dt, the cost
    weights, the input box, the clamped state bounds, then the model's own
    constants."""
    pb = _problem(model_name, spec, cfg)
    if pb.model.REL_DEG == 1:
        gains = [spec.mpc_cbf_alpha, 0.0]
    else:
        a1, a2 = spec.mpc_cbf_alpha1, spec.mpc_cbf_alpha2
        gains = [a1 + a2, a1 * a2]
    # sqrt of the weights in float32, as the plain version takes it on float32 tensors
    sqrt32 = [float(np.sqrt(np.float32(w))) for w in pb.Q + pb.R]
    out = [cfg.rho0, cfg.rho_growth, cfg.rho_max, cfg.reg, *gains, spec.radius, spec.cbf_beta,
           dt, *sqrt32, *pb.lbu, *pb.ubu]
    for i, lo, hi in pb.bounded:
        out += [float(i), lo, hi]
    return [float(v) for v in out + _model_params(model_name, spec, dt)]


def _seqsum(terms):
    """Sum a sequence left to right, as the kernel's loops do (their leading
    0 + t is t exactly).  Terms come one at a time: stacking the products
    of H would take (B, M, M, rows) memory."""
    total = None
    for t in terms:
        total = t if total is None else total + t
    return total


def solve_fused_batch_reference(model_name, spec, xs, goals, obs, u_prevs, U_warm, dt,
                                cfg: mpc_mod.MPCConfig) -> FusedResult:
    """Plain PyTorch version of the fused kernel (same inputs and result).

    Runs the JAX kernel's algorithm (``_make_algorithm``) on ``(B, ...)``
    tensors.  Jacobian columns come from ``torch.func.jvp`` under ``vmap``
    over the M basis tangents; every reduction over rows, tangents or
    decision variables is a left-to-right sum in the kernel's order.
    """
    pb = _problem(model_name, spec, cfg)
    model, n, m, N, K = pb.model, pb.n, pb.m, pb.N, pb.K
    M = N * m
    B = xs.shape[0]
    dtype, dev = xs.dtype, xs.device
    tensor = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    Qs, Rs = torch.sqrt(tensor(pb.Q)), torch.sqrt(tensor(pb.R))
    lb, ub = tensor(pb.lbu * N), tensor(pb.ubu * N)
    obs_b = obs[:, None, :, :]  # (B, 1, K, 7): broadcasts over the stage axis
    rel1 = model.REL_DEG == 1
    a12s = spec.mpc_cbf_alpha1 + spec.mpc_cbf_alpha2
    a12p = spec.mpc_cbf_alpha1 * spec.mpc_cbf_alpha2

    def rows(Uf):
        """(residual rows, raw constraint rows, rollout) at ``Uf (..., B, M)``."""
        lead = Uf.shape[:-1]
        U = Uf.reshape(lead + (N, m))
        x = xs.expand(lead + (n,))
        states = [x]
        for k in range(N):
            x = model.step(x, U[..., k, :], spec, dt)
            states.append(x)
        XS = torch.stack(states, dim=-2)  # (..., B, N+1, n)
        state_res = (XS[..., 1:, :] - goals[:, None, :]) * Qs
        prev = torch.cat([u_prevs.expand(lead + (m,))[..., None, :], U[..., :-1, :]], dim=-2)
        input_res = (U - prev) * Rs
        r = torch.cat([state_res.reshape(lead + (N * n,)), input_res.reshape(lead + (M,))], -1)
        Hh = hocbf_dt_h(model, model_name, XS[..., :, None, :], obs_b, spec)  # (..., N+1, K)
        h_k, h_k1 = Hh[..., :N, :], Hh[..., 1:, :]
        if rel1:
            cbf = (h_k1 - h_k) + spec.mpc_cbf_alpha * h_k
        else:
            x2 = model.step(XS[..., 1:, :], U, spec, dt)
            H2 = hocbf_dt_h(model, model_name, x2[..., :, None, :], obs_b, spec)
            cbf = ((H2 - 2.0 * h_k1) + h_k) + a12s * (h_k1 - h_k) + a12p * h_k
        cons = [cbf.reshape(lead + (N * K,))]
        for i, lo, hi in pb.bounded:
            col = XS[..., 1:, i]
            cons += [hi - col, col - lo]
        return r, torch.cat(cons, dim=-1), XS

    # Constraint rows scaled by their Jacobian norm at the clipped warm start.
    Uf = torch.clamp(_warm_start(U_warm).reshape(B, M), lb, ub)
    _, (Jc0,) = mpc_mod._jvp_jacobian(lambda u: (rows(u)[1],), Uf)  # (B, M, NC)
    ssq = _seqsum(Jc0[:, d] * Jc0[:, d] for d in range(M))
    cs = 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-2)
    NC = cs.shape[-1]

    alphas = tensor(ALPHAS)
    noise_eps = 4.0 * torch.finfo(dtype).eps
    M_t = torch.full((B,), float(M), dtype=dtype, device=dev)

    def solve_chol(L, g):
        """L L' x = g by right-looking substitutions, the kernel's order."""
        s, w = g.clone(), []
        for j in range(M):
            w.append(s[:, j] / L[:, j, j])
            s[:, j + 1:] = s[:, j + 1:] - L[:, j + 1:, j] * w[j][:, None]
        t, x = torch.stack(w, dim=-1), [None] * M
        for j in reversed(range(M)):
            x[j] = t[:, j] / L[:, j, j]
            t[:, :j] = t[:, :j] - L[:, j, :j] * x[j][:, None]
        return torch.stack(x, dim=-1)

    def newton_step(Uf, lam, rho):
        def rc(u):
            r, c, _ = rows(u)
            return r, c * cs

        (r0, c0), (Jr, Jc) = mpc_mod._jvp_jacobian(rc, Uf)  # (B, M, NR), (B, M, NC)
        act0 = torch.clamp_min(lam - rho[:, None] * c0, 0.0)
        NR = r0.shape[-1]
        g1 = _seqsum(Jr[:, :, i] * r0[:, i, None] for i in range(NR))
        g2 = _seqsum(Jc[:, :, i] * act0[:, i, None] for i in range(NC))
        grad = 2.0 * g1 - g2
        Jca = Jc * (act0 > 0.0).to(dtype)[:, None, :]
        S1 = _seqsum(Jr[:, :, i, None] * Jr[:, None, :, i] for i in range(NR))
        S2 = _seqsum(Jca[:, :, i, None] * Jca[:, None, :, i] for i in range(NC))
        H = 2.0 * S1 + rho[:, None, None] * S2
        tr = _seqsum(H[:, i, i] for i in range(M))
        damp = cfg.reg * (1.0 + tr / M_t)
        H = H + torch.diag_embed(damp[:, None].expand(B, M))
        # Projected free set: freeze variables at an active bound pushed outward.
        at_lb = (Uf <= lb + 1e-7) & (grad > 0.0)
        at_ub = (Uf >= ub - 1e-7) & (grad < 0.0)
        free = torch.logical_not(at_lb | at_ub)
        eye = torch.eye(M, dtype=dtype, device=dev).expand(B, M, M)
        Hf = torch.where(free[:, :, None] & free[:, None, :], H, eye)
        gf = torch.where(free, grad, torch.zeros_like(grad))
        step = -solve_chol(chol_factor(Hf), gf)

        # Line search on merit differences, all six step lengths at once.
        cand = torch.clamp(Uf + alphas[:, None, None] * step, lb, ub)  # (6, B, M)
        r_a, c_a, _ = rows(cand)
        act_a = torch.clamp_min(lam - rho[:, None] * (c_a * cs), 0.0)
        d_cost = _seqsum((r_a[..., i] - r0[:, i]) * (r_a[..., i] + r0[:, i]) for i in range(NR))
        d_pen = _seqsum((act_a[..., i] - act0[:, i]) * (act_a[..., i] + act0[:, i])
                        for i in range(NC))
        deltas = d_cost + d_pen / (2.0 * rho)
        deltas = torch.where(torch.isfinite(deltas), deltas, torch.full_like(deltas, math.inf))
        best = torch.argmin(deltas, dim=0)  # first index on ties
        # Noise-aware acceptance: below the merit's rounding floor, take the
        # full damped Newton step.
        rr = _seqsum(r0[:, i] * r0[:, i] for i in range(NR))
        aa = _seqsum(act0[:, i] * act0[:, i] for i in range(NC))
        noise_floor = noise_eps * (rr + aa / (2.0 * rho))
        Hs = _seqsum(Hf[:, :, j] * step[:, j, None] for j in range(M))
        pred = _seqsum(gf[:, i] * step[:, i] for i in range(M)) + 0.5 * _seqsum(
            step[:, i] * Hs[:, i] for i in range(M))
        best = torch.where(pred >= -noise_floor, torch.zeros_like(best), best)
        return torch.clamp(Uf + alphas[best][:, None] * step, lb, ub)

    lam = torch.zeros((B, NC), dtype=dtype, device=dev)
    rho = torch.full((B,), cfg.rho0, dtype=dtype, device=dev)
    for _ in range(cfg.outer_iters):
        for _ in range(cfg.newton_iters):
            Uf = newton_step(Uf, lam, rho)
        lam = torch.clamp_min(lam - rho[:, None] * (rows(Uf)[1] * cs), 0.0)
        rho = torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max)
    _, c, XS = rows(Uf)
    viol = torch.clamp_min(-(c * cs).min(dim=-1).values, 0.0)
    U = Uf.reshape(B, N, m)
    return FusedResult(u=U[:, 0].contiguous(), U=U, xs=XS, viol=viol)
