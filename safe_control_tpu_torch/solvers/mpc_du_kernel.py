"""Fused AL-Gauss-Newton MPC-CBF solve for DynamicUnicycle2D, N=8, K=5.

Port of ``safe_control_tpu/solvers/mpc_du_kernel.py``.  The whole solver —
rollout with hand-derived forward tangents, the r=2 CBF rows over the
circle/superellipsoid blend and the v-bound rows, constraint-row scaling at
the warm start, the Gauss-Newton gradient and Hessian as outer products,
the projected free set, a 16x16 Cholesky, the six-step noise-aware line
search and the multiplier update — runs per problem in one CUDA kernel
(``csrc/mpc_du_kernel.cu``): a group of ``LANES`` lanes (a half-warp) per
problem, lane j owning decision variable j, ``PROBLEMS_PER_BLOCK`` problems
to a ``THREADS``-thread block.

``solve_du_batch_reference`` is the plain PyTorch version of that kernel:
the same hand-derived math on ``(B, ...)`` tensors, with no autodiff, and
every sum taken in the kernel's order, so that on the card the two agree to
rounding.  ``solve_du_batch`` takes it for CPU tensors; for CUDA tensors it
launches the kernel, or raises.

The algorithm matches ``solvers/mpc_cbf.solve`` at this configuration up to
the order of operations; the tests hold the two to the same envelope as the
JAX package holds its kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from safe_control_tpu_torch.solvers.chol import chol_solve

N = 8  # horizon
K = 5  # obstacle slots
M = 2 * N  # decision variables
NR = 4 * N + 2 * N  # residual rows: state (8x4) + input moves (8x2)
NC = N * K + 2 * N  # constraint rows: CBF (8x5) + v bounds (8x2)

# Default MPCConfig budget (solvers/mpc_cbf.py).
OUTER = 8
NEWTON = 3
RHO0 = 50.0
RHO_GROWTH = 1.6
RHO_MAX = 2000.0
REG = 1e-6
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)
NOISE_EPS = 4.0 * 1.1920929e-7  # 4 * eps_f32 (noise-aware line search)

# DU cost weights (mpc_cbf._WEIGHTS).
SQ = tuple(math.sqrt(w) for w in (50.0, 50.0, 0.01, 30.0))
SR = tuple(math.sqrt(w) for w in (0.5, 0.5))

# Launch shape of the CUDA kernel (csrc/mpc_du_kernel.h).
LANES = M  # lanes per problem
THREADS = 128  # threads per block
PROBLEMS_PER_BLOCK = THREADS // LANES

# Kernel launches made by ``solve_du_batch`` (CPU calls do not count).
LAUNCH_COUNT = 0


class DuKernelResult(NamedTuple):
    u: torch.Tensor  # (B, 2)
    U: torch.Tensor  # (B, N, 2)
    viol: torch.Tensor  # (B,)


def _f32(x) -> float:
    """``x`` rounded to float32, as the kernel holds it."""
    return float(np.float32(x))


def _input_hess(i: int, j: int) -> float:
    """Entry (i, j) of the constant 2 Jr_in' Jr_in of the input-move rows."""
    if i == j:
        k, jj = i // 2, i % 2
        cnt = 1 + (1 if k < N - 1 else 0)
        return 2.0 * SR[jj] ** 2 * cnt
    lo, hi = min(i, j), max(i, j)
    if hi - lo == 2 and (lo % 2) == (hi % 2):
        return -2.0 * SR[lo % 2] ** 2
    return 0.0


def _seqsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, as the kernel's loops do."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _warm_start(U_warm: torch.Tensor, a_max: float, w_max: float) -> torch.Tensor:
    """Shift the previous solution by one stage and clip it to the input box."""
    U0 = torch.cat([U_warm[:, 1:], U_warm[:, -1:]], dim=1)
    lbv = torch.tensor([-a_max, -w_max], dtype=U0.dtype, device=U0.device)
    ubv = torch.tensor([a_max, w_max], dtype=U0.dtype, device=U0.device)
    return torch.clamp(U0, lbv, ubv).reshape(U0.shape[0], M).contiguous()


def _check_inputs(xs, goals, obs, u_prevs, U_warm) -> None:
    tensors = dict(xs=xs, goals=goals, obs=obs, u_prevs=u_prevs, U_warm=U_warm)
    B = xs.shape[0] if xs.ndim == 2 else -1
    shapes = dict(xs=(B, 4), goals=(B, 4), obs=(B, K, 7), u_prevs=(B, 2), U_warm=(B, N, 2))
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the fused DU kernel is float32 only, got {t.dtype}"
            )
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xs.device}")


def solve_du_batch(xs, goals, obs, u_prevs, U_warm, spec_params) -> DuKernelResult:
    """Batched DU N=8 MPC-CBF solve.

    ``xs`` (B,4), ``goals`` (B,4), ``obs`` (B,5,7), ``u_prevs`` (B,2),
    ``U_warm`` (B,8,2) — the PREVIOUS solution (shifted by one stage here,
    as ``mpc_cbf.solve`` does) — all float32, contiguous, on one device.
    ``spec_params`` = (dt, a1, a2, beta, radius, v_max, a_max, w_max).

    CPU tensors go to ``solve_du_batch_reference``; CUDA tensors launch the
    CUDA kernel on the current stream.
    """
    global LAUNCH_COUNT
    _check_inputs(xs, goals, obs, u_prevs, U_warm)
    if xs.device.type == "cpu":
        return solve_du_batch_reference(xs, goals, obs, u_prevs, U_warm, spec_params)

    from safe_control_tpu_torch import _build

    lib = _build.load_mpc_du_kernel()
    params = [float(p) for p in spec_params]
    B = xs.shape[0]
    U0 = _warm_start(U_warm, params[6], params[7])
    U_out = torch.empty((B, M), dtype=torch.float32, device=xs.device)
    viol = torch.empty((B,), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.mpc_du_launch(
            xs.data_ptr(), goals.data_ptr(), obs.data_ptr(), u_prevs.data_ptr(),
            U0.data_ptr(), U_out.data_ptr(), viol.data_ptr(), B, *params, stream,
        )
    if err != 0:
        raise RuntimeError(f"mpc_du_kernel launch failed: CUDA error {err}")
    LAUNCH_COUNT += 1
    U = U_out.reshape(B, N, 2)
    return DuKernelResult(u=U[:, 0].contiguous(), U=U, viol=viol)


def solve_du_batch_reference(xs, goals, obs, u_prevs, U_warm, spec_params) -> DuKernelResult:
    """Plain PyTorch version of the CUDA kernel (same inputs and result)."""
    U0 = _warm_start(U_warm, float(spec_params[6]), float(spec_params[7]))
    U, viol = _solve_plain(xs, goals, obs, u_prevs, U0, spec_params)
    U = U.reshape(U.shape[0], N, 2)
    return DuKernelResult(u=U[:, 0].contiguous(), U=U, viol=viol)


def _solve_plain(x0, goal, obs, uprev, U0, spec_params):
    """The kernel body on ``(B, ...)`` tensors: returns U (B,16), viol (B,).

    Scalars are rounded to float32 first and combined in float32, as the
    kernel receives and combines them.  Rows come from ``rows`` in the
    kernel's production order, and every sum over rows or over the 16
    decision variables is taken left to right in that order.
    """
    dt, a1, a2, beta, radius, v_max, a_max, w_max = (_f32(p) for p in spec_params)
    a12s = _f32(np.float32(a1) + np.float32(a2))
    a12p = _f32(np.float32(a1) * np.float32(a2))
    pi = _f32(math.pi)
    twopi = _f32(2.0 * math.pi)
    inv_twopi = _f32(np.float32(1.0) / np.float32(2.0 * math.pi))
    dev, dtype = x0.device, x0.dtype
    B = x0.shape[0]

    def col(t, i):
        return t[..., i]

    ub = torch.tensor([a_max, w_max] * N, dtype=dtype, device=dev)
    lb = -ub
    eye = torch.eye(M, dtype=dtype, device=dev)
    ih = torch.tensor(
        [[_input_hess(i, j) for j in range(M)] for i in range(M)], dtype=dtype, device=dev
    )
    srvec = torch.tensor([SR[0], SR[1]] * N, dtype=dtype, device=dev)
    noise_eps = 4.0 * torch.finfo(dtype).eps  # NOISE_EPS in float32

    # Per-obstacle quantities, (B, K) each.
    ox, oy = obs[..., 0], obs[..., 1]
    orad, ob_, oe, oth, ofl = (obs[..., j] for j in range(2, 7))
    a_se = torch.clamp_min(torch.abs(orad), 1e-3) + radius
    b_se = torch.clamp_min(torch.abs(ob_), 1e-3) + radius
    e_se = torch.clamp_min(torch.abs(oe), 2.0)
    ct, st = torch.cos(oth), torch.sin(oth)
    d_min = orad + radius
    circ_off = beta * d_min * d_min
    is_circle = ofl < 0.5

    def h_and_grad(px, py, need_grad):
        """Barrier values (..., K) and position gradients at (px, py) (...)."""
        dx = px[..., None] - ox
        dy = py[..., None] - oy
        h_c = dx * dx + dy * dy - circ_off
        pxr = ct * dx + st * dy
        pyr = -st * dx + ct * dy
        qa = torch.abs(pxr) / a_se
        qb = torch.abs(pyr) / b_se
        qa_c = torch.clamp_min(qa, 1e-12)
        qb_c = torch.clamp_min(qb, 1e-12)
        h_s = torch.pow(qa_c, e_se) + torch.pow(qb_c, e_se) - 1.0
        h = torch.where(is_circle, h_c, h_s)
        if not need_grad:
            return h, None, None
        dpx = e_se / a_se * torch.sign(pxr) * torch.pow(qa_c, e_se - 1.0)
        dpy = e_se / b_se * torch.sign(pyr) * torch.pow(qb_c, e_se - 1.0)
        gx = torch.where(is_circle, 2.0 * dx, dpx * ct - dpy * st)
        gy = torch.where(is_circle, 2.0 * dy, dpx * st + dpy * ct)
        return h, gx, gy

    def rows(U, need_jac):
        """Yield ("r"|"c", row index, value, Jacobian row (..., 16) or None).

        Per stage k: the four state residual rows, the K CBF rows, the
        v-upper and v-lower rows; then the 16 input-move residual rows,
        whose Jacobian is constant and enters the Newton system
        analytically (their Jacobian row is None).
        """
        x, y, th, v = (col(x0, i) for i in range(4))
        lead = U.shape[:-1]
        if need_jac:
            TX = TY = TTH = TV = torch.zeros(lead + (M,), dtype=dtype, device=dev)
            g_prev = torch.zeros(lead + (K, M), dtype=dtype, device=dev)
        h_prev, _, _ = h_and_grad(x, y, False)
        for k in range(N):
            a_k, w_k = col(U, 2 * k), col(U, 2 * k + 1)
            cth, sth = torch.cos(th), torch.sin(th)
            x1 = x + v * cth * dt
            y1 = y + v * sth * dt
            th1 = th + w_k * dt
            th1 = th1 - twopi * torch.floor((th1 + pi) * inv_twopi)
            v1 = v + a_k * dt
            c1, s1 = torch.cos(th1), torch.sin(th1)
            x2 = x1 + v1 * c1 * dt
            y2 = y1 + v1 * s1 * dt
            if need_jac:
                TX1 = TX + dt * (TV * cth[..., None] - (v * sth)[..., None] * TTH)
                TY1 = TY + dt * (TV * sth[..., None] + (v * cth)[..., None] * TTH)
                TTH1 = TTH + dt * eye[2 * k + 1]
                TV1 = TV + dt * eye[2 * k]
                TX2 = TX1 + dt * (TV1 * c1[..., None] - (v1 * s1)[..., None] * TTH1)
                TY2 = TY1 + dt * (TV1 * s1[..., None] + (v1 * c1)[..., None] * TTH1)
                tangents = (TX1, TY1, TTH1, TV1)
            for idx, val in enumerate((x1, y1, th1, v1)):
                sq = SQ[idx]
                yield ("r", 4 * k + idx, (val - col(goal, idx)) * sq,
                       tangents[idx] * sq if need_jac else None)
            h1, gx1, gy1 = h_and_grad(x1, y1, need_jac)
            h2, gx2, gy2 = h_and_grad(x2, y2, need_jac)
            cbf = (h2 - 2.0 * h1 + h_prev) + a12s * (h1 - h_prev) + a12p * h_prev
            if need_jac:
                g1 = gx1[..., None] * TX1[..., None, :] + gy1[..., None] * TY1[..., None, :]
                g2 = gx2[..., None] * TX2[..., None, :] + gy2[..., None] * TY2[..., None, :]
                Jcbf = (g2 - 2.0 * g1 + g_prev) + a12s * (g1 - g_prev) + a12p * g_prev
                g_prev = g1
            h_prev = h1
            for o in range(K):
                yield ("c", k * K + o, cbf[..., o], Jcbf[..., o, :] if need_jac else None)
            yield ("c", N * K + k, v_max - v1, -TV1 if need_jac else None)
            yield ("c", N * K + N + k, v1 + v_max, TV1 if need_jac else None)
            x, y, th, v = x1, y1, th1, v1
            if need_jac:
                TX, TY, TTH, TV = TX1, TY1, TTH1, TV1
        for k in range(N):
            for j in range(2):
                prev = col(uprev, j) if k == 0 else col(U, 2 * (k - 1) + j)
                yield ("r", 4 * N + 2 * k + j, (col(U, 2 * k + j) - prev) * SR[j], None)

    # ---- constraint row scaling at the warm start -------------------------
    c_scale = [None] * NC
    for kind, i, _, J in rows(U0, True):
        if kind == "c":
            c_scale[i] = 1.0 / torch.clamp_min(torch.sqrt(_seqsum(J * J)), 1e-2)
    c_scale = torch.stack(c_scale, dim=-1)  # (B, NC)

    def newton_step(U, lam, rho):
        grad = torch.zeros((B, M), dtype=dtype, device=dev)
        H = torch.zeros((B, M, M), dtype=dtype, device=dev)
        r0 = [None] * NR
        act0 = [None] * NC
        rr = aa = None  # base-cost sums, in production order
        for kind, i, val, J in rows(U, True):
            if kind == "r":
                r0[i] = val
                rr = val * val if rr is None else rr + val * val
                if J is not None:
                    t = 2.0 * J
                    grad = grad + t * val[..., None]
                    H = H + t[..., :, None] * J[..., None, :]
            else:
                cs = val * c_scale[..., i]
                a = torch.clamp_min(lam[..., i] - rho * cs, 0.0)
                act0[i] = a
                aa = a * a if aa is None else aa + a * a
                rs = J * c_scale[..., i, None]
                grad = grad - rs * a[..., None]
                ra = rs * (a > 0.0).to(dtype)[..., None]
                H = H + (rho[..., None] * ra)[..., :, None] * ra[..., None, :]
        r0 = torch.stack(r0, dim=-1)
        act0 = torch.stack(act0, dim=-1)
        # Input-move rows: analytic gradient and (constant) Hessian.
        adds = 2.0 * srvec * r0[..., 4 * N:]
        grad = grad + adds
        grad = grad - torch.cat([adds[..., 2:], torch.zeros_like(adds[..., :2])], dim=-1)
        tr = H[..., 0, 0] + ih[0, 0]
        for i in range(1, M):
            tr = tr + H[..., i, i] + ih[i, i]
        damp = REG * (1.0 + tr / M)
        eps_b = 1e-7
        at_lb = (U <= lb + eps_b) & (grad > 0.0)
        at_ub = (U >= ub - eps_b) & (grad < 0.0)
        free = torch.logical_not(at_lb | at_ub).to(dtype)
        gf = free * grad
        Hf = (H + ih) * free[..., :, None] * free[..., None, :]
        Hf = Hf + torch.diag_embed(damp[..., None] * free) + torch.diag_embed(1.0 - free)
        Hf = torch.tril(Hf) + torch.tril(Hf, -1).transpose(-1, -2)  # lower triangle rules
        step = chol_solve(Hf, -gf)

        base_cost = rr + aa / (2.0 * rho)
        # All six step lengths at once, on a leading axis.
        alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
        cand = torch.clamp(U + alphas[:, None, None] * step, lb, ub)  # (6, B, 16)
        dc = dp = None
        for kind, i, val, _ in rows(cand, False):
            if kind == "r":
                t = (val - r0[..., i]) * (val + r0[..., i])
                dc = t if dc is None else dc + t
            else:
                a = torch.clamp_min(lam[..., i] - rho * (val * c_scale[..., i]), 0.0)
                t = (a - act0[..., i]) * (a + act0[..., i])
                dp = t if dp is None else dp + t
        deltas = dc + dp / (2.0 * rho)
        deltas = torch.where(torch.isfinite(deltas), deltas,
                             torch.full_like(deltas, float("inf")))
        best = torch.argmin(deltas, dim=0)  # first index on ties
        noise_floor = noise_eps * base_cost
        Hstep = Hf[..., :, 0] * step[..., 0:1]
        for j in range(1, M):
            Hstep = Hstep + Hf[..., :, j] * step[..., j:j + 1]
        pred = _seqsum(gf * step) + 0.5 * _seqsum(step * Hstep)
        best = torch.where(pred >= -noise_floor, torch.zeros_like(best), best)
        return torch.clamp(U + alphas[best][..., None] * step, lb, ub)

    def scaled_constraints(U):
        cs = [None] * NC
        for kind, i, val, _ in rows(U, False):
            if kind == "c":
                cs[i] = val * c_scale[..., i]
        return torch.stack(cs, dim=-1)

    U = torch.clamp(U0, lb, ub)
    lam = torch.zeros((B, NC), dtype=dtype, device=dev)
    rho = torch.full((B,), RHO0, dtype=dtype, device=dev)
    for _ in range(OUTER):
        for _ in range(NEWTON):
            U = newton_step(U, lam, rho)
        lam = torch.clamp_min(lam - rho[..., None] * scaled_constraints(U), 0.0)
        rho = torch.clamp_max(rho * RHO_GROWTH, RHO_MAX)
    viol = torch.clamp_min(-scaled_constraints(U).min(dim=-1).values, 0.0)
    return U, viol
