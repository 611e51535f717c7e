"""Continuous-time CBF-QP safety filter, batched.

Port of ``safe_control_tpu/solvers/cbf_qp.py``:

    min ||u - u_ref||^2
    s.t. A1 u + b1 >= 0   (one HOCBF row per obstacle slot)
         u in [u_lb, u_ub]

Constraint rows come from ``torch.func`` derivatives of one h(x)
(``barriers/hocbf.py``); all ``K`` rows always exist, and padded dummy
obstacles become inert rows ``0 u + 1 >= 0``.  A model with several
barriers per obstacle (Manipulator2D's 23 link circles) gives a block of
rows per obstacle, obstacle by obstacle, each dummy's block inert.  ``solve`` and
``solve_batch`` take a leading batch axis B on every tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from safe_control_tpu_torch.barriers.hocbf import ct_cbf_row, ct_cbf_rows_multi, tensor_fields
from safe_control_tpu_torch.core.types import is_dummy
from safe_control_tpu_torch.dynamics import get_model
from safe_control_tpu_torch.solvers import qp
from safe_control_tpu_torch.utils.profiling import span

KERNEL_MIN_BATCH = 128  # 'auto' sends CUDA float32 batches this large to the kernel


class CBFQPResult(NamedTuple):
    u: torch.Tensor  # (B, m) filtered control
    feasible: torch.Tensor  # (B,) bool
    h_min: torch.Tensor  # (B,) min barrier margin over the real obstacle rows


def _bounds(bound_fn, spec, B, device, dtype):
    """``(B, m)`` input bounds from ``model.u_lb``/``u_ub``."""
    v = bound_fn(spec, device=device, dtype=dtype)
    return v.expand(B, v.shape[-1])


def _assemble(model, model_name, spec, x, u_ref, obs, dt, mode):
    """The batched QP data (P, q, A, l, u) plus the CBF rows for diagnostics.

    ``x (B,n)``, ``u_ref (B,m)``, ``obs (B,K,7)``.  A batched spec's tensor
    fields are ``(B,)``.
    """
    B, m = u_ref.shape
    dtype, device = x.dtype, x.device
    fields = tensor_fields(spec)
    spec_rows = spec.replace(**{k: v[:, None] for k, v in fields.items()}) if fields else spec
    if hasattr(model, "ct_multi_h"):
        # (B, K, C, m) blocks, flattened obstacle by obstacle.
        a_rows, b_vals = ct_cbf_rows_multi(model, x[:, None, :], obs, spec_rows, dt, mode)
        C = b_vals.shape[-1]
        a_rows, b_vals = a_rows.reshape(B, -1, m), b_vals.reshape(B, -1)
        dummy = torch.repeat_interleave(is_dummy(obs), C, dim=1)
    else:
        a_rows, b_vals = ct_cbf_row(model, model_name, x[:, None, :], obs, spec_rows, dt, mode)
        dummy = is_dummy(obs)
    # Inert rows for padded dummy obstacles: 0 u + 1 >= 0.
    a_rows = torch.where(dummy[..., None], torch.zeros_like(a_rows), a_rows)
    b_vals = torch.where(dummy, torch.ones_like(b_vals), b_vals)

    K = a_rows.shape[1]
    eye = torch.eye(m, dtype=dtype, device=device).expand(B, m, m)
    P = 2.0 * eye
    q = -2.0 * u_ref
    A = torch.cat([a_rows, eye], dim=1)
    l = torch.cat([-b_vals, _bounds(model.u_lb, spec, B, device, dtype)], dim=1)
    u_up = torch.cat([torch.full((B, K), float("inf"), dtype=dtype, device=device),
                      _bounds(model.u_ub, spec, B, device, dtype)], dim=1)
    return P, q, A, l, u_up, a_rows, b_vals, dummy


def _result(sol: qp.QPSolution, a_rows, b_vals, dummy) -> CBFQPResult:
    margin = (a_rows * sol.x[:, None, :]).sum(-1) + b_vals
    h_min = torch.where(dummy, torch.full_like(margin, float("inf")), margin).amin(-1)
    return CBFQPResult(u=sol.x, feasible=sol.prim_res < 1e-3, h_min=h_min)


def solve(model_name: str, spec, x, u_ref, obs, dt: float, mode: str = "cbf",
          iters: int = 1600) -> CBFQPResult:
    """CBF-QPs of a batch of robots through the general ``qp.solve_qp``.

    ``x (B,n)``, ``u_ref (B,m)``, ``obs (B,K,7)`` or one shared ``(K,7)``.
    """
    return _solve(qp.solve_qp, model_name, spec, x, u_ref, obs, dt, mode, iters)


def _solve(solver, model_name, spec, x, u_ref, obs, dt, mode, iters) -> CBFQPResult:
    """The rows and the QP data traced as the span ``cbf_qp.rows``, timed
    on the device too."""
    model = get_model(model_name)
    obs = obs.expand((x.shape[0],) + obs.shape[-2:])
    with span("cbf_qp.rows", device=True):
        P, q, A, l, u_up, a_rows, b_vals, dummy = _assemble(
            model, model_name, spec, x, u_ref, obs, dt, mode
        )
    sol = solver(P, q, A, l, u_up, iters=iters)
    return _result(sol, a_rows, b_vals, dummy)


def solve_batch(model_name: str, spec, xs, u_refs, obs_batch, dt: float,
                backend: str = "auto", **kw) -> CBFQPResult:
    """Batched CBF-QP; ``spec`` may be batched (``(B,)`` tensor fields).

    ``backend`` keeps the JAX package's values:

    - ``'xla'``: the general batched ``qp.solve_qp``;
    - ``'pallas'``: ``qp_kernel.solve_qp_batch``, the hand-written CUDA
      kernel for CUDA tensors (its plain version for CPU tensors);
    - ``'auto'``: the kernel for CUDA float32 batches of 128 or more,
      otherwise the general path.  This is a dispatch rule, not a fallback:
      a kernel that fails to build or launch raises.

    ``kw``: ``mode`` ('cbf' or 'hard') and ``iters`` (default 1600).
    """
    mode = kw.pop("mode", "cbf")
    iters = kw.pop("iters", 1600)
    if kw:
        raise TypeError(f"unexpected keyword arguments {sorted(kw)}")
    if backend == "auto":
        use_kernel = (xs.device.type == "cuda" and xs.dtype == torch.float32
                      and xs.shape[0] >= KERNEL_MIN_BATCH)
        backend = "pallas" if use_kernel else "xla"
    if backend == "pallas":
        from safe_control_tpu_torch.solvers.qp_kernel import solve_qp_batch as solver
    elif backend == "xla":
        solver = qp.solve_qp
    else:
        raise ValueError(f"unknown backend {backend!r}: expected 'auto', 'xla' or 'pallas'")
    return _solve(solver, model_name, spec, xs, u_refs, obs_batch, dt, mode, iters)
