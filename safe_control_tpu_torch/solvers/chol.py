"""Batched SPD solve by a column-loop Cholesky with a clamped pivot.

The factorization clamps each pivot, ``L[j][j] = sqrt(max(s, 1e-20))``, as
the JAX solvers and the fused kernels do, so a matrix that rounding has made
slightly indefinite still yields a (damped) direction.
``torch.linalg.cholesky`` would raise there instead.

The sums run in the same sequential order as the JAX package's unrolled
factorizations and as the CUDA kernels (``csrc/*.cu``):
``s = H[i][j] - L[i][0] L[j][0] - L[i][1] L[j][1] - ...``.

``chol_factor`` and ``chol_solve_factored`` split the two halves, for a
solver that factors once and solves many times (the staged ADMM of
``solvers/qp.py`` and ``solvers/qp_kernel.py``); ``chol_solve`` is the two
in one call.
"""

from __future__ import annotations

import torch


def chol_factor(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor ``L (..., D, D)`` of ``H (..., D, D)``.

    Only the lower triangle of ``H`` is read; ``L`` is zero above the
    diagonal.
    """
    D = H.shape[-1]
    # cols[k] holds column k of L from the diagonal down: L[k:, k].
    cols = []
    for j in range(D):
        s = H[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k : j - k + 1]
        d = torch.sqrt(torch.clamp_min(s[..., :1], 1e-20))
        cols.append(torch.cat([d, s[..., 1:] / d], dim=-1))
    zeros = H.new_zeros(H.shape[:-2] + (D,))
    return torch.stack([torch.cat([zeros[..., :k], c], dim=-1) for k, c in enumerate(cols)],
                       dim=-1)


def chol_solve_factored(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``L L' x = g`` by forward and back substitution: ``g (..., D)``."""
    D = L.shape[-1]
    w = []
    for i in range(D):
        s = g[..., i]
        for k in range(i):
            s = s - L[..., i, k] * w[k]
        w.append(s / L[..., i, i])
    x = [None] * D
    for i in reversed(range(D)):
        s = w[i]
        for k in range(i + 1, D):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = g`` for a batch: ``H (..., D, D)`` SPD, ``g (..., D)``.

    Only the lower triangle of ``H`` is read.
    """
    return chol_solve_factored(chol_factor(H), g)


def chol_factor_steps(H: torch.Tensor) -> torch.Tensor:
    """``chol_factor`` in D column steps, for a wide ``H (..., D, D)``.

    Step j clamps and roots the pivot, scales column j below it, and
    subtracts that column's rank-1 product from the trailing block: the
    right-looking factorization.  Each entry of the trailing block meets
    the products in the same order as in ``chol_factor``
    (``H[i][k] - L[i][0] L[k][0] - L[i][1] L[k][1] - ...``), so the factor
    is the same; it takes D steps of a few operations instead of D^2/2.
    Only the lower triangle of ``H`` is read.
    """
    D = H.shape[-1]
    A = torch.tril(H)
    L = torch.zeros_like(H)
    for j in range(D):
        d = torch.sqrt(torch.clamp_min(A[..., j, j], 1e-20))
        col = A[..., j + 1:, j] / d[..., None]
        L[..., j, j] = d
        L[..., j + 1:, j] = col
        A[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
    return L


def chol_solve_steps(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``L L' x = g`` in D row steps of the forward and D of the
    back substitution, each one dot product of a row of ``L`` with the
    entries found so far: ``g (..., D)``."""
    D = L.shape[-1]
    w = torch.zeros_like(g)
    for i in range(D):
        s = g[..., i] - (L[..., i, :i] * w[..., :i]).sum(-1)
        w[..., i] = s / L[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(D)):
        s = w[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
        x[..., i] = s / L[..., i, i]
    return x
