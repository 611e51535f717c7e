"""Batched SPD solve by a column-loop Cholesky with a clamped pivot.

The factorization clamps each pivot, ``L[j][j] = sqrt(max(s, 1e-20))``, as
the JAX solvers and the fused kernel do, so a matrix that rounding has made
slightly indefinite still yields a (damped) direction.
``torch.linalg.cholesky`` would raise there instead.

The sums run in the same sequential order as the JAX package's unrolled
16x16 factorization and as ``csrc/mpc_du_kernel.cu``:
``s = H[i][j] - L[i][0] L[j][0] - L[i][1] L[j][1] - ...``.
"""

from __future__ import annotations

import torch


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = g`` for a batch: ``H (..., D, D)`` SPD, ``g (..., D)``.

    Only the lower triangle of ``H`` is read.
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
    w = []
    for i in range(D):
        s = g[..., i]
        for k in range(i):
            s = s - cols[k][..., i - k] * w[k]
        w.append(s / cols[i][..., 0])
    x = [None] * D
    for i in reversed(range(D)):
        s = w[i]
        for k in range(i + 1, D):
            s = s - cols[i][..., k - i] * x[k]
        x[i] = s / cols[i][..., 0]
    return torch.stack(x, dim=-1)
