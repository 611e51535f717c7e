"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes of the three hand-written kernels, counted from their
code.

An operation is an add, subtract, multiply, divide, square root, floor,
sine, cosine or power; comparisons, min/max, abs and negation are free.  A
dual-number operation counts as two.  The data-dependent rho Jc'Jc updates
of the MPC kernels are counted from the active rows that the benchmark's
reference meets on the problems it solves again.
"""

from __future__ import annotations

# One H100 SXM at 700 W (NVIDIA's data sheet): float32 outside the tensor
# cores, and HBM3.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12


def bound_s(flops: float, nbytes: float) -> tuple:
    """(least seconds, "operations" or "bytes")."""
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b1_flops(obs_flags_circle: int, obs_total: int, problems: int, active_rows: float) -> float:
    """Operations of B1's solve (DynamicUnicycle2D N=8, K=5, M=16, 8x3
    budget) on ``problems`` problems whose ``obs_total`` obstacle slots hold
    ``obs_flags_circle`` circles, with the rho Jc'Jc update for
    ``active_rows`` rows summed over the Newton steps."""
    N, K, M, NR, NC, steps = 8, 5, 16, 48, 56, 24
    circles, supers = obs_flags_circle, obs_total - obs_flags_circle
    hv = (6 * circles + 14 * supers) / problems
    hg = (2 * circles + 16 * supers) / problems
    values = hv + N * (25 + 8 + 2 + 2 * hv + 8 * K) + 2 * M
    tangents = N * (326 + 2 * hg + 224 * K)
    tri = M * (M + 1) // 2
    newton = (values + tangents + (NR - M) * (2 + 4 * M + 2 * tri) + M * 2
              + NC * (5 + 3 * M)
              + 48 + 34 + M + 3 * tri + 4 * M
              + sum(i * (i + 1) for i in range(M)) + tri
              + 2 * (M * M)
              + M * (2 * M - 1) + 4 * M + 6
              + 6 * (values + 4 * NR + 7 * NC + 3) + 12 * M + 2 * M)
    per_problem = (values + tangents + NC * 34 + steps * newton + 8 * (values + 3 * NC)
                   + values + NC)
    return problems * per_problem + active_rows * (M + 2 * tri)


def b2_flops(B: int, n: int, m: int, iters: int, stages: int = 8) -> float:
    """Operations of B2's staged ADMM on B problems."""
    tri = n * (n + 1) // 2
    sweep = 5 * n + 2 * n * n + m * (4 * n + 9)
    stage = 3 * tri + n + sum(i * (i + 1) for i in range(n)) + n * n + m * 4 * n + 3
    return B * (iters * sweep + stages * stage + m * 2 * tri)


def b2_bytes(B: int, n: int, m: int) -> float:
    """Bytes B2 must move: P, q, A, l, u read once, x and y written once."""
    return B * (n * n + 2 * n + m * n + 4 * m) * 4


def b3_flops(B, n, m, N, K, NC, step_ops, active_rows, h_ops=6.0, rel_deg=1, outer=8,
             newton=3) -> float:
    """Operations of B3's solve for a model of ``step_ops`` operations a
    step and ``h_ops`` a barrier value, at ``outer`` x ``newton``
    iterations; relative degree 2 adds a step and K barrier values a stage
    and 6 operations a CBF row."""
    M, NR, steps = N * m, N * (n + m), outer * newton
    tri = M * (M + 1) // 2
    stage = rel_deg * (step_ops + K * h_ops) + 2 * n + (3 if rel_deg == 1 else 9) * K
    rollout = K * h_ops + N * (stage + 2 * (NC - N * K) // (2 * N)) + 2 * N * m
    newton_ops = (M * (2 * rollout + NC) + 2 * M * (NR + NC) + 2 * tri * NR + 2 * M + 3 * tri
                  + sum(i * (i + 1) for i in range(M)) + tri + 2 * M * M + 2 * M * M
                  + 6 * (rollout + 4 * NR + 7 * NC) + 12 * M)
    per_problem = (M * 2 * rollout + NC * 2 * M + steps * newton_ops
                   + outer * (rollout + 3 * NC) + rollout + NC)
    return B * per_problem + active_rows * 2 * tri


def b3_bytes(B, n, m, N, K) -> float:
    """Bytes B3 must move: x0, goal, obstacles, u_prev and the warm start
    read once; U, the rollout and viol written once."""
    M = N * m
    return B * (2 * n + 7 * K + m + M + M + (N + 1) * n + 1) * 4


# (step, circle barrier, superellipsoid barrier) operations of the models
# B3 runs here, from csrc/mpc_fused_models.h: DynamicUnicycle2D's Euler step
# 17 (two products with a sine or cosine and dt, the heading's wrap 5, the
# speed's 2); a circle 6; a superellipsoid 14.
B3_MODEL_OPS = {"DynamicUnicycle2D": (17, 6, 14)}


def b3_h_ops(model: str, circles: int, total: int) -> float:
    """Barrier operations a value, averaged over the obstacle slots met."""
    _, circle, superellipsoid = B3_MODEL_OPS[model]
    return (circle * circles + superellipsoid * (total - circles)) / max(total, 1)
