// Fused AL-Gauss-Newton MPC-CBF solve for DynamicUnicycle2D, N=8, K=5.
//
// Replaces safe_control_tpu/solvers/mpc_du_kernel.py::_mpc_du_kernel (the
// Pallas TPU kernel).  One thread solves one problem end to end: the
// rollout with hand-derived forward tangents, the r=2 CBF rows over the
// circle/superellipsoid blend and the v-bound rows, constraint-row scaling
// at the warm start, the Gauss-Newton gradient and Hessian accumulated row
// by row as outer products while the rows are produced (Jr and Jc are never
// stored), the analytic input-move terms, the projected free set, a packed
// 16x16 Cholesky, the six-step noise-aware line search and the multiplier
// update, 8 outer x 3 Newton iterations.
//
// What bounds it: FP32 issue and local-memory traffic, not DRAM.  A problem
// reads 61 floats and writes 17 against roughly 1e5-1e6 flops; its state
// (U, multipliers, row scales, tangents, the packed H and L) is a few KB, so
// it lives in local memory (spilled registers, served from L1/L2).  At
// B=4096 with 128-thread blocks there are only 32 blocks for 132 SMs:
// occupancy is the first lever for a later change (a warp per problem, or H
// staged in shared memory).
//
// Numerics: compiled without --use_fast_math and with -fmad=false, so every
// operation rounds as the plain PyTorch version
// (solvers/mpc_du_kernel.py::_solve_plain) rounds it, and every sum runs in
// the same order.  Wrapping uses th - 2pi floor((th + pi) * (1 / 2pi)) with
// the reciprocal rounded to float, which is what PyTorch computes for a
// division by a scalar on the card.
//
// Layout: row-major (B, ...) inputs, one problem per row; no transpose.

#include <cuda_runtime.h>
#include <math.h>

#include "mpc_du_kernel.h"

using namespace mpc_du;

namespace {

constexpr float INV_TWOPI = 1.0f / TWOPI_F;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

__device__ __forceinline__ float sym(const float* A, int i, int j) {
  return i >= j ? A[tri(i, j)] : A[tri(j, i)];
}

// sign with sign(0) == 0, as jnp.sign and torch.sign (copysignf would give +-1).
__device__ __forceinline__ float sign_f(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float alpha_at(int i) {
  switch (i) {
    case 0: return ALPHA_0;
    case 1: return ALPHA_1;
    case 2: return ALPHA_2;
    case 3: return ALPHA_3;
    case 4: return ALPHA_4;
    default: return ALPHA_5;
  }
}

__device__ __forceinline__ float sr_at(int j) { return j == 0 ? SR_0 : SR_1; }

// Entry (i, j) of the constant input-move Hessian 2 Jr_in' Jr_in.
__device__ __forceinline__ float ih_at(int i, int j) {
  if (i == j) return (i / 2 < N - 1) ? IH_DIAG : IH_DIAG_LAST;
  const int d = i > j ? i - j : j - i;
  return d == 2 ? IH_OFF : 0.0f;
}

struct Obstacle {
  float ox, oy, a_se, b_se, e_se, ct, st, circ_off;
  bool circle;
};

struct Problem {
  float x0[4], goal[4], uprev[2];
  Obstacle obs[K];
  float dt, a12s, a12p, v_max, a_max, w_max;
  __device__ float lb(int i) const { return (i & 1) ? -w_max : -a_max; }
  __device__ float ub(int i) const { return (i & 1) ? w_max : a_max; }
};

// Barrier value at (px, py) and, with GRAD, its position gradient.  Same
// circle/superellipsoid flag blend as barriers.geometry.h_point, with the
// guards a, b >= 1e-3, e >= 2 and |q| >= 1e-12 before the power.
template <bool GRAD>
__device__ __forceinline__ float barrier(const Obstacle& o, float px, float py,
                                         float& gx, float& gy) {
  const float dx = px - o.ox;
  const float dy = py - o.oy;
  if (o.circle) {
    if (GRAD) {
      gx = 2.0f * dx;
      gy = 2.0f * dy;
    }
    return dx * dx + dy * dy - o.circ_off;
  }
  const float pxr = o.ct * dx + o.st * dy;
  const float pyr = -o.st * dx + o.ct * dy;
  const float qa = fmaxf(fabsf(pxr) / o.a_se, 1e-12f);
  const float qb = fmaxf(fabsf(pyr) / o.b_se, 1e-12f);
  if (GRAD) {
    const float dpx = o.e_se / o.a_se * sign_f(pxr) * powf(qa, o.e_se - 1.0f);
    const float dpy = o.e_se / o.b_se * sign_f(pyr) * powf(qb, o.e_se - 1.0f);
    gx = dpx * o.ct - dpy * o.st;
    gy = dpx * o.st + dpy * o.ct;
  }
  return powf(qa, o.e_se) + powf(qb, o.e_se) - 1.0f;
}

// Rollout, residual rows and constraint rows (with JAC, their Jacobian rows)
// handed to ``sink`` in production order: per stage k the four state rows,
// the K CBF rows, the v-upper and the v-lower row; then the 16 input-move
// rows, whose constant Jacobian enters the Newton system analytically.
template <bool JAC, class Sink>
__device__ void forward(const float* U, const Problem& p, Sink& sink) {
  float x = p.x0[0], y = p.x0[1], th = p.x0[2], v = p.x0[3];
  float TX[M], TY[M], TTH[M], TV[M], TX2[M], TY2[M], J[M];
  float gprev[K][M];
  float hprev[K];
  float gx_unused, gy_unused;
  const float dt = p.dt;
  if constexpr (JAC) {
    for (int j = 0; j < M; ++j) {
      TX[j] = 0.0f;
      TY[j] = 0.0f;
      TTH[j] = 0.0f;
      TV[j] = 0.0f;
      for (int o = 0; o < K; ++o) gprev[o][j] = 0.0f;
    }
  }
  for (int o = 0; o < K; ++o) hprev[o] = barrier<false>(p.obs[o], x, y, gx_unused, gy_unused);

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const float a_k = U[2 * k];
    const float w_k = U[2 * k + 1];
    const float cth = cosf(th), sth = sinf(th);
    const float x1 = x + v * cth * dt;
    const float y1 = y + v * sth * dt;
    float th1 = th + w_k * dt;
    th1 = th1 - TWOPI_F * floorf((th1 + PI_F) * INV_TWOPI);
    const float v1 = v + a_k * dt;
    // x2 = step(x1, u_k): the same control again, not x_{k+2}.
    const float c1 = cosf(th1), s1 = sinf(th1);
    const float x2 = x1 + v1 * c1 * dt;
    const float y2 = y1 + v1 * s1 * dt;
    if constexpr (JAC) {
      const float vs = v * sth, vc = v * cth;
      for (int j = 0; j < M; ++j) {
        const float tx = TX[j] + dt * (TV[j] * cth - vs * TTH[j]);
        const float ty = TY[j] + dt * (TV[j] * sth + vc * TTH[j]);
        TX[j] = tx;
        TY[j] = ty;
      }
      TTH[2 * k + 1] = TTH[2 * k + 1] + dt;
      TV[2 * k] = TV[2 * k] + dt;
      const float v1s1 = v1 * s1, v1c1 = v1 * c1;
      for (int j = 0; j < M; ++j) {
        TX2[j] = TX[j] + dt * (TV[j] * c1 - v1s1 * TTH[j]);
        TY2[j] = TY[j] + dt * (TV[j] * s1 + v1c1 * TTH[j]);
      }
    }

    // State residual rows (x_{k+1} - goal) * sqrt(Q).
    sink.res(4 * k + 0, (x1 - p.goal[0]) * SQ_0, TX, SQ_0);
    sink.res(4 * k + 1, (y1 - p.goal[1]) * SQ_1, TY, SQ_1);
    sink.res(4 * k + 2, (th1 - p.goal[2]) * SQ_2, TTH, SQ_2);
    sink.res(4 * k + 3, (v1 - p.goal[3]) * SQ_3, TV, SQ_3);

    // CBF rows: ddh + (a1+a2) dh + a1 a2 h_k.
#pragma unroll 1
    for (int o = 0; o < K; ++o) {
      float gx1, gy1, gx2, gy2;
      const float h1 = barrier<JAC>(p.obs[o], x1, y1, gx1, gy1);
      const float h2 = barrier<JAC>(p.obs[o], x2, y2, gx2, gy2);
      const float hp = hprev[o];
      const float cbf = (h2 - 2.0f * h1 + hp) + p.a12s * (h1 - hp) + p.a12p * hp;
      if constexpr (JAC) {
        for (int j = 0; j < M; ++j) {
          const float g1 = gx1 * TX[j] + gy1 * TY[j];
          const float g2 = gx2 * TX2[j] + gy2 * TY2[j];
          const float gp = gprev[o][j];
          J[j] = (g2 - 2.0f * g1 + gp) + p.a12s * (g1 - gp) + p.a12p * gp;
          gprev[o][j] = g1;
        }
      }
      hprev[o] = h1;
      sink.con(k * K + o, cbf, J);
    }

    // v bounds: v_max - v >= 0 and v + v_max >= 0.
    if constexpr (JAC) {
      for (int j = 0; j < M; ++j) J[j] = -TV[j];
    }
    sink.con(N * K + k, p.v_max - v1, J);
    sink.con(N * K + N + k, v1 + p.v_max, TV);

    x = x1;
    y = y1;
    th = th1;
    v = v1;
  }

  // Input-move residual rows (u_k - u_{k-1}) * sqrt(R).
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < 2; ++j) {
      const float prev = k == 0 ? p.uprev[j] : U[2 * (k - 1) + j];
      sink.res_in(4 * N + 2 * k + j, (U[2 * k + j] - prev) * sr_at(j));
    }
  }
}

// Row scale 1 / max(|Jc row|, 1e-2) at the warm start.
struct ScaleSink {
  float* cs;
  __device__ void res(int, float, const float*, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float, const float* J) {
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s = s + J[j] * J[j];
    cs[i] = 1.0f / fmaxf(sqrtf(s), 1e-2f);
  }
};

// grad = 2 Jr'r - Jc'act and H = 2 Jr'Jr + rho Jca'Jca (packed lower
// triangle), plus the residuals, activations and base-cost sums at U.
struct NewtonSink {
  const float* lam;
  const float* cs;
  float rho;
  float* grad;
  float* H;
  float* r0;
  float* act0;
  float rr, aa;
  __device__ void res(int i, float r, const float* T, float sq) {
    r0[i] = r;
    rr = rr + r * r;
    float row[M];
    for (int j = 0; j < M; ++j) row[j] = T[j] * sq;
    for (int a = 0; a < M; ++a) {
      const float t = 2.0f * row[a];
      grad[a] = grad[a] + t * r;
      for (int b = 0; b <= a; ++b) H[tri(a, b)] = H[tri(a, b)] + t * row[b];
    }
  }
  __device__ void res_in(int i, float r) {
    r0[i] = r;
    rr = rr + r * r;
  }
  __device__ void con(int i, float c, const float* J) {
    const float a = fmaxf(0.0f, lam[i] - rho * (c * cs[i]));
    act0[i] = a;
    aa = aa + a * a;
    float rs[M];
    for (int j = 0; j < M; ++j) {
      rs[j] = J[j] * cs[i];
      grad[j] = grad[j] - rs[j] * a;
    }
    if (a > 0.0f) {
      for (int q = 0; q < M; ++q) {
        const float t = rho * rs[q];
        for (int b = 0; b <= q; ++b) H[tri(q, b)] = H[tri(q, b)] + t * rs[b];
      }
    }
  }
};

// Cancellation-free merit difference L(candidate) - L(U).
struct MeritSink {
  const float* r0;
  const float* act0;
  const float* lam;
  const float* cs;
  float rho;
  float dc, dp;
  __device__ void res(int i, float r, const float*, float) {
    dc = dc + (r - r0[i]) * (r + r0[i]);
  }
  __device__ void res_in(int i, float r) { dc = dc + (r - r0[i]) * (r + r0[i]); }
  __device__ void con(int i, float c, const float*) {
    const float a = fmaxf(0.0f, lam[i] - rho * (c * cs[i]));
    dp = dp + (a - act0[i]) * (a + act0[i]);
  }
};

// Multiplier update lam = max(0, lam - rho c_scaled).
struct LamSink {
  float* lam;
  const float* cs;
  float rho;
  __device__ void res(int, float, const float*, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float c, const float*) {
    lam[i] = fmaxf(0.0f, lam[i] - rho * (c * cs[i]));
  }
};

// Smallest scaled constraint value.
struct MinSink {
  const float* cs;
  float m;
  __device__ void res(int, float, const float*, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float c, const float*) { m = fminf(m, c * cs[i]); }
};

__device__ void newton_step(float* U, const float* lam, const float* cs, float rho,
                            const Problem& p) {
  float grad[M], H[TRI], r0[NR], act0[NC];
  for (int i = 0; i < M; ++i) grad[i] = 0.0f;
  for (int i = 0; i < TRI; ++i) H[i] = 0.0f;
  NewtonSink ns{lam, cs, rho, grad, H, r0, act0, 0.0f, 0.0f};
  forward<true>(U, p, ns);

  // Input-move rows: gradient 2 Jr_in' r_in from the one/two-hot rows.
  float adds[M];
  for (int i = 0; i < M; ++i) adds[i] = (2.0f * sr_at(i & 1)) * r0[4 * N + i];
  for (int i = 0; i < M; ++i) grad[i] = grad[i] + adds[i];
  for (int i = 0; i < M; ++i) grad[i] = grad[i] - (i + 2 < M ? adds[i + 2] : 0.0f);

  // Levenberg damping scaled by the trace, the input-move diagonal included.
  float tr = H[tri(0, 0)] + ih_at(0, 0);
  for (int i = 1; i < M; ++i) tr = tr + H[tri(i, i)] + ih_at(i, i);
  const float damp = REG * (1.0f + tr / static_cast<float>(M));

  // Projected free set: freeze variables at an active bound pushed outward.
  float fr[M], gf[M];
  for (int i = 0; i < M; ++i) {
    const bool at_lb = (U[i] <= p.lb(i) + 1e-7f) && (grad[i] > 0.0f);
    const bool at_ub = (U[i] >= p.ub(i) - 1e-7f) && (grad[i] < 0.0f);
    fr[i] = (at_lb || at_ub) ? 0.0f : 1.0f;
    gf[i] = fr[i] * grad[i];
  }
  // Hf (in place of H): masked, damped, identity on frozen variables.
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j <= i; ++j) {
      float h = (H[tri(i, j)] + ih_at(i, j)) * fr[i] * fr[j];
      if (i == j) h = h + damp * fr[i] + (1.0f - fr[i]);
      H[tri(i, j)] = h;
    }
  }

  // Cholesky with the pivot clamp, then step = -Hf^-1 gf.
  float L[TRI];
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[tri(i, j)];
      for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / L[tri(j, j)];
    }
  }
  float w[M], stp[M];
  for (int i = 0; i < M; ++i) {
    float s = -gf[i];
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * w[k];
    w[i] = s / L[tri(i, i)];
  }
  for (int i = M - 1; i >= 0; --i) {
    float s = w[i];
    for (int k = i + 1; k < M; ++k) s = s - L[tri(k, i)] * stp[k];
    stp[i] = s / L[tri(i, i)];
  }

  // Line search over six step lengths on merit differences.
  const float base_cost = ns.rr + ns.aa / (2.0f * rho);
  int best = 0;
  float best_val = 0.0f;
  for (int ai = 0; ai < NUM_ALPHAS; ++ai) {
    const float al = alpha_at(ai);
    float cand[M];
    for (int i = 0; i < M; ++i) cand[i] = fminf(fmaxf(U[i] + al * stp[i], p.lb(i)), p.ub(i));
    MeritSink ms{r0, act0, lam, cs, rho, 0.0f, 0.0f};
    forward<false>(cand, p, ms);
    float d = ms.dc + ms.dp / (2.0f * rho);
    if (!isfinite(d)) d = INFINITY;
    if (ai == 0 || d < best_val) {  // first index on ties
      best = ai;
      best_val = d;
    }
  }
  // Noise-aware acceptance: if the model's predicted decrease is below the
  // merit's rounding floor, take the full damped Newton step.
  const float noise_floor = NOISE_EPS * base_cost;
  float pg = 0.0f, ph = 0.0f;
  for (int i = 0; i < M; ++i) {
    float s = sym(H, i, 0) * stp[0];
    for (int j = 1; j < M; ++j) s = s + sym(H, i, j) * stp[j];
    pg = pg + gf[i] * stp[i];
    ph = ph + stp[i] * s;
  }
  const float pred = pg + 0.5f * ph;
  if (pred >= -noise_floor) best = 0;
  const float al = alpha_at(best);
  for (int i = 0; i < M; ++i) U[i] = fminf(fmaxf(U[i] + al * stp[i], p.lb(i)), p.ub(i));
}

__global__ void __launch_bounds__(128)
mpc_du_kernel(const float* __restrict__ x0, const float* __restrict__ goal,
              const float* __restrict__ obs, const float* __restrict__ uprev,
              const float* __restrict__ U0, float* __restrict__ U_out,
              float* __restrict__ viol_out, int B, float dt, float a1, float a2,
              float beta, float radius, float v_max, float a_max, float w_max) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Problem p;
  for (int i = 0; i < 4; ++i) {
    p.x0[i] = x0[4 * b + i];
    p.goal[i] = goal[4 * b + i];
  }
  p.uprev[0] = uprev[2 * b];
  p.uprev[1] = uprev[2 * b + 1];
  for (int o = 0; o < K; ++o) {
    const float* ob = obs + static_cast<size_t>(b) * K * OBS_DIM + o * OBS_DIM;
    Obstacle& q = p.obs[o];
    q.ox = ob[0];
    q.oy = ob[1];
    q.a_se = fmaxf(fabsf(ob[2]), 1e-3f) + radius;
    q.b_se = fmaxf(fabsf(ob[3]), 1e-3f) + radius;
    q.e_se = fmaxf(fabsf(ob[4]), 2.0f);
    q.ct = cosf(ob[5]);
    q.st = sinf(ob[5]);
    const float d_min = ob[2] + radius;
    q.circ_off = beta * d_min * d_min;
    q.circle = ob[6] < 0.5f;
  }
  p.dt = dt;
  p.a12s = a1 + a2;
  p.a12p = a1 * a2;
  p.v_max = v_max;
  p.a_max = a_max;
  p.w_max = w_max;

  float U[M], lam[NC], cs[NC];
  for (int i = 0; i < M; ++i) U[i] = U0[M * b + i];
  {
    ScaleSink ss{cs};
    forward<true>(U, p, ss);
  }
  for (int i = 0; i < M; ++i) U[i] = fminf(fmaxf(U[i], p.lb(i)), p.ub(i));
  for (int i = 0; i < NC; ++i) lam[i] = 0.0f;

  float rho = RHO0;
#pragma unroll 1
  for (int outer = 0; outer < OUTER; ++outer) {
#pragma unroll 1
    for (int it = 0; it < NEWTON; ++it) newton_step(U, lam, cs, rho, p);
    LamSink ls{lam, cs, rho};
    forward<false>(U, p, ls);
    rho = fminf(rho * RHO_GROWTH, RHO_MAX);
  }
  MinSink ms{cs, INFINITY};
  forward<false>(U, p, ms);
  for (int i = 0; i < M; ++i) U_out[M * b + i] = U[i];
  viol_out[b] = fmaxf(0.0f, -ms.m);
}

}  // namespace

extern "C" int mpc_du_launch(const void* x0, const void* goal, const void* obs,
                             const void* uprev, const void* U0, void* U_out, void* viol,
                             int B, float dt, float a1, float a2, float beta, float radius,
                             float v_max, float a_max, float w_max, void* stream) {
  if (B <= 0) return 0;
  constexpr int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  mpc_du_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(goal),
      static_cast<const float*>(obs), static_cast<const float*>(uprev),
      static_cast<const float*>(U0), static_cast<float*>(U_out), static_cast<float*>(viol),
      B, dt, a1, a2, beta, radius, v_max, a_max, w_max);
  return static_cast<int>(cudaGetLastError());
}
