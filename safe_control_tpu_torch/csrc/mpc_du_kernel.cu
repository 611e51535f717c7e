// Fused AL-Gauss-Newton MPC-CBF solve for DynamicUnicycle2D, N=8, K=5.
//
// Replaces safe_control_tpu/solvers/mpc_du_kernel.py::_mpc_du_kernel (the
// Pallas TPU kernel).  A group of 16 lanes (a half-warp) solves one problem
// end to end, lane j owning decision variable j: the rollout with
// hand-derived forward tangents, the r=2 CBF rows over the
// circle/superellipsoid blend and the v-bound rows, constraint-row scaling
// at the warm start, the Gauss-Newton gradient and Hessian accumulated row
// by row as outer products while the rows are produced (Jr and Jc are never
// stored), the analytic input-move terms, the projected free set, a 16x16
// Cholesky, the six-step noise-aware line search and the multiplier update,
// 8 outer x 3 Newton iterations.
//
// What bounds it on the H100: instruction throughput once the SMs are
// full, and each problem's serial chains (rollout, factorisation,
// substitutions) at small B; not DRAM (a problem reads 61 floats and writes
// 17).  One thread per problem put 255 registers and a 3.6 KB stack on each
// thread and filled 32 of the 132 SMs at B=4096, so it waited on latency.
// Here:
//  - every lane of a group runs the primal rollout, the barrier values and
//    the row values alike (the same operations, so the same values), and
//    carries only its own tangent column: TX[j], TY[j], TTH[j], TV[j] and
//    gprev[o][j] are registers, and so is row j of H;
//  - a row's Jacobian entry J[j] lives in lane j; for an H update each lane
//    writes its entry to a 16-float buffer in shared memory (two buffers in
//    turn, one __syncwarp a row) and reads the other 15 with four 16-byte
//    loads;
//  - U[j], grad[j] and the step's j-th entry stay in lane j; the per-row
//    scalars (multipliers, row scales, residuals and activations at U) and
//    the problem's inputs sit in shared memory, where every lane of the
//    group reads the same word;
//  - 128-thread blocks of 8 problems: B=4096 gives 512 blocks, all 132 SMs
//    busy with 12-16 warps each.  __launch_bounds__(128, 4) caps a thread
//    at 128 registers: ptxas gives 127 and no spills, and 4 blocks an SM
//    hold B=4096 in one wave (528 places).  A cap of 64 registers (8 blocks
//    an SM) spilled 320 bytes and ran 22% slower at B=4096, 80 (6 blocks)
//    spilled 144 bytes and ran 11% slower (du_kernel_ab.py on an H100).
// The price is repeated work: 16 lanes run each primal rollout, and every
// row pays a broadcast, so past about B=14,000 (a full card several times
// over) one thread a problem does more solves a second.  No tensor cores,
// TMA or cp.async: 250 bytes of input a problem leave nothing to overlap,
// and TF32 products would lose the float32 envelope in the cost-flat
// directions the solve has.
//
// Numerics: compiled without --use_fast_math and with -fmad=false, so every
// operation rounds as the plain PyTorch version
// (solvers/mpc_du_kernel.py::_solve_plain) rounds it, and every sum runs in
// the same order: sums over j (row norms, the damping trace, the predicted
// decrease) are gathered by shuffle and added in index order; entry (a, b)
// of H sums its rows in production order; row i of the Cholesky factor is
// computed by lane i column by column, and both substitutions keep their
// order.  Lane a's entries b > a of H are not the symmetric ones (they are
// never read: the factorisation takes the lower triangle, and the predicted
// decrease reads entry (b, a) of the masked H from shared memory), so H is
// the plain version's lower triangle bit for bit.  Wrapping uses
// th - 2pi floor((th + pi) * (1 / 2pi)) with the reciprocal rounded to
// float, which is what PyTorch computes for a division by a scalar.
//
// Layout: row-major (B, ...) inputs, one problem per row; no transpose.
// The groups of a warp whose second problem lies past B solve a copy of the
// last problem and store nothing, so every shuffle has all 32 lanes.

#include <cuda_runtime.h>
#include <math.h>

#include "mpc_du_kernel.h"

using namespace mpc_du;

namespace {

static_assert(LANES == M, "one lane per decision variable");
static_assert(32 % LANES == 0 && THREADS % 32 == 0, "groups tile whole warps");

constexpr float INV_TWOPI = 1.0f / TWOPI_F;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HF_STRIDE = M + 1;  // padded rows: a column read hits 16 banks
constexpr int MIN_BLOCKS = 4;     // blocks an SM: at most 128 registers a thread

// Lane ``src`` of this lane's group holds ``v``: every lane gets it.
__device__ __forceinline__ float grp(float v, int src) {
  return __shfl_sync(FULL, v, src, LANES);
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
  int circle;
};

// One problem's shared state: its inputs, the per-row scalars, the row
// buffers and the masked H.
struct __align__(16) Shared {
  float row[2][M];  // first: 16-byte aligned for the float4 reads
  float Hf[M * HF_STRIDE];
  float lam[NC], cs[NC], act0[NC], r0[NR];
  float x0[4], goal[4], uprev[2];
  Obstacle obs[K];
  float spare[15];  // to 592 words: the two problems of a warp sit 16 banks apart
};
static_assert(sizeof(Shared) % 128 == 64, "adjacent problems 16 banks apart");

struct Params {
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

// The controls a rollout runs on: U itself, lane i holding U[i] ...
struct Controls {
  float u;
  __device__ float operator()(int i) const { return grp(u, i); }
};

// ... or one line-search candidate clamp(U + al * step), al per lane.
struct Candidate {
  float u, stp, al;
  const Params& p;
  __device__ float operator()(int i) const {
    return fminf(fmaxf(grp(u, i) + al * grp(stp, i), p.lb(i)), p.ub(i));
  }
};

// Rollout, residual rows and constraint rows (with JAC, lane j's entry of
// their Jacobian rows) handed to ``sink`` in production order: per stage k
// the four state rows, the K CBF rows, the v-upper and the v-lower row;
// then the 16 input-move rows, whose constant Jacobian enters the Newton
// system analytically.  Every lane of the group computes the same primal
// values; lane j carries tangent column j.
template <bool JAC, class Ctl, class Sink>
__device__ void forward(const Ctl& ctl, const Shared& s, const Params& p, int j, Sink& sink) {
  float x = s.x0[0], y = s.x0[1], th = s.x0[2], v = s.x0[3];
  float TX = 0.0f, TY = 0.0f, TTH = 0.0f, TV = 0.0f;
  float gprev[K], hprev[K];
  float gx_unused, gy_unused;
  const float dt = p.dt;
#pragma unroll
  for (int o = 0; o < K; ++o) {
    gprev[o] = 0.0f;
    hprev[o] = barrier<false>(s.obs[o], x, y, gx_unused, gy_unused);
  }

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const float a_k = ctl(2 * k);
    const float w_k = ctl(2 * k + 1);
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
    float TX2 = 0.0f, TY2 = 0.0f;
    if constexpr (JAC) {
      const float vs = v * sth, vc = v * cth;
      const float tx = TX + dt * (TV * cth - vs * TTH);
      const float ty = TY + dt * (TV * sth + vc * TTH);
      TX = tx;
      TY = ty;
      if (j == 2 * k + 1) TTH = TTH + dt;
      if (j == 2 * k) TV = TV + dt;
      const float v1s1 = v1 * s1, v1c1 = v1 * c1;
      TX2 = TX + dt * (TV * c1 - v1s1 * TTH);
      TY2 = TY + dt * (TV * s1 + v1c1 * TTH);
    }

    // State residual rows (x_{k+1} - goal) * sqrt(Q).
    sink.res(4 * k + 0, (x1 - s.goal[0]) * SQ_0, TX, SQ_0);
    sink.res(4 * k + 1, (y1 - s.goal[1]) * SQ_1, TY, SQ_1);
    sink.res(4 * k + 2, (th1 - s.goal[2]) * SQ_2, TTH, SQ_2);
    sink.res(4 * k + 3, (v1 - s.goal[3]) * SQ_3, TV, SQ_3);

    // CBF rows: ddh + (a1+a2) dh + a1 a2 h_k.
#pragma unroll
    for (int o = 0; o < K; ++o) {
      float gx1, gy1, gx2, gy2;
      const float h1 = barrier<JAC>(s.obs[o], x1, y1, gx1, gy1);
      const float h2 = barrier<JAC>(s.obs[o], x2, y2, gx2, gy2);
      const float hp = hprev[o];
      const float cbf = (h2 - 2.0f * h1 + hp) + p.a12s * (h1 - hp) + p.a12p * hp;
      float J = 0.0f;
      if constexpr (JAC) {
        const float g1 = gx1 * TX + gy1 * TY;
        const float g2 = gx2 * TX2 + gy2 * TY2;
        const float gp = gprev[o];
        J = (g2 - 2.0f * g1 + gp) + p.a12s * (g1 - gp) + p.a12p * gp;
        gprev[o] = g1;
      }
      hprev[o] = h1;
      sink.con(k * K + o, cbf, J);
    }

    // v bounds: v_max - v >= 0 and v + v_max >= 0.
    sink.con(N * K + k, p.v_max - v1, -TV);
    sink.con(N * K + N + k, v1 + p.v_max, TV);

    x = x1;
    y = y1;
    th = th1;
    v = v1;
  }

  // Input-move residual rows (u_k - u_{k-1}) * sqrt(R).
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float u = ctl(2 * k + i);
      const float prev = k == 0 ? s.uprev[i] : ctl(2 * (k - 1) + i);
      sink.res_in(4 * N + 2 * k + i, (u - prev) * sr_at(i));
    }
  }
}

// Row scale 1 / max(|Jc row|, 1e-2) at the warm start.
struct ScaleSink {
  Shared& s;
  int j;
  __device__ void res(int, float, float, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float, float J) {
    const float jj = J * J;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < M; ++q) sum = sum + grp(jj, q);
    if (j == 0) s.cs[i] = 1.0f / fmaxf(sqrtf(sum), 1e-2f);
  }
};

// grad[j] = (2 Jr'r - Jc'act)[j] and row j of H = 2 Jr'Jr + rho Jca'Jca
// (entries b <= j are the plain version's), plus the residuals, activations
// and base-cost sums at U.
struct NewtonSink {
  Shared& s;
  int j;
  float rho;
  float grad;
  float H[M];
  float rr, aa;
  int buf;

  // Every lane's ``val``, through the next row buffer.
  __device__ const float4* share(float val) {
    float* row = s.row[buf];
    buf ^= 1;
    row[j] = val;
    __syncwarp();
    return reinterpret_cast<const float4*>(row);
  }
  __device__ void add_outer(float t, const float4* row) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 r = row[q];
      H[4 * q + 0] = H[4 * q + 0] + t * r.x;
      H[4 * q + 1] = H[4 * q + 1] + t * r.y;
      H[4 * q + 2] = H[4 * q + 2] + t * r.z;
      H[4 * q + 3] = H[4 * q + 3] + t * r.w;
    }
  }
  __device__ void res(int i, float r, float T, float sq) {
    if (j == 0) s.r0[i] = r;
    rr = rr + r * r;
    const float row = T * sq;
    const float t = 2.0f * row;
    grad = grad + t * r;
    // (2 row[j]) row[b] rounds 2 row[j] row[b] as (2 row[b]) row[j] does.
    add_outer(t, share(row));
  }
  __device__ void res_in(int i, float r) {
    if (j == 0) s.r0[i] = r;
    rr = rr + r * r;
  }
  __device__ void con(int i, float c, float J) {
    const float cs = s.cs[i];
    const float a = fmaxf(0.0f, s.lam[i] - rho * (c * cs));
    if (j == 0) s.act0[i] = a;
    aa = aa + a * a;
    const float rs = J * cs;
    grad = grad - rs * a;
    const float4* row = share(rs);
    if (a > 0.0f) add_outer(rho * rs, row);
  }
};

// Cancellation-free merit difference L(candidate) - L(U).
struct MeritSink {
  const Shared& s;
  float rho;
  float dc, dp;
  __device__ void res(int i, float r, float, float) {
    dc = dc + (r - s.r0[i]) * (r + s.r0[i]);
  }
  __device__ void res_in(int i, float r) { dc = dc + (r - s.r0[i]) * (r + s.r0[i]); }
  __device__ void con(int i, float c, float) {
    const float a = fmaxf(0.0f, s.lam[i] - rho * (c * s.cs[i]));
    dp = dp + (a - s.act0[i]) * (a + s.act0[i]);
  }
};

// Multiplier update lam = max(0, lam - rho c_scaled).
struct LamSink {
  Shared& s;
  int j;
  float rho;
  __device__ void res(int, float, float, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float c, float) {
    if (j == 0) s.lam[i] = fmaxf(0.0f, s.lam[i] - rho * (c * s.cs[i]));
  }
};

// Smallest scaled constraint value.
struct MinSink {
  const Shared& s;
  float m;
  __device__ void res(int, float, float, float) {}
  __device__ void res_in(int, float) {}
  __device__ void con(int i, float c, float) { m = fminf(m, c * s.cs[i]); }
};

// One projected, damped Gauss-Newton step with line search on lane j's
// U[j] (``u``).
__device__ void newton_step(float& u, Shared& s, const Params& p, float rho, int j) {
  NewtonSink ns{s, j, rho, 0.0f, {}, 0.0f, 0.0f, 0};
  forward<true>(Controls{u}, s, p, j, ns);
  __syncwarp();  // r0 and act0

  // Input-move rows: gradient 2 Jr_in' r_in from the one/two-hot rows.
  const float add = (2.0f * sr_at(j & 1)) * s.r0[4 * N + j];
  const float add2 = j + 2 < M ? (2.0f * sr_at(j & 1)) * s.r0[4 * N + j + 2] : 0.0f;
  float grad = ns.grad + add;
  grad = grad - add2;

  // Levenberg damping scaled by the trace, the input-move diagonal included.
  float diag = ns.H[0];
#pragma unroll
  for (int b = 1; b < M; ++b) diag = j == b ? ns.H[b] : diag;
  float tr = grp(diag, 0) + ih_at(0, 0);
#pragma unroll
  for (int i = 1; i < M; ++i) tr = tr + grp(diag, i) + ih_at(i, i);
  const float damp = REG * (1.0f + tr / static_cast<float>(M));

  // Projected free set: freeze variables at an active bound pushed outward.
  const float lb = p.lb(j), ub = p.ub(j);
  const bool at_lb = (u <= lb + 1e-7f) && (grad > 0.0f);
  const bool at_ub = (u >= ub - 1e-7f) && (grad < 0.0f);
  const float fr = (at_lb || at_ub) ? 0.0f : 1.0f;
  const float gf = fr * grad;
  // Row j of Hf: masked, damped, identity on frozen variables; to shared
  // memory for the predicted decrease.
  float* hf = s.Hf + j * HF_STRIDE;
#pragma unroll
  for (int b = 0; b < M; ++b) {
    float h = (ns.H[b] + ih_at(j, b)) * fr * grp(fr, b);
    if (j == b) h = h + damp * fr + (1.0f - fr);
    ns.H[b] = h;
    hf[b] = h;
  }
  __syncwarp();  // Hf, read back for the predicted decrease

  // Cholesky with the pivot clamp: lane i computes row i, column by column,
  // taking row c's entries from lane c.  Lanes above the column compute
  // values nobody reads.
  float L[M];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    float acc = ns.H[c];
#pragma unroll
    for (int k = 0; k < c; ++k) acc = acc - L[k] * grp(L[k], c);
    const float d = sqrtf(fmaxf(acc, 1e-20f));
    const float dc = grp(d, c);
    L[c] = j == c ? d : acc / dc;
  }
  // step = -Hf^-1 gf: forward substitution by columns (lane c finishes
  // w[c], the lanes below take its term), ...
  float acc = -gf;
  float w = 0.0f;
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const float wc = grp(acc / L[c], c);
    if (j == c) w = wc;
    if (j > c) acc = acc - L[c] * wc;
  }
  // ... back substitution in every lane alike, L[k][i] from lane k.
  float stp[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float t = grp(w, i);
#pragma unroll
    for (int k = i + 1; k < M; ++k) t = t - grp(L[i], k) * stp[k];
    stp[i] = t / grp(L[i], i);
  }
  float st = stp[0];
#pragma unroll
  for (int b = 1; b < M; ++b) st = j == b ? stp[b] : st;

  // Noise-aware acceptance: if the model's predicted decrease is below the
  // merit's rounding floor, take the full damped Newton step.
  const float base_cost = ns.rr + ns.aa / (2.0f * rho);
  const float noise_floor = NOISE_EPS * base_cost;
  float hs = 0.0f;
#pragma unroll
  for (int b = 0; b < M; ++b) {
    const float h = b <= j ? s.Hf[j * HF_STRIDE + b] : s.Hf[b * HF_STRIDE + j];  // sym(Hf, j, b)
    hs = b == 0 ? h * stp[0] : hs + h * stp[b];
  }
  const float gs = gf * st, sh = st * hs;
  float pg = 0.0f, ph = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    pg = pg + grp(gs, i);
    ph = ph + grp(sh, i);
  }
  const float pred = pg + 0.5f * ph;

  // Line search over six step lengths on merit differences: lane a runs
  // candidate a (lanes past the last run the last again).
  MeritSink ms{s, rho, 0.0f, 0.0f};
  forward<false>(Candidate{u, st, alpha_at(j), p}, s, p, j, ms);
  float d = ms.dc + ms.dp / (2.0f * rho);
  if (!isfinite(d)) d = INFINITY;
  int best = 0;
  float best_val = 0.0f;
#pragma unroll
  for (int ai = 0; ai < NUM_ALPHAS; ++ai) {
    const float da = grp(d, ai);
    if (ai == 0 || da < best_val) {  // first index on ties
      best = ai;
      best_val = da;
    }
  }
  if (pred >= -noise_floor) best = 0;
  const float al = alpha_at(best);
  u = fminf(fmaxf(u + al * st, lb), ub);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mpc_du_kernel(const float* __restrict__ x0, const float* __restrict__ goal,
              const float* __restrict__ obs, const float* __restrict__ uprev,
              const float* __restrict__ U0, float* __restrict__ U_out,
              float* __restrict__ viol_out, int B, float dt, float a1, float a2,
              float beta, float radius, float v_max, float a_max, float w_max) {
  __shared__ Shared shared[PROBLEMS_PER_BLOCK];
  const int g = threadIdx.x / LANES;
  const int j = threadIdx.x % LANES;
  const int first = blockIdx.x * PROBLEMS_PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / LANES) >= B) return;  // the whole warp is idle
  const bool valid = first + g < B;
  const int b = valid ? first + g : B - 1;
  Shared& s = shared[g];

  if (j < K) {
    const float* ob = obs + static_cast<size_t>(b) * K * OBS_DIM + j * OBS_DIM;
    Obstacle& q = s.obs[j];
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
  if (j < 4) {
    s.x0[j] = x0[4 * b + j];
    s.goal[j] = goal[4 * b + j];
  }
  if (j < 2) s.uprev[j] = uprev[2 * b + j];
  for (int i = j; i < NC; i += LANES) s.lam[i] = 0.0f;
  const Params p{dt, a1 + a2, a1 * a2, v_max, a_max, w_max};
  float u = U0[M * b + j];
  __syncwarp();
  {
    ScaleSink ss{s, j};
    forward<true>(Controls{u}, s, p, j, ss);
  }
  __syncwarp();  // cs
  u = fminf(fmaxf(u, p.lb(j)), p.ub(j));

  float rho = RHO0;
#pragma unroll 1
  for (int outer = 0; outer < OUTER; ++outer) {
#pragma unroll 1
    for (int it = 0; it < NEWTON; ++it) newton_step(u, s, p, rho, j);
    LamSink ls{s, j, rho};
    forward<false>(Controls{u}, s, p, j, ls);
    __syncwarp();  // lam
    rho = fminf(rho * RHO_GROWTH, RHO_MAX);
  }
  MinSink ms{s, INFINITY};
  forward<false>(Controls{u}, s, p, j, ms);
  if (valid) {
    U_out[M * b + j] = u;
    if (j == 0) viol_out[b] = fmaxf(0.0f, -ms.m);
  }
}

}  // namespace

extern "C" int mpc_du_launch(const void* x0, const void* goal, const void* obs,
                             const void* uprev, const void* U0, void* U_out, void* viol,
                             int B, float dt, float a1, float a2, float beta, float radius,
                             float v_max, float a_max, float w_max, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + PROBLEMS_PER_BLOCK - 1) / PROBLEMS_PER_BLOCK;
  mpc_du_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(goal),
      static_cast<const float*>(obs), static_cast<const float*>(uprev),
      static_cast<const float*>(U0), static_cast<float*>(U_out), static_cast<float*>(viol),
      B, dt, a1, a2, beta, radius, v_max, a_max, w_max);
  return static_cast<int>(cudaGetLastError());
}
