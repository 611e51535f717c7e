// Generic fused AL-Gauss-Newton MPC-CBF solve, one thread block per problem.
//
// Replaces the Pallas TPU kernel of safe_control_tpu/solvers/mpc_fused.py
// (the ``kernel`` closure of ``_build_solver``), which traced the package's
// model code with jax.linearize inside the kernel.  CUDA has no trace-time
// autodiff, so the Jacobian columns come from forward-mode dual numbers
// (mpc_fused_dual.h) run through each model's step and barrier templates
// (mpc_fused_models.h): thread d of the block rolls the model out on
// (value, d/dU_d) pairs and writes column d of Jr (residual rows) and of Jc
// (scaled constraint rows) to shared memory.  That is what torch.func.jvp
// under vmap over the M basis tangents computes in the plain version,
// solvers/mpc_fused.py::solve_fused_batch_reference.
//
// Per Newton step: the dual rollouts; the active constraint rows listed in
// index order; grad = 2 Jr'r - Jc'act and H = 2 Jr'Jr + rho Jca'Jca over
// every thread of the block (below); the trace-scaled damping and the
// projected free set; a left-looking Cholesky in shared memory with the
// pivot clamp sqrt(max(s, 1e-20)), one column at a time with the rows across
// threads; right-looking forward and back substitutions; the six line-search
// candidates, one thread each, on values only; the noise-aware acceptance.
// Then the multiplier update, as _make_algorithm does.  Every sum runs in
// the plain version's order, and the file is built with -fmad=false and no
// fast math, so the two can agree to rounding; every clamp, max and min of
// the solver returns a NaN operand as PyTorch's do (a model whose
// derivative is NaN, as the C3BF and DPCBF barriers' at zero relative
// velocity, gives the plain version's NaN solution).
//
// H is symmetric, so only its upper triangle is summed: the block's threads
// take 2x2 tiles of entries (a, b), a <= b, one accumulator an entry (four
// independent chains, four shared loads in flight a row), and each entry is
// written to (a, b) and mirrored to (b, a).  An entry is the sum of the same
// products in the same order as a whole row by one thread would give
// (x * y rounds as y * x), and the Jc'Jc sum runs over the listed active
// rows only, the terms a test act > 0 would keep.  grad's M entries follow
// the tiles in the block's list of work items, one entry a thread.
//
// What bounds it: the latency of each block's serial path; DRAM traffic is
// a few hundred bytes a problem.  With one part of the Newton step skipped
// at a time (fused_kernel_ab.py; NVIDIA H100 80GB HBM3, 700 W; Quad3D N=10,
// B=1, 1.68 ms a solve), the factor and substitutions (3 M barriers) take
// 0.70 ms, the dual rollouts 0.25, the line search's rollouts 0.25, grad and
// H 0.18.  Jr and Jc are read only while grad and H are formed, so L and
// the line search's arrays reuse their space: the layout takes 44,932 bytes
// of shared memory at Quad3D N=10 (M=40) and 111,072 at VTOL2D N=16
// (M=64), room for five and two 128-thread blocks an SM.
//
// Layout: row-major (B, ...) inputs, one problem per block; no transpose.

#include <cuda_runtime.h>
#include <math.h>

#include "mpc_fused_dual.h"
#include "mpc_fused_models.h"

using namespace mpc_fused;

namespace {

constexpr int NUM_ALPHAS = 6;
constexpr int OBS_DIM = 7;
constexpr int COMMON = 9;  // rho0, growth, rho_max, reg, gain a, gain b, radius, beta, dt
constexpr int OBSTACLE_FLOATS = 12;  // an Obstacle in shared memory
constexpr float NOISE_EPS = (float)(4.0 * 1.1920928955078125e-07);  // 4 eps_f32

// Threads a block (at least M = 64, the widest decision vector admitted),
// and the blocks an SM that the register allocation must leave room for:
// five, as many as Quad3D N=10's shared memory allows, hold a thread to 96
// registers (Quad3D fits without spills, VTOL2D spills about 100 bytes).
// Of 4 or 5 blocks and 64, 96 or 128 threads, the fastest at B=4096.
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 5;
static_assert(THREADS % 32 == 0 && THREADS >= 64, "a block is whole warps, one thread a variable");

__device__ __forceinline__ float alpha_at(int i) {
  switch (i) {
    case 0: return 1.0f;
    case 1: return 0.5f;
    case 2: return 0.25f;
    case 3: return (float)0.1;
    case 4: return (float)0.03;
    default: return 0.0f;
  }
}

// Sizes of one configuration and where each array lives in shared memory.
struct Layout {
  int n, m, N, K, NB, M, NR, NC, nP;
  int P, x0, goal, uprev, obs, Jr, Jc, L, cand, ra, ca, H, r0, c0, act0, lam, cs, U, stp, grad,
      gf, fr, tmp, w, Hs, dv, sc, hp, act, total;
  __host__ __device__ Layout(int n_, int m_, int N_, int K_, int NB_, int nP_)
      : n(n_), m(m_), N(N_), K(K_), NB(NB_), M(N_ * m_), NR(N_ * (n_ + m_)),
        NC(N_ * K_ + 2 * N_ * NB_), nP(nP_) {
    total = 0;
    P = take(nP); x0 = take(n); goal = take(n); uprev = take(m);
    obs = take(K * OBSTACLE_FLOATS);
    // Jr and Jc live from the rollouts until grad and H are formed; L and
    // the line search's candidates and rows then take their place.
    Jr = L = total;
    Jc = Jr + NR * M;
    cand = L + M * M;
    ra = cand + NUM_ALPHAS * M;
    ca = ra + NUM_ALPHAS * NR;
    take(max_of(M * (NR + NC), M * M + NUM_ALPHAS * (M + NR + NC)));
    H = take(M * M);
    r0 = take(NR); c0 = take(NC); act0 = take(NC); lam = take(NC); cs = take(NC);
    U = take(M); stp = take(M); grad = take(M); gf = take(M); fr = take(M); tmp = take(M);
    w = take(M); Hs = take(M);
    dv = take(NUM_ALPHAS); sc = take(8);
    // Per-thread barrier values of the previous stage in the rollouts; while
    // grad and H are formed, the count and list of active constraint rows.
    hp = act = total;
    take(max_of(max_of(M, NUM_ALPHAS) * K * 2, NC + 1));
  }
  // The offset of the next ``count`` floats.
  __host__ __device__ int take(int count) {
    const int at = total;
    total += count;
    return at;
  }
  __host__ __device__ static int max_of(int a, int b) { return a > b ? a : b; }
};

// The decision vector as a thread sees it: values only, or values with a
// unit tangent on entry d for the Jacobian column d.
template <class T>
struct DecisionView;
template <>
struct DecisionView<float> {
  const float* U;
  __device__ float operator()(int j) const { return U[j]; }
};
template <>
struct DecisionView<Dual> {
  const float* U;
  int d;
  __device__ Dual operator()(int j) const { return Dual(U[j], j == d ? 1.0f : 0.0f); }
};

// Residual rows (state, then input moves) and raw constraint rows (CBF,
// then the clamped state bounds) at U, handed to ``sink`` with their index:
// the rows of the plain version's ``rows``, in the same layout.
template <class Model, class T, class View, class Sink>
__device__ void eval_rows(const Layout& lo, const float* sh, const Obstacle* obs, const View& U,
                          T* hprev, Sink& sink) {
  constexpr int n = Model::n, m = Model::m;
  const float* P = sh + lo.P;
  const float ga = P[4], gb = P[5], dt = P[8];
  const float* Qs = P + COMMON;
  const float* Rs = Qs + n;
  const float* bounds = Rs + 3 * m;
  const float* mp = bounds + 3 * lo.NB;
  const int N = lo.N, K = lo.K;

  T x[n], x1[n], u[m];
  for (int i = 0; i < n; ++i) x[i] = T(sh[lo.x0 + i]);
  sink.state(0, x);
  for (int o = 0; o < K; ++o) hprev[o] = Model::dt_h(x, obs[o], mp);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < m; ++j) u[j] = U(k * m + j);
    Model::step(x, u, x1, mp, dt);
    sink.state(k + 1, x1);
    for (int i = 0; i < n; ++i) sink.res(k * n + i, (x1[i] - sh[lo.goal + i]) * Qs[i]);
    T x2[n];
    if constexpr (Model::REL_DEG == 2) Model::step(x1, u, x2, mp, dt);  // the same u_k, not x_{k+2}
#pragma unroll 1
    for (int o = 0; o < K; ++o) {
      const T h1 = Model::dt_h(x1, obs[o], mp);
      const T h0 = hprev[o];
      T cbf;
      if constexpr (Model::REL_DEG == 1) {
        cbf = (h1 - h0) + ga * h0;
      } else {
        const T h2 = Model::dt_h(x2, obs[o], mp);
        cbf = (((h2 - 2.0f * h1) + h0) + ga * (h1 - h0)) + gb * h0;
      }
      sink.con(k * K + o, cbf);
      hprev[o] = h1;
    }
    for (int b = 0; b < lo.NB; ++b) {
      const int i = static_cast<int>(bounds[3 * b]);
      sink.con(N * K + 2 * b * N + k, bounds[3 * b + 2] - x1[i]);
      sink.con(N * K + (2 * b + 1) * N + k, x1[i] - bounds[3 * b + 1]);
    }
    for (int i = 0; i < n; ++i) x[i] = x1[i];
  }
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < m; ++j) {
      const T prev = k == 0 ? T(sh[lo.uprev + j]) : U((k - 1) * m + j);
      sink.res(N * n + k * m + j, (U(k * m + j) - prev) * Rs[j]);
    }
  }
}

// Column d of Jr and of the scaled Jc; thread 0 also writes the values.
struct JacobianSink {
  float* Jr;
  float* Jc;
  float* r0;
  float* c0;
  const float* cs;
  int M, d;
  __device__ void state(int, const Dual*) {}
  __device__ void res(int i, const Dual& r) {
    Jr[i * M + d] = r.t;
    if (d == 0) r0[i] = r.v;
  }
  __device__ void con(int i, const Dual& c) {
    Jc[i * M + d] = c.t * cs[i];
    if (d == 0) c0[i] = c.v * cs[i];
  }
};

// Values only: residual rows and raw constraint rows into two arrays, and
// optionally the rollout.
struct ValueSink {
  float* r;
  float* c;
  float* xs;  // (N+1, n) or null
  int n;
  __device__ void state(int k, const float* x) {
    if (xs) for (int i = 0; i < n; ++i) xs[k * n + i] = x[i];
  }
  __device__ void res(int i, float v) { if (r) r[i] = v; }
  __device__ void con(int i, float v) { c[i] = v; }
};

template <class Model>
__device__ void newton_step(const Layout& lo, float* sh, const Obstacle* obs, float rho) {
  const int M = lo.M, NR = lo.NR, NC = lo.NC;
  const int tid = threadIdx.x;
  const float* P = sh + lo.P;
  const float* lbu = P + COMMON + Model::n + Model::m;
  const float* ubu = lbu + Model::m;
  float* Jr = sh + lo.Jr;
  float* Jc = sh + lo.Jc;
  float* H = sh + lo.H;
  float* L = sh + lo.L;
  float* U = sh + lo.U;
  float* stp = sh + lo.stp;
  float* sc = sh + lo.sc;

  // Jacobian columns, one per thread.
  if (tid < M) {
    JacobianSink js{Jr, Jc, sh + lo.r0, sh + lo.c0, sh + lo.cs, M, tid};
    DecisionView<Dual> view{U, tid};
    eval_rows<Model, Dual>(lo, sh, obs, view, reinterpret_cast<Dual*>(sh + lo.hp) + tid * lo.K,
                           js);
  }
  __syncthreads();
  const float* act0 = sh + lo.act0;
  for (int i = tid; i < NC; i += blockDim.x) {
    sh[lo.act0 + i] = clamp_min_nan(sh[lo.lam + i] - rho * sh[lo.c0 + i], 0.0f);
  }
  __syncthreads();
  // The active rows in index order: act[0] of them, in act[1..].
  int* act = reinterpret_cast<int*>(sh + lo.act);
  if (tid == 0) {
    int count = 0;
    for (int i = 0; i < NC; ++i) {
      if (act0[i] > 0.0f) act[++count] = i;
    }
    act[0] = count;
  }
  __syncthreads();

  // The upper triangle of H in 2x2 tiles, then grad, over the block.
  const int pairs = (M + 1) / 2;
  const int tiles = pairs * (pairs + 1) / 2;
  for (int item = tid; item < tiles + M; item += blockDim.x) {
    if (item >= tiles) {
      const int a = item - tiles;
      float g1 = 0.0f, g2 = 0.0f;
#pragma unroll 4
      for (int i = 0; i < NR; ++i) g1 = g1 + Jr[i * M + a] * sh[lo.r0 + i];
#pragma unroll 4
      for (int i = 0; i < NC; ++i) g2 = g2 + Jc[i * M + a] * act0[i];
      sh[lo.grad + a] = 2.0f * g1 - g2;
      continue;
    }
    int p = 0, q = item;  // tile (p, p + q) of the row-major upper triangle
    while (q >= pairs - p) {
      q -= pairs - p;
      ++p;
    }
    const int a0 = 2 * p, b0 = 2 * (p + q);
    const int a1 = min(a0 + 1, M - 1), b1 = min(b0 + 1, M - 1);  // an odd M repeats the last
    float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < NR; ++i) {
      const float* row = Jr + i * M;
      const float x0 = row[a0], x1 = row[a1], y0 = row[b0], y1 = row[b1];
      s00 = s00 + x0 * y0;
      s01 = s01 + x0 * y1;
      s10 = s10 + x1 * y0;
      s11 = s11 + x1 * y1;
    }
    float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
    const int n_act = act[0];
    for (int k = 1; k <= n_act; ++k) {
      const float* row = Jc + act[k] * M;
      const float x0 = row[a0], x1 = row[a1], y0 = row[b0], y1 = row[b1];
      c00 = c00 + x0 * y0;
      c01 = c01 + x0 * y1;
      c10 = c10 + x1 * y0;
      c11 = c11 + x1 * y1;
    }
    const float e[4] = {2.0f * s00 + rho * c00, 2.0f * s01 + rho * c01, 2.0f * s10 + rho * c10,
                        2.0f * s11 + rho * c11};
    for (int k = 0; k < 4; ++k) {
      const int a = a0 + (k >> 1), b = b0 + (k & 1);
      if (a < M && b < M) {
        H[a * M + b] = e[k];
        H[b * M + a] = e[k];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    float tr = 0.0f;
    for (int i = 0; i < M; ++i) tr = tr + H[i * M + i];
    sc[0] = P[3] * (1.0f + tr / static_cast<float>(M));  // reg (1 + tr / M)
  }
  __syncthreads();
  // Damping, then the projected free set: freeze variables at an active
  // bound whose gradient points outward.
  if (tid < M) {
    const int a = tid;
    H[a * M + a] = H[a * M + a] + sc[0];
    const int j = a % Model::m;
    const float g = sh[lo.grad + a];
    const bool at_lb = (U[a] <= lbu[j] + 1e-7f) && (g > 0.0f);
    const bool at_ub = (U[a] >= ubu[j] - 1e-7f) && (g < 0.0f);
    const bool free = !(at_lb || at_ub);
    sh[lo.fr + a] = free ? 1.0f : 0.0f;
    sh[lo.gf + a] = free ? g : 0.0f;
  }
  __syncthreads();
  if (tid < M) {
    const int a = tid;
    const bool fa = sh[lo.fr + a] != 0.0f;
    for (int b = 0; b < M; ++b) {
      const bool fb = sh[lo.fr + b] != 0.0f;
      if (!(fa && fb)) H[a * M + b] = a == b ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // Left-looking Cholesky, column j over the rows i >= j.
  float* tmp = sh + lo.tmp;
  for (int j = 0; j < M; ++j) {
    if (tid >= j && tid < M) {
      float s = H[tid * M + j];
      for (int k = 0; k < j; ++k) s = s - L[tid * M + k] * L[j * M + k];
      tmp[tid] = s;
    }
    __syncthreads();
    if (tid >= j && tid < M) {
      const float d = sqrtf(clamp_min_nan(tmp[j], 1e-20f));
      L[tid * M + j] = tid == j ? d : tmp[tid] / d;
    }
    __syncthreads();
  }
  // L w = gf, then L' x = w, each right-looking; the step is -x.
  float* w = sh + lo.w;
  if (tid < M) tmp[tid] = sh[lo.gf + tid];
  __syncthreads();
  for (int j = 0; j < M; ++j) {
    if (tid < M) {
      const float wj = tmp[j] / L[j * M + j];
      if (tid > j) tmp[tid] = tmp[tid] - L[tid * M + j] * wj;
      if (tid == j) w[j] = wj;
    }
    __syncthreads();
  }
  for (int j = M - 1; j >= 0; --j) {
    if (tid < M) {
      const float xj = w[j] / L[j * M + j];
      if (tid < j) w[tid] = w[tid] - L[j * M + tid] * xj;
      if (tid == j) stp[j] = -xj;
    }
    __syncthreads();
  }

  // Predicted decrease of the quadratic model, and the six candidates.
  if (tid < M) {
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s = s + H[tid * M + j] * stp[j];
    sh[lo.Hs + tid] = s;
  }
  if (tid < NUM_ALPHAS) {
    const float al = alpha_at(tid);
    float* cand = sh + lo.cand + tid * M;
    for (int i = 0; i < M; ++i) {
      const int j = i % Model::m;
      cand[i] = clamp_nan(U[i] + al * stp[i], lbu[j], ubu[j]);
    }
    ValueSink vs{sh + lo.ra + tid * NR, sh + lo.ca + tid * NC, nullptr, Model::n};
    DecisionView<float> view{cand};
    eval_rows<Model, float>(lo, sh, obs, view, sh + lo.hp + tid * lo.K * 2, vs);
  }
  __syncthreads();
  if (tid < NUM_ALPHAS) {
    const float* ra = sh + lo.ra + tid * NR;
    const float* ca = sh + lo.ca + tid * NC;
    float dc = 0.0f, dp = 0.0f;
    for (int i = 0; i < NR; ++i) {
      const float r0 = sh[lo.r0 + i];
      dc = dc + (ra[i] - r0) * (ra[i] + r0);
    }
    for (int i = 0; i < NC; ++i) {
      const float a = clamp_min_nan(sh[lo.lam + i] - rho * (ca[i] * sh[lo.cs + i]), 0.0f);
      const float a0 = sh[lo.act0 + i];
      dp = dp + (a - a0) * (a + a0);
    }
    const float d = dc + dp / (2.0f * rho);
    sh[lo.dv + tid] = isfinite(d) ? d : INFINITY;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    float best_val = sh[lo.dv];
    for (int a = 1; a < NUM_ALPHAS; ++a) {
      if (sh[lo.dv + a] < best_val) {  // first index on ties
        best = a;
        best_val = sh[lo.dv + a];
      }
    }
    // Noise-aware acceptance: if the model's predicted decrease is below
    // the merit's rounding floor, take the full damped Newton step.
    float rr = 0.0f, aa = 0.0f, pg = 0.0f, ph = 0.0f;
    for (int i = 0; i < NR; ++i) rr = rr + sh[lo.r0 + i] * sh[lo.r0 + i];
    for (int i = 0; i < NC; ++i) aa = aa + sh[lo.act0 + i] * sh[lo.act0 + i];
    for (int i = 0; i < M; ++i) pg = pg + sh[lo.gf + i] * stp[i];
    for (int i = 0; i < M; ++i) ph = ph + stp[i] * sh[lo.Hs + i];
    const float noise_floor = NOISE_EPS * (rr + aa / (2.0f * rho));
    const float pred = pg + 0.5f * ph;
    if (pred >= -noise_floor) best = 0;
    sc[1] = alpha_at(best);
  }
  __syncthreads();
  if (tid < M) {
    const int j = tid % Model::m;
    U[tid] = clamp_nan(U[tid] + sc[1] * stp[tid], lbu[j], ubu[j]);
  }
  __syncthreads();
}

template <class Model>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    mpc_fused_kernel(const float* __restrict__ x0, const float* __restrict__ goal,
                     const float* __restrict__ obs, const float* __restrict__ uprev,
                     const float* __restrict__ U0, const float* __restrict__ params,
                     float* __restrict__ U_out, float* __restrict__ xs_out,
                     float* __restrict__ viol_out, int N, int K, int NB, int nP, int outer,
                     int newton) {
  extern __shared__ float sh[];
  constexpr int n = Model::n, m = Model::m;
  const Layout lo(n, m, N, K, NB, nP);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int M = lo.M, NC = lo.NC;
  float* P = sh + lo.P;
  for (int i = tid; i < nP; i += blockDim.x) P[i] = params[i];
  for (int i = tid; i < n; i += blockDim.x) {
    sh[lo.x0 + i] = x0[static_cast<size_t>(b) * n + i];
    sh[lo.goal + i] = goal[static_cast<size_t>(b) * n + i];
  }
  for (int i = tid; i < m; i += blockDim.x) sh[lo.uprev + i] = uprev[static_cast<size_t>(b) * m + i];
  __syncthreads();
  Obstacle* ob = reinterpret_cast<Obstacle*>(sh + lo.obs);
  static_assert(sizeof(Obstacle) <= OBSTACLE_FLOATS * sizeof(float),
                "Obstacle must fit its shared-memory slot");
  const float radius = P[6], beta = P[7];
  for (int o = tid; o < K; o += blockDim.x) {
    const float* src = obs + (static_cast<size_t>(b) * K + o) * OBS_DIM;
    Obstacle q;
    q.ox = src[0];
    q.oy = src[1];
    const float d_min = src[2] + radius;
    q.circ_off = beta * (d_min * d_min);
    q.ar = fmaxf(fabsf(src[2]), 1e-3f) + radius;
    q.br = fmaxf(fabsf(src[3]), 1e-3f) + radius;
    q.e = fmaxf(fabsf(src[4]), 2.0f);
    q.ct = cosf(src[5]);
    q.st = sinf(src[5]);
    q.d_min = d_min;
    q.vx = src[3];
    q.vy = src[4];
    q.circle = src[6] < 0.5f;
    ob[o] = q;
  }
  // The warm start, clipped to the input box; unit row scales for the pass
  // that measures them.
  const float* lbu = P + COMMON + n + m;
  const float* ubu = lbu + m;
  float* U = sh + lo.U;
  for (int i = tid; i < M; i += blockDim.x) {
    U[i] = clamp_nan(U0[static_cast<size_t>(b) * M + i], lbu[i % m], ubu[i % m]);
  }
  for (int i = tid; i < NC; i += blockDim.x) {
    sh[lo.cs + i] = 1.0f;
    sh[lo.lam + i] = 0.0f;
  }
  __syncthreads();

  // Constraint row scales 1 / max(|Jc row|, 1e-2) at the warm start.
  if (tid < M) {
    JacobianSink js{sh + lo.Jr, sh + lo.Jc, sh + lo.r0, sh + lo.c0, sh + lo.cs, M, tid};
    DecisionView<Dual> view{U, tid};
    eval_rows<Model, Dual>(lo, sh, ob, view, reinterpret_cast<Dual*>(sh + lo.hp) + tid * K, js);
  }
  __syncthreads();
  for (int i = tid; i < NC; i += blockDim.x) {
    const float* row = sh + lo.Jc + i * M;
    float s = 0.0f;
    for (int d = 0; d < M; ++d) s = s + row[d] * row[d];
    sh[lo.cs + i] = 1.0f / clamp_min_nan(sqrtf(s), 1e-2f);
  }
  __syncthreads();

  float rho = P[0];
#pragma unroll 1
  for (int it = 0; it < outer; ++it) {
#pragma unroll 1
    for (int k = 0; k < newton; ++k) newton_step<Model>(lo, sh, ob, rho);
    // Multiplier update from the scaled constraints at U (thread 0 rolls out).
    if (tid == 0) {
      ValueSink vs{nullptr, sh + lo.ca, nullptr, n};
      DecisionView<float> view{U};
      eval_rows<Model, float>(lo, sh, ob, view, sh + lo.hp, vs);
    }
    __syncthreads();
    for (int i = tid; i < NC; i += blockDim.x) {
      sh[lo.lam + i] = clamp_min_nan(sh[lo.lam + i] - rho * (sh[lo.ca + i] * sh[lo.cs + i]), 0.0f);
    }
    rho = fminf(rho * P[1], P[2]);
    __syncthreads();
  }

  // Outputs: U, the rollout and the largest scaled violation.
  for (int i = tid; i < M; i += blockDim.x) U_out[static_cast<size_t>(b) * M + i] = U[i];
  if (tid == 0) {
    ValueSink vs{nullptr, sh + lo.ca, xs_out + static_cast<size_t>(b) * (N + 1) * n, n};
    DecisionView<float> view{U};
    eval_rows<Model, float>(lo, sh, ob, view, sh + lo.hp, vs);
    float mn = INFINITY;  // a NaN row makes the minimum NaN, as torch.min does
    for (int i = 0; i < NC; ++i) {
      const float c = sh[lo.ca + i] * sh[lo.cs + i];
      mn = (c != c || mn != mn) ? c + mn : fminf(mn, c);
    }
    viol_out[b] = clamp_min_nan(-mn, 0.0f);
  }
}

// The block's dynamic shared memory in bytes, after the kernel is allowed
// that much and the largest shared-memory carveout; a CUDA error code (> 0)
// if either is refused.
template <class Model>
int configure(int N, int K, int NB, int nP, size_t* bytes) {
  *bytes = static_cast<size_t>(Layout(Model::n, Model::m, N, K, NB, nP).total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mpc_fused_kernel<Model>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mpc_fused_kernel<Model>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return static_cast<int>(err);
}

// ``f(Model{})`` for the model of id ``model``
// (solvers/mpc_fused.py::MODEL_IDS); -1 for an unknown model.
template <class F>
int with_model(int model, F&& f) {
#define MPC_FUSED_CASE(ID, MODEL) \
  case ID:                        \
    return f(MODEL{});
  switch (model) {
    MPC_FUSED_CASE(0, SingleIntegrator2D)
    MPC_FUSED_CASE(1, DoubleIntegrator2D)
    MPC_FUSED_CASE(2, DynamicUnicycle2D)
    MPC_FUSED_CASE(3, Quad3D)
    MPC_FUSED_CASE(4, VTOL2D)
    MPC_FUSED_CASE(5, Unicycle2D)
    MPC_FUSED_CASE(6, KinematicBicycle2D)
    MPC_FUSED_CASE(7, KinematicBicycle2D_C3BF)
    MPC_FUSED_CASE(8, KinematicBicycle2D_DPCBF)
    MPC_FUSED_CASE(9, Quad2D)
    MPC_FUSED_CASE(10, Manipulator2D)
    MPC_FUSED_CASE(11, DynamicBicycle2D)
    MPC_FUSED_CASE(12, DriftingCar)
    default:
      return -1;
  }
#undef MPC_FUSED_CASE
}

}  // namespace

// Dynamic shared memory (bytes) of one block, for the build report.
extern "C" int mpc_fused_shared_bytes(int model, int N, int K, int NB, int nP) {
  return with_model(model, [&](auto mdl) {
    using Model = decltype(mdl);
    return Layout(Model::n, Model::m, N, K, NB, nP).total * static_cast<int>(sizeof(float));
  });
}

// Threads a block, for the build report.
extern "C" int mpc_fused_threads() { return THREADS; }

// Blocks of this configuration that fit on one SM at once (the occupancy
// calculator, after the launch's shared-memory settings); minus a CUDA
// error code if a call is refused.
extern "C" int mpc_fused_blocks_per_sm(int model, int N, int K, int NB, int nP) {
  return with_model(model, [&](auto mdl) {
    using Model = decltype(mdl);
    size_t bytes;
    int err = configure<Model>(N, K, NB, nP, &bytes);
    int blocks = 0;
    if (err == 0) {
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mpc_fused_kernel<Model>, THREADS, bytes));
    }
    return err == 0 ? blocks : -err;
  });
}

// model: 0 SingleIntegrator2D, 1 DoubleIntegrator2D, 2 DynamicUnicycle2D,
// 3 Quad3D, 4 VTOL2D, 5 Unicycle2D, 6 KinematicBicycle2D, 7 its C3BF and
// 8 its DPCBF variant, 9 Quad2D, 10 Manipulator2D, 11 DynamicBicycle2D,
// 12 DriftingCar (solvers/mpc_fused.py::MODEL_IDS).  Returns a CUDA
// error code; -1 for an unknown model.
extern "C" int mpc_fused_launch(int model, const void* x0, const void* goal, const void* obs,
                                const void* uprev, const void* U0, const void* params,
                                void* U_out, void* xs_out, void* viol, int B, int N, int K,
                                int NB, int nP, int outer, int newton, void* stream) {
  if (B <= 0) return 0;
  return with_model(model, [&](auto mdl) {
    using Model = decltype(mdl);
    size_t bytes;
    const int err = configure<Model>(N, K, NB, nP, &bytes);
    if (err != 0) return err;
    mpc_fused_kernel<Model><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0), static_cast<const float*>(goal),
        static_cast<const float*>(obs), static_cast<const float*>(uprev),
        static_cast<const float*>(U0), static_cast<const float*>(params),
        static_cast<float*>(U_out), static_cast<float*>(xs_out), static_cast<float*>(viol), N,
        K, NB, nP, outer, newton);
    return static_cast<int>(cudaGetLastError());
  });
}
