// Staged OSQP-style ADMM on batched, equilibrated dense QPs
//     minimize 0.5 x'Px + q'x   subject to   l <= Ax <= u.
//
// Replaces safe_control_tpu/solvers/qp_kernel.py::_admm_kernel (the Pallas
// TPU kernel).  A'A once, then N_STAGES stages, each refactoring
// K = P + sigma I + rho A'A by an n x n Cholesky and running per_stage
// over-relaxed x/z/y sweeps with a clip projection, then a per-problem
// adaptive rho from the primal/dual residual ratio.  Equilibration, the
// active-set polish, unscaling and the residuals run in PyTorch around the
// launch (solvers/qp_kernel.py), as the JAX package runs them around its
// kernel.
//
// What bounds it on the H100: neither bytes nor FP32 rate.  A problem is
// 34 floats in at n=2, m=7 (0.56 MB at B=4096, an FP32 bound of about
// 0.013 ms), but every sweep depends on the last one: a sweep's dependent
// chain (the right-hand side summed over m rows, two triangular solves
// with 2n IEEE divisions, the z/y update) times the sweeps bounds a small
// batch, and the instructions a sweep issues bound a large one.  Two
// launch shapes run the same body (the same operations in the same order),
// chosen by group_width from B, n and m:
//  - a group of G lanes a problem (G a power of two from 8 to 32, from m).
//    Lane r owns rows r, r+G, r+2G, ...; its rows of A, l, u, z and y sit
//    in registers (R slots, rows past m hold zeros and stay zero).  x, the
//    packed factor L, A'A, P and q are registers in every lane, and the
//    n x n factor, both substitutions, the x update and the rho update run
//    alike in every lane (the same operations, so the same values).  A sum
//    over rows gathers the lanes' terms by shuffle, m dependent
//    shuffle+add pairs.  A lane's chain is short (one row's z/y update),
//    so a small batch runs fast; but a group of 16 for 10 rows idles 6
//    lanes, and every lane repeats the n x n work, so at n=2, m=10 a
//    problem's sweep costs a warp about 108 issue slots (2^19 problems:
//    21.7 ms a launch on an H100);
//  - one lane a problem (G = 1), at n = 2 or 3 and m from 7 (the shapes
//    measured against the groups), where the state fits in a thread's
//    registers: R row slots (m rounded up to even) of n + 4 floats (a row
//    of A, l, u, z, y), P, L and A'A, at most LANE_WORDS.  Every sum over rows
//    is a loop in the thread, with no shuffle; only the last slot can be
//    empty (m odd), and only it is tested, so a slot past m costs no
//    arithmetic.  A warp holds 32 problems, a 128-thread block 128.  At
//    n=2, m=10 the sweep loop is 394 SASS instructions a warp (188
//    operations under -fmad=false, 14 IEEE divisions, each a reciprocal,
//    its refinement, a range check and a branch around the slow path),
//    about 12 issue slots a problem: 2^19 problems x 400 sweeps over 132
//    SMs x 4 schedulers at 1.98 GHz is an issue floor of 2.5 ms (6.4 ms
//    a launch, 94 registers, 5 blocks an SM).  But one thread's sweep is
//    the whole chain, about 2,500 cycles at m=10, 2-3x a group lane's: the
//    shape wins only where the card holds enough warps to interleave.
//    It is taken where the group shape would run LANE_MIN_LANES lanes or
//    more (B >= 16,384 at G = 16, B >= 32,768 at G = 8), about where the
//    two cross on an H100 (12,288-16,384 problems at m = 10-12,
//    24,576-32,768 at m = 7);
//  - past MAX_REG_ROWS rows a lane of a group (m > 256, which no caller in
//    the repo reaches) the same kernel keeps a lane's rows in global memory
//    instead: A, l and u read in place, z in the z scratch and y in the y
//    output, each lane touching only its own rows, so they stay in its
//    SM's L1.  Global and not shared memory, because it has no size limit:
//    every m the wrapper accepts runs in the kernel.
// The first port also ran one problem a thread, and was slow for two
// reasons the one-lane shape does not have: A, l, u, z and y lived in
// global memory, so every sweep waited on L1/L2 round trips, and at the
// B=4096 it ran, 32-thread blocks left one warp an SM, with nothing to
// interleave.  Here the rows are registers, and the one-lane shape is
// taken only at batches that give every scheduler warps to interleave.
// No tensor cores, TMA or cp.async: 136 bytes in a problem leave no copy
// to overlap, and the sums are length-m dot products with n <= 8, which
// TF32 (A rounded to 10 mantissa bits) would take outside the 1e-3
// envelope.
//
// Numerics: compiled without --use_fast_math and with -fmad=false, so every
// operation rounds as the plain PyTorch version
// (solvers/qp_kernel.py::_sweep_plain) rounds it, and every sum runs in the
// same order.  A sum over rows (A'A, the right-hand side, the dual
// residual) adds the rows' terms in index order, from row 0: in one lane
// by a loop, in a group by every lane reading the terms by shuffle; so
// each lane holds the plain version's sum bit for bit.  Ax sums over
// columns in order within a lane; the Cholesky and its substitutions are
// solvers/chol.py's order.  The maximum over rows (the primal residual) is
// a loop in one lane and a shuffle butterfly in a group: fmaxf is exact in
// any order.  fminf/fmaxf give torch.clamp's result on the +-inf and -1e6
// bounds.  IEEE division and sqrtf, as the plain version.
//
// Layout: the (B, ...) tensors as the wrapper receives them from
// qp.equilibrate, row-major: P (B, n, n), q (B, n), A (B, m, n), l/u/y/z
// (B, m), x (B, n); a group's lanes read neighbouring rows of one problem.
// The wrapper copies nothing.  (The first port took a (rows, B) layout;
// the C entry point keeps its name and arguments, and z is now scratch,
// used only past MAX_REG_ROWS rows a lane.)  The groups of a warp whose
// problem lies past B solve a copy of the last problem and store nothing,
// so every shuffle has all 32 lanes; whole idle warps return, and so does
// a lane of the one-lane shape past B, which has no shuffle to feed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_STAGES = 8;
constexpr int MAX_N = 8;
constexpr int THREADS = 128;      // threads per block
constexpr int MIN_GROUP = 8;      // lanes per problem for m <= 8 in a group
constexpr int MAX_GROUP = 32;     // lanes per problem from m = 17 on: a whole warp
constexpr int MAX_REG_ROWS = 8;   // rows a lane of a group holds in registers
constexpr int LANE_WORDS = 92;    // registers a problem's state takes in one lane, at most
constexpr int LANE_MIN_N = 2;     // the one-lane shape's variables: measured at n = 2 and 3
constexpr int LANE_MAX_N = 3;
constexpr int LANE_MIN_ROWS = 7;  // and its rows: measured from m = 7
constexpr int LANE_MIN_LANES = 262144;  // a group's lanes (B x G) from which one lane wins
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

// Row slots of the one-lane shape: m rounded up to even.
constexpr int lane_rows(int m) { return m + (m & 1); }

// Registers a problem's state takes in one lane: its row slots (a row of
// A, l, u, z and y: n + 4 floats each), P, and the factor and A'A
// (n (n + 1) / 2 floats each).
constexpr int lane_words(int n, int slots) { return slots * (n + 4) + n * n + n * (n + 1); }

// Lanes per problem in a group: the least power of two >= m within
// [MIN_GROUP, MAX_GROUP].
constexpr int group_lanes(int m) {
  int g = MIN_GROUP;
  while (g < MAX_GROUP && g < m) g *= 2;
  return g;
}

// Whether the one-lane shape is instantiated for n variables and m rows:
// n from LANE_MIN_N to LANE_MAX_N, m from LANE_MIN_ROWS, and the state in
// LANE_WORDS registers (m <= 12 at n=2, m <= 10 at n=3; at most 128
// registers, no spill).  Those are the shapes timed against the groups on
// an H100; the rest keep the groups.
constexpr bool lane_fits(int n, int m) {
  return n >= LANE_MIN_N && n <= LANE_MAX_N && m >= LANE_MIN_ROWS &&
         lane_words(n, lane_rows(m)) <= LANE_WORDS;
}

// Lanes per problem: 1 where the one-lane shape fits and the group shape
// would run LANE_MIN_LANES lanes or more (B x G: 8,192 warps, over 60 an
// SM, so that its time grows with B, while one lane a problem gives each
// of the 132 SMs' schedulers a warp or more); else the group's width.  On
// an H100 the groups win below that batch: one lane a problem leaves most
// schedulers one warp, whose sweep is one thread's whole chain.
constexpr int group_width(int B, int n, int m) {
  const int g = group_lanes(m);
  return lane_fits(n, m) && B >= LANE_MIN_LANES / g ? 1 : g;
}

// Row slots a lane holds in registers: in one lane, m rounded up to even;
// in a group, the least power of two >= m / G (rounded up), or 0 past
// MAX_REG_ROWS (the rows stay in global memory).
constexpr int reg_rows(int B, int n, int m) {
  const int g = group_width(B, n, m);
  if (g == 1) return lane_rows(m);
  int r = 1;
  while (r * g < m) r *= 2;
  return r <= MAX_REG_ROWS ? r : 0;
}

// A lane's rows j = k G + lane, k < R, in registers.  In a group, rows
// past m hold zeros, which the sweep keeps at zero (clip to [0, 0]); in
// one lane, the sweep skips the slot past m.
template <int NV, int G, int R>
struct Rows {
  float a_[R][NV], z_[R], y_[R], lo_[R], hi_[R];
  int lane, m;

  __device__ Rows(const float* A, const float* lo, const float* hi, float*, float*, int lane_,
                  int m_)
      : lane(lane_), m(m_) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = k * G + lane;
      const bool in = valid(k);
#pragma unroll
      for (int i = 0; i < NV; ++i) a_[k][i] = in ? A[j * NV + i] : 0.0f;
      lo_[k] = in ? lo[j] : 0.0f;
      hi_[k] = in ? hi[j] : 0.0f;
      z_[k] = 0.0f;
      y_[k] = 0.0f;
    }
  }
  __device__ static constexpr int count(int) { return R; }
  // Whether slot k holds a row.  In one lane every slot but the last does
  // (R is m rounded up to even), so only the last is tested.
  __device__ bool valid(int k) const { return (G == 1 && k + 1 < R) || k * G + lane < m; }
  // Whether some lane of the group holds a row in slot k.
  __device__ bool any(int k) const { return G == 1 ? valid(k) : k * G < m; }
  // Whether the sweep updates slot k: in a group every slot, since one
  // past m is zeros and stays zero, and its terms never enter a sum over
  // rows; in one lane the rows alone.
  __device__ bool runs(int k) const { return G > 1 || valid(k); }
  __device__ float a(int k, int i) const { return a_[k][i]; }
  __device__ float lo(int k) const { return lo_[k]; }
  __device__ float hi(int k) const { return hi_[k]; }
  __device__ float z(int k) const { return z_[k]; }
  __device__ float y(int k) const { return y_[k]; }
  __device__ void set(int k, float z, float y) { z_[k] = z; y_[k] = y; }
  __device__ void store_y(float* y) const {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (valid(k)) y[k * G + lane] = y_[k];
  }
};

// R = 0: a lane's rows in global memory, read where the inputs lie; z in
// the scratch and y in the output.  Only whole warps (G = MAX_GROUP) take
// this path, so no copy of a problem ever writes another's rows.
template <int NV, int G>
struct Rows<NV, G, 0> {
  const float *A_, *lo_, *hi_;
  float *z_, *y_;
  int lane, m;

  __device__ Rows(const float* A, const float* lo, const float* hi, float* z, float* y,
                  int lane_, int m_)
      : A_(A), lo_(lo), hi_(hi), z_(z), y_(y), lane(lane_), m(m_) {
    for (int j = lane; j < m; j += G) {
      z_[j] = 0.0f;
      y_[j] = 0.0f;
    }
  }
  __device__ static int count(int m) { return (m + G - 1) / G; }
  __device__ bool valid(int k) const { return k * G + lane < m; }
  __device__ bool any(int k) const { return k * G < m; }
  __device__ bool runs(int k) const { return valid(k); }
  __device__ float a(int k, int i) const { return valid(k) ? A_[(k * G + lane) * NV + i] : 0.0f; }
  __device__ float lo(int k) const { return lo_[k * G + lane]; }
  __device__ float hi(int k) const { return hi_[k * G + lane]; }
  __device__ float z(int k) const { return valid(k) ? z_[k * G + lane] : 0.0f; }
  __device__ float y(int k) const { return valid(k) ? y_[k * G + lane] : 0.0f; }
  __device__ void set(int k, float z, float y) {
    z_[k * G + lane] = z;
    y_[k * G + lane] = y;
  }
  __device__ void store_y(float*) const {}  // y is the output throughout
};

// acc[t] = acc[t] + p_r[t] for the lanes r = 0, 1, ... of the group in
// order, the first count of them (all G if count >= G), where lane r holds p_r.
template <int G, int T>
__device__ __forceinline__ void add_lanes(float (&acc)[T], const float (&p)[T], int count) {
  if constexpr (G == 1) {
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = acc[t] + p[t];
  } else if constexpr (G <= MIN_GROUP) {
    // Every shuffle runs, outside any branch, so they go out back to back;
    // only the adds of lanes past count are skipped (a select).
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float v = __shfl_sync(FULL, p[t], r, G);
        if (r < count) acc[t] = acc[t] + v;
      }
  } else {
    const int lanes = count < G ? count : G;
#pragma unroll 1
    for (int r = 0; r < lanes; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = acc[t] + __shfl_sync(FULL, p[t], r, G);
  }
}

// acc[t] = acc[t] + term_j[t] over the rows j = 0, 1, ..., m - 1 in order,
// in every lane of the group; the lane that owns row j forms term_j by
// make(k, term) for its slot k.
template <int G, int T, class R, class Make>
__device__ __forceinline__ void row_sum(const R& rows, int m, float (&acc)[T], Make make) {
#pragma unroll
  for (int k = 0; k < R::count(m); ++k) {
    if (!rows.any(k)) break;
    float p[T];
    make(k, p);
    add_lanes<G>(acc, p, m - k * G);
  }
}

template <int NV, int G, int R>
__global__ void __launch_bounds__(THREADS)
qp_admm_kernel(const float* __restrict__ P, const float* __restrict__ q,
               const float* __restrict__ A, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ x_out,
               float* __restrict__ z, float* __restrict__ y, int B, int m,
               int per_stage, float rho0, float sigma, float alpha) {
  static_assert(32 % G == 0 && THREADS % 32 == 0, "groups tile whole warps");
  static_assert(R > 0 || G == 32, "rows in global memory only for whole warps");
  constexpr int PER_BLOCK = THREADS / G;
  const int lane = threadIdx.x % G;
  const int first = blockIdx.x * PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / G) >= B) return;  // the whole warp is idle
  const int g = threadIdx.x / G;
  const bool valid = first + g < B;
  if (G == 1 && !valid) return;  // one lane a problem: no shuffle to feed
  const size_t b = valid ? first + g : B - 1;

  float Pm[NV][NV], qv[NV], x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qv[i] = q[b * NV + i];
    x[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) Pm[i][j] = P[(b * NV + i) * NV + j];
  }
  Rows<NV, G, R> rows(A + b * m * NV, lo + b * m, hi + b * m, z + b * m, y + b * m, lane, m);

  // A'A once, summed over rows in order.  Starting from -0 adds row 0's
  // product exactly (-0 + v == v for every v), as the plain version takes it.
  float AtA[tri(NV, 0)];
#pragma unroll
  for (int t = 0; t < tri(NV, 0); ++t) AtA[t] = -0.0f;
  row_sum<G>(rows, m, AtA, [&](int k, float (&p)[tri(NV, 0)]) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) p[tri(i, j)] = rows.a(k, i) * rows.a(k, j);
  });

  const float oma = 1.0f - alpha;
  float rho = rho0;
#pragma unroll 1
  for (int stage = 0; stage < N_STAGES; ++stage) {
    // K = P + rho A'A + sigma I, factored in place into the packed L.
    float L[tri(NV, 0)];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = Pm[i][j] + rho * AtA[tri(i, j)];
        s = s + (i == j ? sigma : 0.0f);
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
        L[tri(i, j)] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / L[tri(j, j)];
      }
    }

#pragma unroll 1
    for (int it = 0; it < per_stage; ++it) {
      // rhs = sigma x - q + A'(rho z - y)
      float rhs[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) rhs[i] = sigma * x[i] - qv[i];
      row_sum<G>(rows, m, rhs, [&](int k, float (&p)[NV]) {
        const float w = rho * rows.z(k) - rows.y(k);
#pragma unroll
        for (int i = 0; i < NV; ++i) p[i] = rows.a(k, i) * w;
      });
      // L L' xt = rhs
      float wv[NV], xt[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float s = rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * wv[k];
        wv[i] = s / L[tri(i, i)];
      }
#pragma unroll
      for (int i = NV - 1; i >= 0; --i) {
        float s = wv[i];
#pragma unroll
        for (int k = i + 1; k < NV; ++k) s = s - L[tri(k, i)] * xt[k];
        xt[i] = s / L[tri(i, i)];
      }
      // z and y of this lane's rows, with over-relaxation and the clip.
#pragma unroll
      for (int k = 0; k < rows.count(m); ++k) {
        if (!rows.runs(k)) continue;
        float zt = rows.a(k, 0) * xt[0];
#pragma unroll
        for (int i = 1; i < NV; ++i) zt = zt + rows.a(k, i) * xt[i];
        const float zj = rows.z(k);
        const float yj = rows.y(k);
        const float z_hat = alpha * zt + oma * zj;
        const float z_new = fminf(fmaxf(z_hat + yj / rho, rows.lo(k)), rows.hi(k));
        rows.set(k, z_new, yj + rho * (z_hat - z_new));
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) x[i] = alpha * xt[i] + oma * x[i];
    }

    // Adaptive rho from the primal/dual residual ratio.
    float dual[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = qv[i];
#pragma unroll
      for (int j = 0; j < NV; ++j) s = s + Pm[i][j] * x[j];
      dual[i] = s;
    }
    row_sum<G>(rows, m, dual, [&](int k, float (&p)[NV]) {
      const float yk = rows.y(k);
#pragma unroll
      for (int i = 0; i < NV; ++i) p[i] = rows.a(k, i) * yk;
    });
    float r_prim = 0.0f;
#pragma unroll
    for (int k = 0; k < rows.count(m); ++k) {
      if (!rows.runs(k)) continue;
      float ax = rows.a(k, 0) * x[0];
#pragma unroll
      for (int i = 1; i < NV; ++i) ax = ax + rows.a(k, i) * x[i];
      r_prim = fmaxf(r_prim, fabsf(ax - rows.z(k)));
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      r_prim = fmaxf(r_prim, __shfl_xor_sync(FULL, r_prim, off, G));
    float r_dual = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) r_dual = fmaxf(r_dual, fabsf(dual[i]));
    const float ratio = sqrtf(fmaxf(r_prim, 1e-12f) / fmaxf(r_dual, 1e-12f));
    rho = fminf(fmaxf(rho * fminf(fmaxf(ratio, 0.1f), 10.0f), 1e-4f), 1e5f);
  }

  if (!valid) return;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) x_out[b * NV + i] = x[i];
  }
  rows.store_y(y + b * m);
}

template <int NV, int G, int R>
bool launch(const void* P, const void* q, const void* A, const void* lo, const void* hi,
            void* x, void* z, void* y, int B, int m, int per_stage, float rho0, float sigma,
            float alpha, cudaStream_t stream) {
  constexpr int per_block = THREADS / G;
  const int blocks = (B + per_block - 1) / per_block;
  qp_admm_kernel<NV, G, R><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(P), static_cast<const float*>(q),
      static_cast<const float*>(A), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(x), static_cast<float*>(z),
      static_cast<float*>(y), B, m, per_stage, rho0, sigma, alpha);
  return true;
}

// The one-lane instantiation with r row slots, r = S, S + 2, ... while
// lane_fits; false, and nothing launched, for an r that none has.
template <int NV, int S>
bool launch_lane(const void* P, const void* q, const void* A, const void* lo, const void* hi,
                 void* x, void* z, void* y, int B, int m, int per_stage, float rho0,
                 float sigma, float alpha, cudaStream_t s, int r) {
  if constexpr (lane_fits(NV, S)) {
    if (r == S)
      return launch<NV, 1, S>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s);
    return launch_lane<NV, S + 2>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha,
                                  s, r);
  }
  return false;
}

// One instantiation per launch shape that group_width and reg_rows give;
// false if the shape has none (group_width and the instantiations disagree).
template <int NV>
bool launch_shape(const void* P, const void* q, const void* A, const void* lo, const void* hi,
                  void* x, void* z, void* y, int B, int m, int per_stage, float rho0,
                  float sigma, float alpha, cudaStream_t s) {
  const int g = group_width(B, NV, m), r = reg_rows(B, NV, m);
#define QP_LAUNCH(G, R) launch<NV, G, R>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, \
                                         sigma, alpha, s)
  if (g == 1)
    return launch_lane<NV, lane_rows(LANE_MIN_ROWS)>(P, q, A, lo, hi, x, z, y, B, m, per_stage,
                                                     rho0, sigma, alpha, s, r);
  if (g == 8) return QP_LAUNCH(8, 1);
  if (g == 16) return QP_LAUNCH(16, 1);
  if (r == 1) return QP_LAUNCH(32, 1);
  if (r == 2) return QP_LAUNCH(32, 2);
  if (r == 4) return QP_LAUNCH(32, 4);
  if (r == 8) return QP_LAUNCH(32, 8);
  return QP_LAUNCH(32, 0);
#undef QP_LAUNCH
}

}  // namespace

// The launch shape for B problems of n variables and m rows: lanes per
// problem, and the row slots a lane holds in registers (0: its rows stay
// in global memory).
extern "C" void qp_admm_shape(int B, int n, int m, int* group, int* rows) {
  *group = group_width(B, n, m);
  *rows = reg_rows(B, n, m);
}

extern "C" int qp_admm_launch(const void* P, const void* q, const void* A, const void* lo,
                              const void* hi, void* x, void* z, void* y, int B, int n, int m,
                              int per_stage, float rho0, float sigma, float alpha,
                              void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || per_stage < 1 || n < 1 || n > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched;
#define QP_N(NV) \
  launched = launch_shape<NV>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s)
  switch (n) {
    case 1: QP_N(1); break;
    case 2: QP_N(2); break;
    case 3: QP_N(3); break;
    case 4: QP_N(4); break;
    case 5: QP_N(5); break;
    case 6: QP_N(6); break;
    case 7: QP_N(7); break;
    default: QP_N(8); break;
  }
#undef QP_N
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
