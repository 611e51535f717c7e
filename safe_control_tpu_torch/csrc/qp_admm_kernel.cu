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
// 0.013 ms), but every sweep depends on the last one, so the floor is one
// sweep's dependent chain (the right-hand side summed over m rows, two
// triangular solves with 2n IEEE divisions, the z/y update) times 1600.
// The first port ran one problem per thread in 32-thread blocks, with A,
// l, u, z and y in global memory: every sweep waited on L1/L2 round trips,
// with one warp an SM at B=4096.  Here:
//  - a group of G lanes solves one problem (G a power of two from 8 to 32,
//    picked at launch from m: group_width), and lane r owns rows r, r+G,
//    r+2G, ...; its rows of A, l, u, z and y sit in registers (R slots, a
//    template parameter, rows past m hold zeros and stay zero);
//  - x, the packed factor L, A'A, P and q are registers in every lane, and
//    the n x n factor, both substitutions, the x update and the rho update
//    run alike in every lane (the same operations, so the same values);
//  - 128-thread blocks of 128 / G problems: at m=7, G=8, B=4096 is 1,024
//    warps, about 8 an SM, which interleave their chains;
//  - past MAX_REG_ROWS rows a lane (m > 256, which no caller in the repo
//    reaches) the same kernel keeps a lane's rows in global memory instead:
//    A, l and u read in place, z in the z scratch and y in the y output,
//    each lane touching only its own rows, so they stay in its SM's L1.
//    Global and not shared memory, because it has no size limit: every m
//    the wrapper accepts runs in the kernel.
// No tensor cores, TMA or cp.async: 136 bytes in a problem leave no copy
// to overlap, and the sums are length-m dot products with n <= 8, which
// TF32 (A rounded to 10 mantissa bits) would take outside the 1e-3
// envelope.  What the chain lacks is registers in place of memory round
// trips, and warps to interleave.
//
// Numerics: compiled without --use_fast_math and with -fmad=false, so every
// operation rounds as the plain PyTorch version
// (solvers/qp_kernel.py::_sweep_plain) rounds it, and every sum runs in the
// same order.  A sum over rows (A'A, the right-hand side, the dual
// residual) is formed so: the lane that owns row j forms its term, and
// every lane of the group reads the terms by shuffle and adds them in
// index order, from row 0; so each lane holds the plain version's sum bit
// for bit.  Ax sums over columns in order within a lane; the Cholesky and
// its substitutions are solvers/chol.py's order.  The maximum over rows
// (the primal residual) is a shuffle butterfly: fmaxf is exact in any
// order.  fminf/fmaxf give torch.clamp's result on the +-inf and -1e6
// bounds.  IEEE division and sqrtf, as the plain version.
//
// Layout: the (B, ...) tensors as the wrapper receives them from
// qp.equilibrate, row-major: P (B, n, n), q (B, n), A (B, m, n), l/u/y/z
// (B, m), x (B, n); a group's lanes read neighbouring rows of one problem.
// The wrapper copies nothing.  (The first port took a (rows, B) layout;
// the C entry point keeps its name and arguments, and z is now scratch,
// used only past MAX_REG_ROWS rows a lane.)  The groups of a warp whose
// problem lies past B solve a copy of the last problem and store nothing,
// so every shuffle has all 32 lanes; whole idle warps return.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_STAGES = 8;
constexpr int MAX_N = 8;
constexpr int THREADS = 128;      // threads per block
constexpr int MIN_GROUP = 8;      // lanes per problem for m <= 8
constexpr int MAX_GROUP = 32;     // lanes per problem from m = 17 on: a whole warp
constexpr int MAX_REG_ROWS = 8;   // rows a lane holds in registers
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

// Lanes per problem: the least power of two >= m within [MIN_GROUP, MAX_GROUP].
constexpr int group_width(int m) {
  int g = MIN_GROUP;
  while (g < MAX_GROUP && g < m) g *= 2;
  return g;
}

// Row slots a lane holds in registers: the least power of two >= m / G
// (rounded up), or 0 past MAX_REG_ROWS (the rows stay in global memory).
constexpr int reg_rows(int m) {
  const int g = group_width(m);
  int r = 1;
  while (r * g < m) r *= 2;
  return r <= MAX_REG_ROWS ? r : 0;
}

// A lane's rows j = k G + lane, k < R, in registers.  Rows past m hold
// zeros, which the sweep keeps at zero (clip to [0, 0]).
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
      const bool in = j < m;
#pragma unroll
      for (int i = 0; i < NV; ++i) a_[k][i] = in ? A[j * NV + i] : 0.0f;
      lo_[k] = in ? lo[j] : 0.0f;
      hi_[k] = in ? hi[j] : 0.0f;
      z_[k] = 0.0f;
      y_[k] = 0.0f;
    }
  }
  __device__ static constexpr int count(int) { return R; }
  __device__ bool valid(int k) const { return k * G + lane < m; }
  // Whether the sweep updates slot k: every slot, since one past m is
  // zeros and stays zero, and its terms never enter a sum over rows.
  __device__ static constexpr bool runs(int) { return true; }
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
  if constexpr (G <= MIN_GROUP) {
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
    if (k * G >= m) break;
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
void launch(const void* P, const void* q, const void* A, const void* lo, const void* hi,
            void* x, void* z, void* y, int B, int m, int per_stage, float rho0, float sigma,
            float alpha, cudaStream_t stream) {
  constexpr int per_block = THREADS / G;
  const int blocks = (B + per_block - 1) / per_block;
  qp_admm_kernel<NV, G, R><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(P), static_cast<const float*>(q),
      static_cast<const float*>(A), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(x), static_cast<float*>(z),
      static_cast<float*>(y), B, m, per_stage, rho0, sigma, alpha);
}

// One instantiation per launch shape that group_width and reg_rows give.
template <int NV>
void launch_shape(const void* P, const void* q, const void* A, const void* lo, const void* hi,
                  void* x, void* z, void* y, int B, int m, int per_stage, float rho0,
                  float sigma, float alpha, cudaStream_t s) {
  const int g = group_width(m), r = reg_rows(m);
#define QP_LAUNCH(G, R) launch<NV, G, R>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, \
                                         sigma, alpha, s)
  if (g == 8) QP_LAUNCH(8, 1);
  else if (g == 16) QP_LAUNCH(16, 1);
  else if (r == 1) QP_LAUNCH(32, 1);
  else if (r == 2) QP_LAUNCH(32, 2);
  else if (r == 4) QP_LAUNCH(32, 4);
  else if (r == 8) QP_LAUNCH(32, 8);
  else QP_LAUNCH(32, 0);
#undef QP_LAUNCH
}

}  // namespace

// The launch shape for m rows: lanes per problem, and the row slots a lane
// holds in registers (0: its rows stay in global memory).
extern "C" void qp_admm_shape(int m, int* group, int* rows) {
  *group = group_width(m);
  *rows = reg_rows(m);
}

extern "C" int qp_admm_launch(const void* P, const void* q, const void* A, const void* lo,
                              const void* hi, void* x, void* z, void* y, int B, int n, int m,
                              int per_stage, float rho0, float sigma, float alpha,
                              void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || per_stage < 1 || n < 1 || n > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QP_N(NV) launch_shape<NV>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s)
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
  return static_cast<int>(cudaGetLastError());
}
