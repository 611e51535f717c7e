// Staged OSQP-style ADMM on batched, equilibrated dense QPs
//     minimize 0.5 x'Px + q'x   subject to   l <= Ax <= u.
//
// Replaces safe_control_tpu/solvers/qp_kernel.py::_admm_kernel (the Pallas
// TPU kernel).  One thread solves one problem: A'A once, then N_STAGES
// stages, each refactoring K = P + sigma I + rho A'A by an n x n Cholesky
// and running per_stage over-relaxed x/z/y sweeps with a clip projection,
// then a per-problem adaptive rho from the primal/dual residual ratio.
// Equilibration, the active-set polish, unscaling and the residuals run in
// PyTorch around the launch (solvers/qp_kernel.py), as the JAX package runs
// them around its kernel.
//
// What bounds it: the latency of the per-iteration reads and writes of A,
// z and y (2 m n + 4 m floats a sweep), not DRAM bandwidth and not FP32
// issue.  n is a template parameter, so x, the packed factor L, the packed
// A'A, P and q live in registers.  A, l, u, z and y stay in global memory in
// a (rows, B) layout, so a warp's 32 loads of one row coalesce; at m = 7
// and B = 4096 that working set is about 0.5 MB and stays in L2.  32-thread
// blocks put B = 4096 problems on 128 blocks for the 132 SMs.  A warp per
// problem, shared-memory staging or register-resident z/y for small m are
// the levers for a later change.
//
// Numerics: compiled without --use_fast_math and with -fmad=false, so every
// operation rounds as the plain PyTorch version
// (solvers/qp_kernel.py::_sweep_plain) rounds it, and every sum runs in the
// same order: A'A over rows, the right-hand side over rows, Ax over
// columns, the Cholesky and its substitutions as solvers/chol.py.
// fminf/fmaxf give torch.clamp's result on the +-inf and -1e6 bounds.
//
// Layout: P (n*n, B), q (n, B), A (m*n, B) with row j*n+i = A[j][i],
// l/u/z/y (m, B), x (n, B).  No padding: threads past B return.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_STAGES = 8;
constexpr int MAX_N = 8;
constexpr int THREADS = 32;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

template <int NV>
__global__ void __launch_bounds__(THREADS)
qp_admm_kernel(const float* __restrict__ P, const float* __restrict__ q,
               const float* __restrict__ A, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ x_out,
               float* __restrict__ z, float* __restrict__ y, int B, int m,
               int per_stage, float rho0, float sigma, float alpha) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const float* Ab = A + b;
  const float* lob = lo + b;
  const float* hib = hi + b;
  float* zb = z + b;
  float* yb = y + b;

  float Pm[NV][NV], qv[NV], x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qv[i] = q[i * sB + b];
    x[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) Pm[i][j] = P[(i * NV + j) * sB + b];
  }

  // A'A once, summed over rows in order (row 0 first).
  float AtA[tri(NV, 0)];
  {
    float a[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] = Ab[i * sB];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) AtA[tri(i, j)] = a[i] * a[j];
    for (int k = 1; k < m; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) a[i] = Ab[(k * NV + i) * sB];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) AtA[tri(i, j)] = AtA[tri(i, j)] + a[i] * a[j];
    }
  }
  for (int j = 0; j < m; ++j) {
    zb[j * sB] = 0.0f;
    yb[j * sB] = 0.0f;
  }

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
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float w = rho * zb[j * sB] - yb[j * sB];
#pragma unroll
        for (int i = 0; i < NV; ++i) rhs[i] = rhs[i] + Ab[(j * NV + i) * sB] * w;
      }
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
      // z and y with over-relaxation and the clip projection.
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float* aj = Ab + static_cast<size_t>(j) * NV * sB;
        float zt = aj[0] * xt[0];
#pragma unroll
        for (int i = 1; i < NV; ++i) zt = zt + aj[i * sB] * xt[i];
        const float zj = zb[j * sB];
        const float yj = yb[j * sB];
        const float z_hat = alpha * zt + oma * zj;
        const float z_new = fminf(fmaxf(z_hat + yj / rho, lob[j * sB]), hib[j * sB]);
        yb[j * sB] = yj + rho * (z_hat - z_new);
        zb[j * sB] = z_new;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) x[i] = alpha * xt[i] + oma * x[i];
    }

    // Adaptive rho from the primal/dual residual ratio.
    float r_prim = 0.0f;
    float dual[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = qv[i];
#pragma unroll
      for (int j = 0; j < NV; ++j) s = s + Pm[i][j] * x[j];
      dual[i] = s;
    }
    for (int j = 0; j < m; ++j) {
      const float* aj = Ab + static_cast<size_t>(j) * NV * sB;
      float ax = aj[0] * x[0];
#pragma unroll
      for (int i = 1; i < NV; ++i) ax = ax + aj[i * sB] * x[i];
      r_prim = fmaxf(r_prim, fabsf(ax - zb[j * sB]));
      const float yj = yb[j * sB];
#pragma unroll
      for (int i = 0; i < NV; ++i) dual[i] = dual[i] + aj[i * sB] * yj;
    }
    float r_dual = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) r_dual = fmaxf(r_dual, fabsf(dual[i]));
    const float ratio = sqrtf(fmaxf(r_prim, 1e-12f) / fmaxf(r_dual, 1e-12f));
    rho = fminf(fmaxf(rho * fminf(fmaxf(ratio, 0.1f), 10.0f), 1e-4f), 1e5f);
  }

#pragma unroll
  for (int i = 0; i < NV; ++i) x_out[i * sB + b] = x[i];
}

template <int NV>
void launch(const void* P, const void* q, const void* A, const void* lo, const void* hi,
            void* x, void* z, void* y, int B, int m, int per_stage, float rho0, float sigma,
            float alpha, cudaStream_t stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  qp_admm_kernel<NV><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(P), static_cast<const float*>(q),
      static_cast<const float*>(A), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(x), static_cast<float*>(z),
      static_cast<float*>(y), B, m, per_stage, rho0, sigma, alpha);
}

}  // namespace

extern "C" int qp_admm_launch(const void* P, const void* q, const void* A, const void* lo,
                              const void* hi, void* x, void* z, void* y, int B, int n, int m,
                              int per_stage, float rho0, float sigma, float alpha,
                              void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || per_stage < 1 || n < 1 || n > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 2: launch<2>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 3: launch<3>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 4: launch<4>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 5: launch<5>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 6: launch<6>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    case 7: launch<7>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
    default: launch<8>(P, q, A, lo, hi, x, z, y, B, m, per_stage, rho0, sigma, alpha, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
