// The finish of the batched QP solve, after the ADMM sweep of
// qp_admm_kernel.cu, for problems
//     minimize 0.5 x'Px + q'x   subject to   l <= Ax <= u
// in one launch: the active-set polish, the keep-or-reject test of the
// polished point, the unscaling, and the row-scaled primal residual and the
// dual residual.  What it computes is solvers/qp.py::_finish and _polish:
//  - rows active at the ADMM iterate (x, y), in scaled units: a finite lower
//    bound with Ax - l < act_tol or y < -act_tol, a finite upper bound with
//    u - Ax < act_tol or y > act_tol; each active row's bound is u where the
//    upper test holds, else l;
//  - the KKT system [P + reg I, Aa'; Aa, -reg I] [x; nu] = [-q; bound] over
//    the active rows Aa, solved by LU with partial pivoting;
//  - the polished point (x_p, nu on the active rows, 0 elsewhere) is kept
//    unless the system is singular, x_p is not finite, or its violation
//    max(0, l - A x_p, A x_p - u) exceeds the iterate's by more than 1e-7;
//  - x = e x, y = d y; the primal residual max(0, (l - Ax) d, (Ax - u) d)
//    over the finite bounds of the original rows, and the dual residual
//    max |Px + q + A'y|.
//
// It replaces no TPU kernel: the JAX package runs this finish under XLA
// around its Pallas kernel (safe_control_tpu/solvers/qp.py::_finish), and
// so did the port, as some forty PyTorch operations around a batched LU
// (torch.linalg.solve_ex).  It was added because those operations took a
// quarter of the 2^19-scenario DPCBF sweep's step on an H100: 5.2 ms, with
// the dense (B, n + m, n + m) KKT matrix written to device memory and read
// back, for work whose bound is the bytes of one pass over the problem.
//
// What bounds it on the H100: bytes.  At n=2, m=10 a problem is 116 floats
// in (P, q, A, l, u, their scaled copies, d, e, x and y) and 14 out (x, y
// and the two residuals), 520 B: 273 MB at 2^19 problems, 0.08 ms at
// 3.35 TB/s; the elimination is at most about (n + m)^3 / 3 = 600
// multiply-adds a problem.  So the design keeps the working data off
// device memory and does the solve only where it is needed:
//  - one thread a problem, 32 a block.  Where a block's problems and their
//    KKT systems fit in 48 KB of shared memory (n=2 up to m=12, n=3 up to
//    m=10: the CBF-QP paths' shapes), the block copies its 32 problems'
//    inputs into shared memory first, each array's slab as one contiguous
//    run (cp.async, coalesced, all in flight at once), and each thread
//    builds its KKT system there, interleaved by thread (element (r, c) of
//    thread t at word (r W + c) 32 + t, so a warp's 32 accesses fall in
//    32 banks).  No KKT matrix is written to device memory;
//  - past that size (n=2 from m=13, n=3 from m=11: Manipulator2D's 118
//    rows, random QPs of 153 and 300), one block of 128 threads a problem.
//    There one thread's serial elimination of up to n + m unknowns would
//    run 9-66x slower than the batched LU it replaces (measured), so the
//    block shares it: warp 0 takes the passes over the rows, 32 at a time
//    (active rows ranked by a ballot), the pivot search and the back
//    substitution; the four warps take the elimination's row updates, a
//    warp a row and a lane a column, so that a warp's accesses are
//    consecutive words.  The system, (n + k) x (n + k + 1) row-major, is
//    in 16 KB of shared memory where it fits (n + k <= 63), else in the
//    block's slice of a workspace the wrapper allocates, at most
//    WORKSPACE_FLOATS, each block then taking problems b, b + blocks, ...;
//  - the system has only the n + k unknowns of x and the k active rows.
//    The full (n + m) masked system, the one solvers/qp.py builds, holds
//    each inactive row as the equation -(1 + reg) nu_i = 0: its one nonzero
//    is its diagonal, and its column is zero elsewhere.  Partial pivoting
//    never picks that row for another column (|0| > best never holds), and
//    every update it takes or gives is an exact zero; so the (n + k) system
//    is the same arithmetic with that zero work left out, and n + k is
//    what the elimination's loops run to.  In the sweep k is mostly 0-3.
//
// The LU rounds as the batched LU that torch.linalg.solve_ex runs on an
// H100 (cuBLAS's getrf and getrs; measured bit for bit on 262,144 KKT
// systems of the DPCBF sweep and 65,536 random 12 x 12 ones): right-looking;
// the pivot is the first row of the largest |a| in its column, so ties go
// to the lower row; a zero pivot means a singular system; the multipliers
// are a times the pivot's reciprocal, and every update, the forward
// substitution's included, is one fused multiply-add; the back
// substitution takes each row's terms from the last column down, in fused
// multiply-adds, and divides by the diagonal.  Where the active rows
// outnumber the variables (an infeasible or degenerate active set) the
// system is singular but for reg, and its solution is the rounding's; so
// rounding as solve_ex does keeps the answer of the port's general path
// and of its plain reference.
//
// Numerics otherwise: compiled without --use_fast_math and with
// -fmad=false, so that every operation rounds as the plain PyTorch version
// (solvers/qp_kernel.py::_finish_plain) rounds it, in the same order: Ax
// and Px summed over columns left to right, A'y over rows in index order,
// IEEE division, the fused multiply-adds written out as fmaf; the maxima
// propagate NaN, as torch.amax, torch.maximum and torch.clamp_min do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_N = 8;
constexpr int THREADS = 32;                // threads (problems) a block, on chip
constexpr int SHARED_BYTES = 48 * 1024;    // a block's shared memory, the most without an opt-in
constexpr int BLOCK_THREADS = 128;         // threads a block past the on-chip size (one problem)
constexpr int BLOCK_SYSTEM_FLOATS = 4096;  // a system in a block's shared memory, at most (16 KB)
constexpr long long WORKSPACE_FLOATS = 1ll << 24;  // a launch's workspace, at most (64 MiB)

// Floats of a problem's working storage for n variables and m rows, one
// thread a problem: the (n + m) x (n + m) system at most, its right-hand
// side (column n + m) and the active rows' indices (column n + m + 1).
__host__ __device__ constexpr int work_floats(int n, int m) { return (n + m) * (n + m + 2); }

// Floats of a problem's inputs: P, q, A, l, u, their scaled copies, d, e,
// x and y.
__host__ __device__ constexpr int input_floats(int n, int m) {
  return 2 * n * n + 4 * n + 2 * m * n + 6 * m;
}

// Floats of a problem's largest system and its right-hand side, a block a
// problem: (n + m) x (n + m + 1).
__host__ __device__ constexpr long long system_floats(int n, int m) {
  return static_cast<long long>(n + m) * (n + m + 1);
}

// Whether a block's inputs and working storage fit in shared memory, one
// thread a problem.
bool on_chip(int n, int m) {
  return (work_floats(n, m) + input_floats(n, m)) * THREADS * 4 <= SHARED_BYTES;
}

// Blocks a launch runs past the on-chip size: one a problem; where a system
// can pass BLOCK_SYSTEM_FLOATS, as many as WORKSPACE_FLOATS holds a slice
// of system_floats for (at least one), at most B.
long long block_count(int B, int n, int m) {
  const long long per = system_floats(n, m);
  if (per <= BLOCK_SYSTEM_FLOATS) return B;
  const long long s = WORKSPACE_FLOATS / per;
  return s < 1 ? 1 : s < B ? s : B;
}

// max(a, b), NaN if either is: torch.maximum's result.
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// A thread's working storage: element (r, c) at p[(r * cols + c) * stride].
struct Work {
  float* p;
  int cols, stride;
  __device__ float& at(int r, int c) const {
    return p[(static_cast<size_t>(r) * cols + c) * stride];
  }
};

// Sum over the NV columns of row j of M (row-major, NV wide) times v, left
// to right.
template <int NV>
__device__ __forceinline__ float row_dot(const float* M, int j, const float (&v)[NV]) {
  float s = M[j * NV] * v[0];
#pragma unroll
  for (int i = 1; i < NV; ++i) s = s + M[j * NV + i] * v[i];
  return s;
}

// A problem's inputs, each array at its first problem or at one problem.
struct Problem {
  const float *P, *q, *A, *lo, *hi;       // original: (n, n), (n), (m, n), (m), (m)
  const float *Ps, *qs, *As, *ls, *us;    // equilibrated
  const float *d, *e, *xs, *ys;           // row and column scaling; the ADMM iterate
};

// Problem b of the arrays p points at.
template <int NV>
__device__ Problem problem(const Problem& p, size_t b, int m) {
  const size_t bn = b * NV, bm = b * m;
  return Problem{p.P + bn * NV, p.q + bn, p.A + bm * NV, p.lo + bm, p.hi + bm,
                 p.Ps + bn * NV, p.qs + bn, p.As + bm * NV, p.ls + bm, p.us + bm,
                 p.d + bm, p.e + bn, p.xs + bn, p.ys + bm};
}

// dst[i] = src[i] for i < count, by the block's threads in turn: a
// coalesced copy into shared memory, asynchronous on the card (cp.async).
__device__ __forceinline__ void copy_in(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) {
#ifdef __CUDA_ARCH__
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src + i));
#else
    dst[i] = src[i];
#endif
  }
}

// The block's `count` problems from `first` on, each input array's slab
// copied into `stage` (slabs of THREADS problems); returns the slabs'
// problem 0.  The copies are waited for, and the block synchronized.
template <int NV>
__device__ Problem stage_block(const Problem& g, float* stage, size_t first, int count, int m) {
  const Problem src = problem<NV>(g, first, m);
  const float* from[] = {src.P, src.q, src.A, src.lo, src.hi, src.Ps, src.qs,
                         src.As, src.ls, src.us, src.d, src.e, src.xs, src.ys};
  const int len[] = {NV * NV, NV, m * NV, m, m, NV * NV, NV, m * NV, m, m, m, NV, NV, m};
  const float* to[14];
  for (int a = 0; a < 14; ++a) {
    copy_in(stage, from[a], count * len[a]);
    to[a] = stage;
    stage += THREADS * len[a];
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
  __syncthreads();
  return Problem{to[0], to[1], to[2], to[3], to[4], to[5], to[6],
                 to[7], to[8], to[9], to[10], to[11], to[12], to[13]};
}

// The polish of one problem: true where the polished point is kept, its x
// in xp, its nu in w's right-hand side column (rows n..n+k-1) and the
// active rows' indices in w's last column (rows 0..k-1).
template <int NV>
__device__ bool polish(const Problem& p, int m, const float (&x)[NV], float (&xp)[NV],
                       const Work& w, int& k, float reg, float act_tol) {
  const int rhs = NV + m, idx = NV + m + 1;
  float vx = -INFINITY;  // the iterate's violation
  k = 0;
  for (int j = 0; j < m; ++j) {
    const float ax = row_dot<NV>(p.As, j, x);
    const float lj = p.ls[j], uj = p.us[j], yj = p.ys[j];
    const bool fl = isfinite(lj), fu = isfinite(uj);
    if (fl) vx = max_nan(vx, lj - ax);
    if (fu) vx = max_nan(vx, ax - uj);
    const bool lower = fl && (ax - lj < act_tol || yj < -act_tol);
    const bool upper = fu && (uj - ax < act_tol || yj > act_tol);
    if (!(lower || upper)) continue;
    const int r = NV + k;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float a = p.As[j * NV + i];
      w.at(i, r) = a;
      w.at(r, i) = a;
    }
    w.at(r, rhs) = upper ? uj : lj;
    w.at(k, idx) = static_cast<float>(j);
    ++k;
  }
  const int N = NV + k;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int c = 0; c < NV; ++c) w.at(i, c) = p.Ps[i * NV + c] + (i == c ? reg : 0.0f);
    w.at(i, rhs) = -p.qs[i];
  }
  for (int r = NV; r < N; ++r)
    for (int c = NV; c < N; ++c) w.at(r, c) = r == c ? -reg : 0.0f;

  // LU with partial pivoting, the right-hand side eliminated alongside
  // (the forward substitution, row by row in the order of the columns).
  for (int c = 0; c < N; ++c) {
    int piv_row = c;
    float best = fabsf(w.at(c, c));
    for (int r = c + 1; r < N; ++r) {
      const float v = fabsf(w.at(r, c));
      if (v > best) {
        best = v;
        piv_row = r;
      }
    }
    if (best == 0.0f) return false;  // singular
    if (piv_row != c) {
      for (int cc = c; cc < N; ++cc) {
        const float t = w.at(c, cc);
        w.at(c, cc) = w.at(piv_row, cc);
        w.at(piv_row, cc) = t;
      }
      const float t = w.at(c, rhs);
      w.at(c, rhs) = w.at(piv_row, rhs);
      w.at(piv_row, rhs) = t;
    }
    const float inv = 1.0f / w.at(c, c);
    for (int r = c + 1; r < N; ++r) {
      const float l = w.at(r, c) * inv;
      for (int cc = c + 1; cc < N; ++cc) w.at(r, cc) = fmaf(-l, w.at(c, cc), w.at(r, cc));
      w.at(r, rhs) = fmaf(-l, w.at(c, rhs), w.at(r, rhs));
    }
  }
  // Back substitution, column by column from the last.
  for (int c = N - 1; c >= 0; --c) {
    const float s = w.at(c, rhs) / w.at(c, c);
    w.at(c, rhs) = s;
    for (int r = 0; r < c; ++r) w.at(r, rhs) = fmaf(-w.at(r, c), s, w.at(r, rhs));
  }

  bool finite = true;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    xp[i] = w.at(i, rhs);
    finite = finite && isfinite(xp[i]);
  }
  float vp = -INFINITY;  // the polished point's violation
  for (int j = 0; j < m; ++j) {
    const float axp = row_dot<NV>(p.As, j, xp);
    if (isfinite(p.ls[j])) vp = max_nan(vp, p.ls[j] - axp);
    if (isfinite(p.us[j])) vp = max_nan(vp, axp - p.us[j]);
  }
  return finite && max_nan(vp, 0.0f) <= max_nan(vx, 0.0f) + 1e-7f;
}

struct Out {
  float *x, *y, *prim, *dual;
};

// The finish of problem b, its inputs at p.
template <int NV>
__device__ void finish(const Problem& p, const Out& o, size_t b, int m, const Work& w,
                       bool do_polish, float reg, float act_tol) {
  float x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = p.xs[i];
  int k = 0;
  bool kept = false;
  if (do_polish) {
    float xp[NV];
    kept = polish<NV>(p, m, x, xp, w, k, reg, act_tol);
    if (kept) {
#pragma unroll
      for (int i = 0; i < NV; ++i) x[i] = xp[i];
    }
  }

  // Unscale; the residuals in row-scaled units.
  const int rhs = NV + m, idx = NV + m + 1;
  float xo[NV], aty[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    xo[i] = p.e[i] * x[i];
    o.x[b * NV + i] = xo[i];
    aty[i] = -0.0f;  // -0 + v == v: the first row's term, exactly
  }
  float prim = -INFINITY;
  int t = 0, next = kept && k > 0 ? static_cast<int>(w.at(0, idx)) : -1;
  for (int j = 0; j < m; ++j) {
    float yj;
    if (!kept) {
      yj = p.ys[j];
    } else if (j == next) {  // the t-th active row: its nu
      yj = w.at(NV + t, rhs);
      ++t;
      next = t < k ? static_cast<int>(w.at(t, idx)) : -1;
    } else {
      yj = 0.0f;
    }
    const float dj = p.d[j];
    const float yo = yj * dj;
    o.y[b * m + j] = yo;
    const float ax = row_dot<NV>(p.A, j, xo);
    if (isfinite(p.lo[j])) prim = max_nan(prim, (p.lo[j] - ax) * dj);
    if (isfinite(p.hi[j])) prim = max_nan(prim, (ax - p.hi[j]) * dj);
#pragma unroll
    for (int i = 0; i < NV; ++i) aty[i] = aty[i] + p.A[j * NV + i] * yo;
  }
  o.prim[b] = max_nan(prim, 0.0f);
  float dual = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = row_dot<NV>(p.P, i, xo);
    s = s + p.q[i];
    s = s + aty[i];
    dual = max_nan(dual, fabsf(s));
  }
  o.dual[b] = dual;
}

// On chip: a block of THREADS problems, its inputs and systems in shared
// memory.
template <int NV>
__global__ void __launch_bounds__(THREADS)
qp_finish_kernel(Problem g, Out o, int B, int m, int do_polish, float reg, float act_tol) {
  extern __shared__ float shared[];
  const size_t first = static_cast<size_t>(blockIdx.x) * THREADS;
  const int count = B - first < THREADS ? static_cast<int>(B - first) : THREADS;
  const Problem s = stage_block<NV>(g, shared + THREADS * work_floats(NV, m), first, count, m);
  if (static_cast<int>(threadIdx.x) >= count) return;
  const Work w{shared + threadIdx.x, NV + m + 2, THREADS};
  finish<NV>(problem<NV>(s, threadIdx.x, m), o, first + threadIdx.x, m, w, do_polish, reg,
             act_tol);
}

// ---- past the on-chip size: a block a problem --------------------------------

constexpr unsigned FULL = 0xffffffffu;

// The largest of the warp's v: every lane's result is the same number (a
// zero's sign aside, which no caller keeps).
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// One problem's finish by a block of BLOCK_THREADS: the same operations as
// polish() and finish(), each element's in the same order.  Warp 0 takes
// the passes over the rows, 32 at a time (the active rows ranked by a ballot
// and its prefix count), the pivot search, the row swap, the back
// substitution and the sums over rows; the block takes the elimination's
// updates, warps over rows and lanes over columns.  The system is N x (N + 1)
// row-major, N = n + k, its right-hand side column N: in sys_shared where it
// fits sys_cap floats, else in the block's slice of the workspace.  act and
// up hold a bit a row: active, and active at its upper bound.
template <int NV>
__device__ void block_finish(const Problem& p, const Out& o, size_t b, int m, unsigned* act,
                             unsigned* up, float* sys_shared, int sys_cap, float* sys_work,
                             bool do_polish, float reg, float act_tol) {
  __shared__ int s_k, s_singular;
  __shared__ float s_vx;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;  // the lanes before this one
  float x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = p.xs[i];
  bool kept = false;
  float* sys = sys_shared;
  int N = NV, C = NV + 1;
#define A_(r, c) sys[(r) * C + (c)]
  if (do_polish) {
    // The active rows, and the iterate's violation.
    if (warp == 0) {
      float vx = -INFINITY;
      int k = 0;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        bool lower = false, upper = false;
        if (j < m) {
          const float ax = row_dot<NV>(p.As, j, x);
          const float lj = p.ls[j], uj = p.us[j], yj = p.ys[j];
          const bool fl = isfinite(lj), fu = isfinite(uj);
          if (fl) vx = max_nan(vx, lj - ax);
          if (fu) vx = max_nan(vx, ax - uj);
          lower = fl && (ax - lj < act_tol || yj < -act_tol);
          upper = fu && (uj - ax < act_tol || yj > act_tol);
        }
        const unsigned a_bits = __ballot_sync(FULL, lower || upper);
        const unsigned u_bits = __ballot_sync(FULL, upper);
        if (lane == 0) {
          act[j0 / 32] = a_bits;
          up[j0 / 32] = u_bits;
        }
        k += __popc(a_bits);
      }
      vx = warp_max(vx);
      if (lane == 0) {
        s_k = k;
        s_vx = vx;
      }
    }
    __syncthreads();
    N = NV + s_k;
    C = N + 1;
    if (static_cast<long long>(N) * C > sys_cap) sys = sys_work;
    // The system: P + reg I and -q (all), -reg I over the active rows (all),
    // the active rows of A and their bounds (warp 0, by rank).
    for (int e = threadIdx.x; e < NV * (NV + 1); e += BLOCK_THREADS) {
      const int i = e / (NV + 1), c = e % (NV + 1);
      if (c < NV) A_(i, c) = p.Ps[i * NV + c] + (i == c ? reg : 0.0f);
      else A_(i, N) = -p.qs[i];
    }
    for (int e = threadIdx.x; e < s_k * s_k; e += BLOCK_THREADS) {
      const int r = e / s_k, c = e % s_k;
      A_(NV + r, NV + c) = r == c ? -reg : 0.0f;
    }
    if (warp == 0) {
      int base = 0;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const unsigned bits = act[j0 / 32];
        if (bits >> lane & 1) {
          const int j = j0 + lane, r = NV + base + __popc(bits & below);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const float a = p.As[j * NV + i];
            A_(i, r) = a;
            A_(r, i) = a;
          }
          A_(r, N) = up[j0 / 32] >> lane & 1 ? p.us[j] : p.ls[j];
        }
        base += __popc(bits);
      }
    }
    __syncthreads();

    // LU with partial pivoting, the right-hand side eliminated alongside.
    bool singular = false;
    for (int c = 0; c < N; ++c) {
      if (warp == 0) {
        // The first row of the largest |a| from the diagonal down; a NaN
        // below the diagonal is never taken, a NaN on it always.
        float best = -2.0f;
        int piv = N;
        for (int r = c + lane; r < N; r += 32) {
          float v = fabsf(A_(r, c));
          if (v != v) v = -1.0f;
          if (v > best) {
            best = v;
            piv = r;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, best, off);
          const int orow = __shfl_xor_sync(FULL, piv, off);
          if (ov > best || (ov == best && orow < piv)) {
            best = ov;
            piv = orow;
          }
        }
        if (A_(c, c) != A_(c, c)) piv = c;
        const bool zero = fabsf(A_(piv, c)) == 0.0f;
        if (!zero && piv != c) {
          for (int cc = c + lane; cc <= N; cc += 32) {
            const float t = A_(c, cc);
            A_(c, cc) = A_(piv, cc);
            A_(piv, cc) = t;
          }
        }
        if (lane == 0) s_singular = zero;
      }
      __syncthreads();
      if (s_singular) {
        singular = true;
        break;
      }
      const float inv = 1.0f / A_(c, c);
      for (int r = c + 1 + warp; r < N; r += BLOCK_THREADS / 32) {
        const float l = A_(r, c) * inv;
        for (int cc = c + 1 + lane; cc <= N; cc += 32) A_(r, cc) = fmaf(-l, A_(c, cc), A_(r, cc));
      }
      __syncthreads();
    }
    if (warp == 0 && !singular) {
      // Back substitution, column by column from the last.
      for (int c = N - 1; c >= 0; --c) {
        const float s = A_(c, N) / A_(c, c);
        __syncwarp();
        for (int r = lane; r < c; r += 32) A_(r, N) = fmaf(-A_(r, c), s, A_(r, N));
        if (lane == 0) A_(c, N) = s;
        __syncwarp();
      }
      float xp[NV];
      bool finite = true;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xp[i] = A_(i, N);
        finite = finite && isfinite(xp[i]);
      }
      float vp = -INFINITY;  // the polished point's violation
      for (int j = lane; j < m; j += 32) {
        const float axp = row_dot<NV>(p.As, j, xp);
        if (isfinite(p.ls[j])) vp = max_nan(vp, p.ls[j] - axp);
        if (isfinite(p.us[j])) vp = max_nan(vp, axp - p.us[j]);
      }
      vp = warp_max(vp);
      kept = finite && max_nan(vp, 0.0f) <= max_nan(s_vx, 0.0f) + 1e-7f;
      if (kept) {
#pragma unroll
        for (int i = 0; i < NV; ++i) x[i] = xp[i];
      }
    }
  }
  if (warp != 0) return;

  // Unscale; the residuals in row-scaled units.
  float xo[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) xo[i] = p.e[i] * x[i];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) o.x[b * NV + i] = xo[i];
  float prim = -INFINITY, aty = -0.0f;  // lane i < n: column i of A'y, from -0 (exact)
  int base = 0;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    float yo = 0.0f;
    if (j < m) {
      float yj = p.ys[j];
      if (kept) {
        const unsigned bits = act[j0 / 32];
        yj = bits >> lane & 1 ? A_(NV + base + __popc(bits & below), N) : 0.0f;
      }
      const float dj = p.d[j];
      yo = yj * dj;
      o.y[b * m + j] = yo;
      const float ax = row_dot<NV>(p.A, j, xo);
      if (isfinite(p.lo[j])) prim = max_nan(prim, (p.lo[j] - ax) * dj);
      if (isfinite(p.hi[j])) prim = max_nan(prim, (ax - p.hi[j]) * dj);
    }
    if (kept) base += __popc(act[j0 / 32]);
    const int rows = m - j0 < 32 ? m - j0 : 32;
    for (int t = 0; t < rows; ++t) {
      const float yt = __shfl_sync(FULL, yo, t);
      if (lane < NV) aty = aty + p.A[(j0 + t) * NV + lane] * yt;
    }
  }
#undef A_
  prim = warp_max(prim);
  float dual = -INFINITY;
  if (lane < NV) {
    float s = row_dot<NV>(p.P, lane, xo);
    s = s + p.q[lane];
    s = s + aty;
    dual = fabsf(s);
  }
  dual = warp_max(dual);
  if (lane == 0) {
    o.prim[b] = max_nan(prim, 0.0f);
    o.dual[b] = dual;
  }
}

// A block a problem, `blocks` blocks in all, each taking problems
// blockIdx.x, blockIdx.x + blocks, ...  Shared memory: the row bits, then
// the system (sys_cap floats).  work: a slice of system_floats(n, m) a block,
// or null where every system fits sys_cap.
template <int NV>
__global__ void __launch_bounds__(BLOCK_THREADS)
qp_finish_block_kernel(Problem g, Out o, float* __restrict__ work, int B, int m, int blocks,
                       int sys_cap, int do_polish, float reg, float act_tol) {
  extern __shared__ unsigned block_shared[];
  const int words = (m + 31) / 32;
  float* sys_work =
      work == nullptr ? nullptr : work + blockIdx.x * static_cast<size_t>(system_floats(NV, m));
  for (size_t b = blockIdx.x; b < static_cast<size_t>(B); b += blocks) {
    block_finish<NV>(problem<NV>(g, b, m), o, b, m, block_shared, block_shared + words,
                     reinterpret_cast<float*>(block_shared + 2 * words), sys_cap, sys_work,
                     do_polish, reg, act_tol);
    __syncthreads();  // the next problem reuses the row bits and the system
  }
}

template <int NV>
void launch(const Problem& p, const Out& o, float* work, int B, int m, int do_polish,
            float reg, float act_tol, cudaStream_t stream) {
  if (on_chip(NV, m)) {
    const size_t shared_bytes =
        static_cast<size_t>(work_floats(NV, m) + input_floats(NV, m)) * THREADS * sizeof(float);
    qp_finish_kernel<NV><<<(B + THREADS - 1) / THREADS, THREADS, shared_bytes, stream>>>(
        p, o, B, m, do_polish, reg, act_tol);
  } else {
    const int blocks = static_cast<int>(block_count(B, NV, m));
    const int sys_cap = static_cast<int>(
        system_floats(NV, m) < BLOCK_SYSTEM_FLOATS ? system_floats(NV, m) : BLOCK_SYSTEM_FLOATS);
    const size_t shared_bytes = (2 * static_cast<size_t>((m + 31) / 32) + sys_cap) * 4;
    qp_finish_block_kernel<NV><<<blocks, BLOCK_THREADS, shared_bytes, stream>>>(
        p, o, work, B, m, blocks, sys_cap, do_polish, reg, act_tol);
  }
}

}  // namespace

// Floats of the workspace a launch of B problems of n variables and m rows
// needs (0: every system stays on chip).
extern "C" long long qp_finish_workspace(int B, int n, int m) {
  if (B <= 0 || n < 1 || m < 1 || on_chip(n, m) || system_floats(n, m) <= BLOCK_SYSTEM_FLOATS)
    return 0;
  return block_count(B, n, m) * system_floats(n, m);
}

// The finish of B problems: the original problem (P, q, A, lo, hi), the
// equilibrated one (Ps, qs, As, ls, us) with its row and column scaling
// (d, e), the ADMM iterate in scaled variables (xs, ys); writes x, y, and
// the primal and dual residuals.  work: qp_finish_workspace(B, n, m)
// floats, or null where that is 0.  Returns a CUDA error code.
extern "C" int qp_finish_launch(const void* P, const void* q, const void* A, const void* lo,
                                const void* hi, const void* Ps, const void* qs, const void* As,
                                const void* ls, const void* us, const void* d, const void* e,
                                const void* xs, const void* ys, void* x, void* y, void* prim,
                                void* dual, void* work, int B, int n, int m, int do_polish,
                                float reg, float act_tol, void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || n < 1 || n > MAX_N || system_floats(n, m) > 0x7fffffff ||
      (work == nullptr) != (qp_finish_workspace(B, n, m) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const Problem p{f(P), f(q), f(A), f(lo), f(hi), f(Ps), f(qs), f(As), f(ls), f(us),
                  f(d), f(e), f(xs), f(ys)};
  const Out o{static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(prim),
              static_cast<float*>(dual)};
  float* wk = static_cast<float*>(work);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QP_FINISH_N(NV) launch<NV>(p, o, wk, B, m, do_polish, reg, act_tol, s)
  switch (n) {
    case 1: QP_FINISH_N(1); break;
    case 2: QP_FINISH_N(2); break;
    case 3: QP_FINISH_N(3); break;
    case 4: QP_FINISH_N(4); break;
    case 5: QP_FINISH_N(5); break;
    case 6: QP_FINISH_N(6); break;
    case 7: QP_FINISH_N(7); break;
    default: QP_FINISH_N(8); break;
  }
#undef QP_FINISH_N
  return static_cast<int>(cudaGetLastError());
}
