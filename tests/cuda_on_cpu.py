"""Build a kernel's CUDA source for the CPU, under a block emulation.

The port's hand-written kernels run only on a card, but their arithmetic
is plain IEEE float32 and the CUDA features they use are few: lanes that
shuffle (floats and ints), vote (``__ballot_sync``, ``__popc``) and
``__syncwarp``, ``__syncthreads`` over a block, static and
dynamic shared memory, ``clock64`` (here the host's steady clock in
nanoseconds) and 64-bit ``atomicAdd``.  ``build`` compiles a ``csrc/*.cu`` with g++ against
the header below, with ``<<<...>>>`` turned into ``emu_launch``: one block
at a time, every thread of it a fiber.  The fibers take turns at each
barrier: ``__syncwarp`` and the shuffles wait for the 32 lanes of their
warp, ``__syncthreads`` for the whole block.  ``extern __shared__`` arrays
point at a buffer of the launch's third ``<<<>>>`` argument in bytes,
filled with NaN bytes before each block, so that a read of shared memory
that no thread wrote shows.  No FMA contraction, as ``-fmad=false`` on the
card, so a kernel that rounds as its plain version does gives the same bits
on the CPU.  A kernel that uses another CUDA feature extends the header.
A built library's ``emu_block_threads()`` gives the threads a block of its
last launch.

The C library's ``sinf``, ``cosf``, ``expf``, ``atan2f``, ``tanf``, ``atanf``
and ``tanhf`` round unlike
PyTorch's CPU kernels.  ``build(..., ieee_math=True)`` replaces them by the
float64 function rounded once to float32, and ``ieee_math`` patches
``torch`` with the same functions and PyTorch's forward-mode derivative
rules (``ieee_sqrt`` included), so that a plain version that differentiates
through them can be held to such a build bit for bit.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import torch

CUDA_ON_CPU = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>
#include <cmath>
#include <algorithm>
#include <chrono>
#include <cstddef>
#include <functional>
#include <vector>
using std::isfinite;
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) alignas(n)
struct emu_dim { unsigned x, y, z; };
static emu_dim blockIdx, blockDim;
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
};
constexpr int cudaSharedmemCarveoutMaxShared = 100;
static inline int cudaGetLastError() { return 0; }
// The SM's cycle counter: the host's steady clock in nanoseconds.
static inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
// One fiber runs at a time, so an add is atomic as it stands.
static inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
#ifdef EMU_IEEE_MATH
static inline float emu_sinf(float a) { return (float)sin((double)a); }
static inline float emu_cosf(float a) { return (float)cos((double)a); }
static inline float emu_expf(float a) { return (float)exp((double)a); }
static inline float emu_atan2f(float y, float x) { return (float)atan2((double)y, (double)x); }
static inline float emu_tanf(float a) { return (float)tan((double)a); }
static inline float emu_atanf(float a) { return (float)atan((double)a); }
static inline float emu_tanhf(float a) { return (float)tanh((double)a); }
#define sinf emu_sinf
#define cosf emu_cosf
#define expf emu_expf
#define atan2f emu_atan2f
#define tanf emu_tanf
#define atanf emu_atanf
#define tanhf emu_tanhf
#endif
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct cudaFuncAttributes { int maxThreadsPerBlock; };
template <class F>
static inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, F) { return cudaSuccess; }
// A CPU has no multiprocessors: occupancy is a question for the card.
template <class F>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;
  return cudaErrorInvalidValue;
}
struct EmuThread { ucontext_t ctx; std::vector<char> stack; bool done; };
static std::vector<EmuThread> emu_threads;
static std::vector<emu_dim> emu_tid;
static ucontext_t emu_main;
static int emu_cur, emu_nthreads, emu_block_count, emu_block_phase;
static long emu_spins;
static std::vector<int> emu_warp_count, emu_warp_phase;
static std::vector<float> emu_slots;  // per warp: two buffers of 32 lanes
static std::vector<double> emu_dyn;  // dynamic shared memory, 8-byte aligned
#define threadIdx (emu_tid[emu_cur])
static std::function<void()> emu_body;
static inline void emu_switch() {
  const int prev = emu_cur;
  do emu_cur = (emu_cur + 1) % emu_nthreads; while (emu_threads[emu_cur].done && emu_cur != prev);
  if (emu_cur != prev) swapcontext(&emu_threads[prev].ctx, &emu_threads[emu_cur].ctx);
}
// Wait while ``*phase == seen``; a barrier that no thread can complete
// (a thread exited, or waits at another barrier) stops the program.
static inline void emu_wait(const int* phase, int seen) {
  while (*phase == seen) {
    if (++emu_spins > 100000000L) {
      fprintf(stderr, "cuda_on_cpu: deadlock at a barrier\n");
      abort();
    }
    emu_switch();
  }
}
static inline int emu_warp_size(int w) {
  const int rest = emu_nthreads - 32 * w;
  return rest < 32 ? rest : 32;
}
static inline void __syncwarp(unsigned = 0xffffffffu) {
  const int w = emu_cur / 32;
  const int phase = emu_warp_phase[w];
  if (++emu_warp_count[w] == emu_warp_size(w)) {
    emu_warp_count[w] = 0;
    ++emu_warp_phase[w];
    emu_spins = 0;
    return;
  }
  emu_wait(&emu_warp_phase[w], phase);
}
static inline void __syncthreads() {
  const int phase = emu_block_phase;
  if (++emu_block_count == emu_nthreads) {
    emu_block_count = 0;
    ++emu_block_phase;
    emu_spins = 0;
    return;
  }
  emu_wait(&emu_block_phase, phase);
}
// One barrier a shuffle: the k-th shuffle of every lane of a warp writes
// buffer k % 2, and no lane writes that buffer again before all have passed
// the next barrier, that is, read this one.
static inline float emu_exchange(float v, int src) {
  const int w = emu_cur / 32, lane = emu_cur % 32;
  float* slots = &emu_slots[(2 * w + (emu_warp_phase[w] & 1)) * 32];
  slots[lane] = v;
  __syncwarp();
  return slots[src];
}
static inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = emu_cur % 32;
  return emu_exchange(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
static inline float __shfl_xor_sync(unsigned, float v, int mask, int width = 32) {
  const int lane = emu_cur % 32;
  return emu_exchange(v, (lane & ~(width - 1)) + ((lane ^ mask) & (width - 1)));
}
static inline int __shfl_xor_sync(unsigned, int v, int mask, int width = 32) {
  float f;
  memcpy(&f, &v, sizeof f);
  f = __shfl_xor_sync(0u, f, mask, width);
  memcpy(&v, &f, sizeof v);
  return v;
}
// A bit a lane of the warp, set where pred holds (the shuffles' buffers).
static inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = emu_cur / 32, lane = emu_cur % 32;
  float* slots = &emu_slots[(2 * w + (emu_warp_phase[w] & 1)) * 32];
  slots[lane] = pred ? 1.0f : 0.0f;
  __syncwarp();
  unsigned bits = 0;
  for (int i = 0; i < emu_warp_size(w); ++i)
    if (slots[i] != 0.0f) bits |= 1u << i;
  return bits;
}
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
static inline void* emu_dynamic_shared() { return emu_dyn.data(); }
// Threads a block of the last launch (0 before any).
extern "C" int emu_block_threads() { return emu_nthreads; }
static inline void emu_entry() {
  emu_body();
  emu_threads[emu_cur].done = true;
  bool all = true;
  for (int t = 0; t < emu_nthreads; ++t) all = all && emu_threads[t].done;
  if (all) setcontext(&emu_main);
  emu_switch();
}
template <class... KA, class... A>
static void emu_launch(int blocks, int threads, size_t shared_bytes, void (*kern)(KA...),
                       A... args) {
  emu_body = [=] { kern(args...); };
  blockDim = {unsigned(threads), 1, 1};
  emu_nthreads = threads;
  if ((int)emu_threads.size() < threads) emu_threads.resize(threads);
  emu_tid.resize(threads);
  const int warps = (threads + 31) / 32;
  emu_warp_count.assign(warps, 0);
  emu_warp_phase.assign(warps, 0);
  emu_slots.assign(warps * 64, 0.0f);
  emu_dyn.resize((shared_bytes + 7) / 8 + 1);
  for (int bi = 0; bi < blocks; ++bi) {
    blockIdx = {unsigned(bi), 0, 0};
    memset(emu_dyn.data(), 0xff, emu_dyn.size() * sizeof(double));
    for (int t = 0; t < threads; ++t) {
      EmuThread& e = emu_threads[t];
      e.stack.resize(1 << 18);
      e.done = false;
      getcontext(&e.ctx);
      e.ctx.uc_stack.ss_sp = e.stack.data();
      e.ctx.uc_stack.ss_size = e.stack.size();
      e.ctx.uc_link = nullptr;
      makecontext(&e.ctx, emu_entry, 0);
      emu_tid[t] = {unsigned(t), 0, 0};
    }
    emu_cur = 0;
    emu_block_count = emu_block_phase = 0;
    emu_spins = 0;
    swapcontext(&emu_main, &emu_threads[0].ctx);
  }
}
"""


def ieee_sqrt(t):
    """float32 square root, correctly rounded, as ``sqrtf`` and the card's
    ``torch.sqrt`` compute it: in float64, then rounded once more (exact,
    since 53 >= 2 * 24 + 2 bits).  PyTorch's float32 CPU ``torch.sqrt`` (its
    AVX-512 kernel) is not always correctly rounded (2.0936923 gives
    1.4469596, IEEE 1.4469597), so a plain version held to a CPU build bit
    for bit takes this one."""
    return torch.ops.aten.sqrt(t.double()).to(t.dtype)


def _ieee(op, t):
    """``op`` in float64, rounded once to ``t``'s type."""
    return op(t.double()).to(t.dtype)


class _Sin(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.sin, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t * _ieee(torch.ops.aten.cos, x)


class _Cos(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.cos, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t * -_ieee(torch.ops.aten.sin, x)


class _Exp(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.exp, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, t):
        (r,) = ctx.saved_tensors
        return t * r


class _Sqrt(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return ieee_sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, t):
        (r,) = ctx.saved_tensors
        return t / (2 * r)


class _Atan2(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(y, x):
        return torch.ops.aten.atan2(y.double(), x.double()).to(y.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, ty, tx):
        y, x = ctx.saved_tensors
        ty = torch.zeros_like(y) if ty is None else ty
        tx = torch.zeros_like(x) if tx is None else tx
        return (-y * tx + x * ty) / (y * y + x * x)


class _Tan(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.tan, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, t):
        (r,) = ctx.saved_tensors
        return t * (1 + r * r)


class _Atan(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.atan, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t / (x * x + 1)


class _Tanh(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _ieee(torch.ops.aten.tanh, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, t):
        (r,) = ctx.saved_tensors
        return torch.ops.aten.tanh_backward(t, r)  # t * fma(-r, r, 1)


def ieee_math(monkeypatch) -> None:
    """Patch ``torch.sin``, ``cos``, ``exp``, ``sqrt``, ``atan2``, ``tan``,
    ``atan`` and ``tanh`` with the float64 functions rounded once to
    float32, the counterpart of a build with ``ieee_math=True``.  Their
    forward-mode derivatives follow PyTorch's rules
    (``csrc/mpc_fused_dual.h``): t cos v, t (-sin v), t r, t / (2 r),
    (-y tx + x ty) / (y^2 + x^2), t (1 + r^2), t / (v^2 + 1) and
    t fma(-r, r, 1)."""
    monkeypatch.setattr(torch, "sin", _Sin.apply)
    monkeypatch.setattr(torch, "cos", _Cos.apply)
    monkeypatch.setattr(torch, "exp", _Exp.apply)
    monkeypatch.setattr(torch, "sqrt", _Sqrt.apply)
    monkeypatch.setattr(torch, "atan2", _Atan2.apply)
    monkeypatch.setattr(torch, "tan", _Tan.apply)
    monkeypatch.setattr(torch, "atan", _Atan.apply)
    monkeypatch.setattr(torch, "tanh", _Tanh.apply)


def _launch(match: re.Match) -> str:
    # kernel<...><<<blocks, threads[, shared[, stream]]>>>(
    #   ->  emu_launch(blocks, threads, shared, kernel<...>,
    config = [a.strip() for a in match.group(2).split(",")]
    shared = config[2] if len(config) > 2 else "0"
    return f"emu_launch({config[0]}, {config[1]}, {shared}, {match.group(1)}, "


def build(source: Path, tmp_path: Path, ieee_math: bool = False) -> ctypes.CDLL:
    """``source`` (a ``csrc/*.cu``) built for the CPU under the emulation
    into ``tmp_path``, and loaded; its headers are found beside it.  With
    ``ieee_math`` the C library's sinf, cosf, expf, atan2f, tanf, atanf and
    tanhf become the
    float64 functions rounded to float32 (see :func:`ieee_math`)."""
    (tmp_path / "cuda_runtime.h").write_text(CUDA_ON_CPU)
    # A .cu that includes another .cu (a second build of the same kernels)
    # takes its text, so that the rewriting below reaches it.
    text = re.sub(r'^#include "(\w+\.cu)"', lambda m: (source.parent / m.group(1)).read_text(),
                  source.read_text(), flags=re.M)
    text = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", _launch, text)
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* const \2 = static_cast<\1*>(emu_dynamic_shared());", text)
    cpp = tmp_path / f"{source.stem}.cpp"
    cpp.write_text(text)
    lib = tmp_path / f"lib{source.stem}_cpu.so"
    defines = ["-DEMU_IEEE_MATH"] if ieee_math else []
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", *defines,
                    "-I", str(tmp_path), "-I", str(source.parent), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))
