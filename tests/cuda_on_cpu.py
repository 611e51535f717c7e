"""Build a kernel's CUDA source for the CPU, under a block emulation.

The port's hand-written kernels run only on a card, but their arithmetic
is plain IEEE float32 and the CUDA features they use are few: lanes that
shuffle and ``__syncwarp``, ``__syncthreads`` over a block, static and
dynamic shared memory.  ``build`` compiles a ``csrc/*.cu`` with g++ against
the header below, with ``<<<...>>>`` turned into ``emu_launch``: one block
at a time, every thread of it a fiber.  The fibers take turns at each
barrier: ``__syncwarp`` and the shuffles wait for the 32 lanes of their
warp, ``__syncthreads`` for the whole block.  ``extern __shared__`` arrays
point at a buffer of the launch's third ``<<<>>>`` argument in bytes,
filled with NaN bytes before each block, so that a read of shared memory
that no thread wrote shows.  No FMA contraction, as ``-fmad=false`` on the
card, so a kernel that rounds as its plain version does gives the same bits
on the CPU.  A kernel that uses another CUDA feature extends the header.
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
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
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
static inline void* emu_dynamic_shared() { return emu_dyn.data(); }
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


def _launch(match: re.Match) -> str:
    # kernel<...><<<blocks, threads[, shared[, stream]]>>>(
    #   ->  emu_launch(blocks, threads, shared, kernel<...>,
    config = [a.strip() for a in match.group(2).split(",")]
    shared = config[2] if len(config) > 2 else "0"
    return f"emu_launch({config[0]}, {config[1]}, {shared}, {match.group(1)}, "


def build(source: Path, tmp_path: Path) -> ctypes.CDLL:
    """``source`` (a ``csrc/*.cu``) built for the CPU under the emulation
    into ``tmp_path``, and loaded; its headers are found beside it."""
    (tmp_path / "cuda_runtime.h").write_text(CUDA_ON_CPU)
    text = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", _launch, source.read_text())
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* const \2 = static_cast<\1*>(emu_dynamic_shared());", text)
    cpp = tmp_path / f"{source.stem}.cpp"
    cpp.write_text(text)
    lib = tmp_path / f"lib{source.stem}_cpu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(tmp_path), "-I", str(source.parent), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))
