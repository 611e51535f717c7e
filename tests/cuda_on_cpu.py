"""Build a kernel's CUDA source for the CPU, under a warp emulation.

The port's hand-written kernels run only on a card, but their arithmetic
is plain IEEE float32 and their only CUDA features are warp-level: lanes
that shuffle and ``__syncwarp``.  ``build`` compiles a ``csrc/*.cu`` with
g++ against the header below, with ``<<<...>>>`` turned into
``emu_launch``: one warp at a time, its 32 lanes as fibers that take turns
at each ``__syncwarp`` and shuffle (the kernels never synchronise across
warps, so warps may run one after another).  No FMA contraction, as
``-fmad=false`` on the card, so a kernel that rounds as its plain version
does gives the same bits on the CPU.  A kernel that uses another CUDA feature
extends the header.
"""

import ctypes
import re
import subprocess
from pathlib import Path

CUDA_ON_CPU = r"""
#include <math.h>
#include <ucontext.h>
#include <cmath>
#include <cstddef>
#include <functional>
#include <vector>
using std::isfinite;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) alignas(n)
struct emu_dim { unsigned x, y, z; };
static emu_dim blockIdx, blockDim, emu_tid[32];
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
static inline int cudaGetLastError() { return 0; }
struct EmuLane { ucontext_t ctx; std::vector<char> stack; bool done; };
static EmuLane emu_lanes[32];
static ucontext_t emu_main;
static int emu_lane, emu_count, emu_phase;
#define threadIdx (emu_tid[emu_lane])
static float emu_slots[2][32];
static std::function<void()> emu_body;
static inline void emu_switch() {
  const int prev = emu_lane;
  do emu_lane = (emu_lane + 1) % 32; while (emu_lanes[emu_lane].done && emu_lane != prev);
  if (emu_lane != prev) swapcontext(&emu_lanes[prev].ctx, &emu_lanes[emu_lane].ctx);
}
static inline void __syncwarp(unsigned = 0xffffffffu) {
  const int phase = emu_phase;
  if (++emu_count == 32) { emu_count = 0; ++emu_phase; return; }
  while (emu_phase == phase) emu_switch();
}
// One barrier a shuffle: the k-th shuffle of every lane writes buffer k % 2,
// and no lane writes that buffer again before all have passed the next
// barrier, that is, read this one.
static inline float emu_exchange(float v, int src) {
  const int lane = emu_lane;
  float* slots = emu_slots[emu_phase & 1];
  slots[lane] = v;
  __syncwarp();
  return slots[src];
}
static inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  return emu_exchange(v, (emu_lane & ~(width - 1)) + (src & (width - 1)));
}
static inline float __shfl_xor_sync(unsigned, float v, int mask, int width = 32) {
  return emu_exchange(v, (emu_lane & ~(width - 1)) + ((emu_lane ^ mask) & (width - 1)));
}
static inline void emu_entry() {
  emu_body();
  emu_lanes[emu_lane].done = true;
  bool all = true;
  for (auto& l : emu_lanes) all = all && l.done;
  if (all) setcontext(&emu_main);
  emu_switch();
}
template <class... KA, class... A>
static void emu_launch(int blocks, int threads, void (*kern)(KA...), A... args) {
  emu_body = [=] { kern(args...); };
  blockDim = {unsigned(threads), 1, 1};
  for (int bi = 0; bi < blocks; ++bi)
    for (int w = 0; w < threads / 32; ++w) {
      blockIdx = {unsigned(bi), 0, 0};
      for (int l = 0; l < 32; ++l) {
        EmuLane& e = emu_lanes[l];
        e.stack.resize(1 << 18);
        e.done = false;
        getcontext(&e.ctx);
        e.ctx.uc_stack.ss_sp = e.stack.data();
        e.ctx.uc_stack.ss_size = e.stack.size();
        e.ctx.uc_link = nullptr;
        makecontext(&e.ctx, emu_entry, 0);
      }
      for (int l = 0; l < 32; ++l) emu_tid[l] = {unsigned(w * 32 + l), 0, 0};
      emu_lane = 0;
      emu_count = emu_phase = 0;
      swapcontext(&emu_main, &emu_lanes[0].ctx);
    }
}
"""


def build(source: Path, tmp_path: Path) -> ctypes.CDLL:
    """``source`` (a ``csrc/*.cu``) built for the CPU under the emulation
    into ``tmp_path``, and loaded; its headers are found beside it."""
    (tmp_path / "cuda_runtime.h").write_text(CUDA_ON_CPU)
    # kernel<...><<<blocks, threads, shared, stream>>>(  ->  emu_launch(blocks, threads, kernel<...>,
    text = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                  r"emu_launch(\2, \3, \1, ", source.read_text())
    cpp = tmp_path / f"{source.stem}.cpp"
    cpp.write_text(text)
    lib = tmp_path / f"lib{source.stem}_cpu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(tmp_path), "-I", str(source.parent), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))
