"""Hold two builds of the generic fused MPC-CBF kernel against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 fused_kernel_ab.py OTHER_DIR

``OTHER_DIR`` holds another ``mpc_fused_kernel.cu`` with the same C entry
points (``mpc_fused_launch``, ``mpc_fused_shared_bytes``) and its headers,
for example an earlier commit's ``safe_control_tpu_torch/csrc`` unpacked
with ``git archive`` into the ignored ``build/`` directory, or a copy of
this one with another launch shape or a part of the Newton step changed.

The script builds the package's kernel (``csrc/mpc_fused_kernel.cu``) and
the other one with the same nvcc flags, both at once, and prints each
build's ptxas report per model, its
threads a block, shared bytes and blocks an SM (the CUDA occupancy
calculator) at Quad3D N=10 and VTOL2D N=16.  On the problems of
``chip_smoke.py``'s phase 10 (Quad3D N=10 at B=4096, cold start;
DynamicUnicycle2D N=8 at B=4096; VTOL2D N=16 at B=256; SingleIntegrator2D
and DoubleIntegrator2D N=10 at B=64) it reports whether each build gives the
package's bits, and holds the package's build to its plain PyTorch version
on the first 64 problems of each (max |du| and |dxs| < 5e-3, viol atol
1e-3; bits reported).  Then it times both launches with CUDA events, in
turns (other, this, this, other), at Quad3D N=10 B = 1, 396, 4096 and 16384 and VTOL2D N=16 B=256, beside the
card's name and power limit.  Exits non-zero when a check fails or there is
no card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

DEVICE = "cuda"
U_TOL = 5e-3
VIOL_TOL = 1e-3
N_PLAIN = 64  # problems of each set held to the plain version
TIMED = [("Quad3D", 1, 20), ("Quad3D", 396, 10), ("Quad3D", 4096, 5), ("Quad3D", 16384, 2),
         ("VTOL2D", 256, 10)]

# Blocks an SM of a build without ``mpc_fused_blocks_per_sm``: appended to a
# copy of its source, where its kernel template is in scope.
OCCUPANCY_SHIM = r"""
extern "C" int ab_blocks_per_sm(int model, int threads, int bytes) {
  int blocks = -1;
#define AB_CASE(ID, MODEL)                                                                     \
  case ID:                                                                                     \
    if (cudaFuncSetAttribute(mpc_fused_kernel<MODEL>,                                          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) == 0)         \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mpc_fused_kernel<MODEL>, threads, \
                                                    bytes);                                    \
    break;
  switch (model) {
    AB_CASE(0, SingleIntegrator2D)
    AB_CASE(1, DoubleIntegrator2D)
    AB_CASE(2, DynamicUnicycle2D)
    AB_CASE(3, Quad3D)
    AB_CASE(4, VTOL2D)
  }
#undef AB_CASE
  return blocks;
}
"""


def build_all(jobs):
    """``jobs``: name -> source (headers beside it).  One nvcc each, all
    started together; name -> (library, ptxas report)."""
    from safe_control_tpu_torch import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, source in jobs.items():
        lib = out_dir / f"libmpc_fused_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-o", str(lib),
               str(source)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True), lib)
    built = {}
    for name, (proc, lib) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{stdout}\n{stderr}")
        built[name] = (ctypes.CDLL(str(lib)), stdout + stderr)
    return built


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_kernel_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import numpy as np

    from chip_smoke import card_line, fused_ptxas, sync_time
    from safe_control_tpu_torch import _build, entry
    from safe_control_tpu_torch.core.spec import (
        DOUBLE_INTEGRATOR_2D,
        DYNAMIC_UNICYCLE_2D,
        QUAD_3D,
        SINGLE_INTEGRATOR_2D,
        VTOL_2D,
        make_spec,
    )
    from safe_control_tpu_torch.core.types import pad_obstacles
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    dev = torch.device(DEVICE)
    card = card_line()
    print(card)

    # ---- build all -------------------------------------------------------------
    csrc = Path(mf.__file__).resolve().parent.parent / "csrc"
    other_dir = Path(sys.argv[1]).resolve()
    copy = _build.BUILD_DIR / "ab" / "other"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    for f in list(other_dir.glob("*.h")) + [other_dir / "mpc_fused_kernel.cu"]:
        shutil.copy(f, copy / f.name)
    other_src = copy / "mpc_fused_kernel.cu"
    if "mpc_fused_blocks_per_sm" not in other_src.read_text():
        other_src.write_text(other_src.read_text() + OCCUPANCY_SHIM)
    jobs = {"this": csrc / "mpc_fused_kernel.cu", "other": other_src}
    built = build_all(jobs)
    for lib, _ in built.values():
        lib.mpc_fused_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.mpc_fused_launch.restype = ctypes.c_int
        lib.mpc_fused_shared_bytes.argtypes = [ctypes.c_int] * 5
        lib.mpc_fused_shared_bytes.restype = ctypes.c_int

    specs = {QUAD_3D: make_spec(QUAD_3D), VTOL_2D: make_spec(VTOL_2D),
             DYNAMIC_UNICYCLE_2D: make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5),
             SINGLE_INTEGRATOR_2D: make_spec(SINGLE_INTEGRATOR_2D),
             DOUBLE_INTEGRATOR_2D: make_spec(DOUBLE_INTEGRATOR_2D)}
    cfgs = {QUAD_3D: mpc_cbf.MPCConfig(horizon=10, num_obs=5),
            VTOL_2D: mpc_cbf.MPCConfig(horizon=16, num_obs=5),
            DYNAMIC_UNICYCLE_2D: mpc_cbf.MPCConfig(horizon=8, num_obs=5),
            SINGLE_INTEGRATOR_2D: mpc_cbf.MPCConfig(horizon=10, num_obs=5),
            DOUBLE_INTEGRATOR_2D: mpc_cbf.MPCConfig(horizon=10, num_obs=5)}

    def threads_of(lib, model):
        if hasattr(lib, "mpc_fused_threads"):
            return lib.mpc_fused_threads()
        M = cfgs[model].horizon * mf._problem(model, specs[model], cfgs[model]).m
        return 32 * ((M + 31) // 32)  # the first port's launch: 32 * ceil(M / 32)

    for name, (lib, report) in built.items():
        regs = "; ".join(f"{mdl}: {r}, {frame}" for mdl, r, frame in fused_ptxas(report))
        occ = []
        for model in (QUAD_3D, VTOL_2D):
            shape = mf._shape_args(model, specs[model], entry.DT, cfgs[model])
            smem = lib.mpc_fused_shared_bytes(*shape)
            threads = threads_of(lib, model)
            if hasattr(lib, "mpc_fused_blocks_per_sm"):
                lib.mpc_fused_blocks_per_sm.argtypes = [ctypes.c_int] * 5
                per_sm = lib.mpc_fused_blocks_per_sm(*shape)
            else:
                lib.ab_blocks_per_sm.argtypes = [ctypes.c_int] * 3
                per_sm = lib.ab_blocks_per_sm(shape[0], threads, smem)
            occ.append(f"{model} N={cfgs[model].horizon}: {threads} threads, {smem} bytes "
                       f"shared, {per_sm} blocks an SM")
        print(f"build {name} ({jobs[name]}): " + "; ".join(occ)
              + f"; ptxas: {regs}")

    # ---- problems ---------------------------------------------------------------
    rng = np.random.default_rng(11)
    problems = {}
    for b_ in sorted({b for mdl, b, _ in TIMED if mdl == QUAD_3D} | {4096}):
        problems[(QUAD_3D, b_)] = entry.build_fused_step(b_, device=dev)[1]
    problems[(DYNAMIC_UNICYCLE_2D, 4096)] = entry.build_step(4096, device=dev)[1]
    vb = 256
    v_xs = torch.as_tensor(np.concatenate(
        [rng.uniform(5, 10, (vb, 1)), rng.uniform(36, 40, (vb, 1)), rng.uniform(-0.1, 0.1, (vb, 1)),
         rng.uniform(10, 13, (vb, 1)), rng.uniform(-0.5, 0.5, (vb, 1)), np.zeros((vb, 1))], axis=1),
        dtype=torch.float32, device=dev)
    v_goal = torch.tensor([80.0, 40.0, 0, 0, 0, 0], device=dev).repeat(vb, 1)
    v_obs = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5, device=dev)[None].repeat(vb, 1, 1)
    problems[(VTOL_2D, vb)] = (v_xs, v_goal, v_obs, torch.zeros((vb, 4), device=dev),
                               torch.zeros((vb, 16, 4), device=dev))
    ib = 64
    two_obs = pad_obstacles([[2.5, 0.8, 0.4, 0, 0, 0, 0], [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]], 5,
                            device=dev)[None].repeat(ib, 1, 1)
    for model, nx in ((SINGLE_INTEGRATOR_2D, 2), (DOUBLE_INTEGRATOR_2D, 4)):
        i_xs = torch.as_tensor(np.concatenate(
            [rng.uniform(0, 3, (ib, 2)), rng.uniform(-0.5, 0.5, (ib, nx - 2))], axis=1),
            dtype=torch.float32, device=dev)
        i_goal = torch.zeros((ib, nx), device=dev)
        i_goal[:, :2] = torch.tensor([5.0, 1.0], device=dev)
        problems[(model, ib)] = (i_xs, i_goal, two_obs, torch.zeros((ib, 2), device=dev),
                                 torch.zeros((ib, 10, 2), device=dev))

    def launcher(lib, model, args):
        """A launch of ``lib`` as ``solve_fused_batch`` makes it; ``run()``
        launches, ``run.outs`` holds (U, xs, viol)."""
        sp, cf = specs[model], cfgs[model]
        pb = mf._problem(model, sp, cf)
        B, M = args[0].shape[0], pb.N * pb.m
        ins = [t.contiguous() for t in args[:4]]
        U0 = mf._warm_start(args[4]).reshape(B, M).contiguous()
        params = torch.tensor(mf.kernel_params(model, sp, entry.DT, cf), dtype=torch.float32,
                              device=dev)
        outs = [torch.empty((B, M), device=dev), torch.empty((B, (pb.N + 1) * pb.n), device=dev),
                torch.empty((B,), device=dev)]
        call = (mf.MODEL_IDS[model], *(t.data_ptr() for t in ins), U0.data_ptr(),
                params.data_ptr(), *(t.data_ptr() for t in outs), B, pb.N, pb.K,
                len(pb.bounded), params.numel(), cf.outer_iters, cf.newton_iters,
                torch.cuda.current_stream().cuda_stream)

        def run():
            err = lib.mpc_fused_launch(*call)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")
        run.tensors = ins + [U0, params]  # alive as long as the launches that read them
        run.outs = outs
        return run

    # ---- bits and the envelope ----------------------------------------------------
    failed = False
    for (model, B), args in problems.items():
        if (model, B) in ((QUAD_3D, 1), (QUAD_3D, 396), (QUAD_3D, 16384)):
            continue
        B = args[0].shape[0]
        runs = {name: launcher(lib, model, args) for name, (lib, _) in built.items()}
        for run in runs.values():
            run()
        k = min(N_PLAIN, B)
        plain = mf.solve_fused_batch_reference(model, specs[model], *(t[:k] for t in args),
                                               entry.DT, cfgs[model])
        torch.cuda.synchronize()
        this = runs["this"].outs
        same = all(torch.equal(a, b) for a, b in zip(this, runs["other"].outs))
        du = (this[0][:k] - plain.U.reshape(k, -1)).abs().max().item()
        dxs = (this[1][:k] - plain.xs.reshape(k, -1)).abs().max().item()
        dv = (this[2][:k] - plain.viol).abs().max().item()
        plain_same = torch.equal(this[0][:k], plain.U.reshape(k, -1)) and torch.equal(
            this[1][:k], plain.xs.reshape(k, -1)) and torch.equal(this[2][:k], plain.viol)
        print(f"{model} N={cfgs[model].horizon} B={B}: this vs other bit-identical {same}; "
              f"this vs plain (first {k}) max|du| {du:.3e}, max|dxs| {dxs:.3e}, "
              f"max|dviol| {dv:.3e}, bit-identical {plain_same}")
        failed |= not (du < U_TOL and dxs < U_TOL and dv <= VIOL_TOL)

    # ---- times, in turns ----------------------------------------------------------
    for model, B, reps in TIMED:
        runs = {name: launcher(lib, model, problems[(model, B)])
                for name, (lib, _) in built.items()}
        for run in runs.values():
            run()
        ms = [(name, sync_time(runs[name], reps)) for name in ("other", "this", "this", "other")]
        print(f"[{card}] {model} N={cfgs[model].horizon} B={B}: "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms))
    if failed:
        raise SystemExit("fused_kernel_ab: this kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
