"""Hold two builds of the generic fused MPC-CBF kernel against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 fused_kernel_ab.py OTHER_DIR

``OTHER_DIR`` holds another ``mpc_fused_kernel.cu`` with the same C entry
points (``mpc_fused_launch``, ``mpc_fused_shared_bytes``) and its headers,
for example an earlier commit's ``safe_control_tpu_torch/csrc`` unpacked
with ``git archive`` into the ignored ``build/`` directory, or a copy of
this one with another launch shape or a part of the Newton step changed.

The script builds the package's kernel (``csrc/mpc_fused_kernel.cu``) and
the other one through ``_build`` (each library named by its tree's
sources), both at once, and prints each build's library and its ptxas
report per instantiation, and its threads a block, shared
bytes and blocks an SM (the CUDA occupancy calculator) at Quad3D N=10,
VTOL2D N=16 and each model of M <= 32 at N=10 (this build runs those in
one warp).  It compares the two builds' SASS (``cuobjdump -sass``) of each
instantiation that both have, by model, layout and threads a block (a build
without the threads argument has 128), and prints which differ.  On the
problems of
``chip_smoke.py``'s phase 10 (Quad3D N=10 at B=4096, cold start;
DynamicUnicycle2D N=8 at B=4096; VTOL2D N=16 at B=256; SingleIntegrator2D
and DoubleIntegrator2D N=10 at B=64) it reports whether each build gives the
package's bits, and holds the package's build to its plain PyTorch version
on the first 64 problems of each (max |du| and |dxs| < 5e-3, viol atol
1e-3; bits reported).  Then it times both launches with CUDA events, in
turns (other, this, this, other), at Quad3D N=10 B = 1, 396, 4096 and 16384 and VTOL2D N=16 B=256, beside the
card's name and power limit.  A build with a global workspace
(``mpc_fused_workspace_floats``: decision widths past a block's shared
memory) is launched with one; where both builds have it, they are also held
to each other and timed on the RTI budget at B=64 at VTOL2D N=30 (M=120,
Jc in the workspace), Quad3D N=30 and DynamicUnicycle2D N=64 (M=120 and
128, Jr and Jc there), and where only this one has it, this one is held
to its plain version and timed there alone.  At the benchmark cells' shape
(DynamicUnicycle2D N=10 at B=1 and 4096) it also runs this build with its
phase clock on (``csrc/mpc_fused_clock.cu``, built beside it): the same
bits, the totals tiling each block's cycles, the phases' shares, and the
times of the three in turns (other, this, this with the clock, the clock,
this, other; three rounds); and the two builds in turns at B = 17, 132,
264, 660, 1320 and 1848 (waves of 128-thread and of one-warp blocks).  The
other models of M <= 32 at N=10
(Unicycle2D, KinematicBicycle2D and its C3BF and DPCBF variants, Quad2D,
and with unit cost weights Manipulator2D, DynamicBicycle2D and
DriftingCar), on ``entry.build_fused_step``'s starts: whether the two
builds give the same bits at B=1, 17 and 4096, this build against its plain
version on the first 64 (envelope gated), and both timed in turns at B=1
and B=4096.  Exits non-zero when
a check fails or there is no card.
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
# The models of M <= 32 at N=10 besides DynamicUnicycle2D and the integrators.
NARROW_MODELS = ("Unicycle2D", "KinematicBicycle2D", "KinematicBicycle2D_C3BF",
                 "KinematicBicycle2D_DPCBF", "Quad2D", "Manipulator2D", "DynamicBicycle2D",
                 "DriftingCar")

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


def sass(lib_path) -> dict:
    """``chip_smoke.fused_instantiation`` of each fused kernel in the
    library -> its SASS lines (``cuobjdump -sass``, beside nvcc)."""
    from chip_smoke import fused_instantiation
    from safe_control_tpu_torch import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, key = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            key = fused_instantiation(name) if "mpc_fused_kernel" in name else None
            if key is not None:
                funcs[key] = []
        elif key is not None and ln.strip().startswith("/*"):
            funcs[key].append(ln.strip())
    return funcs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_kernel_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import numpy as np

    from chip_smoke import UnitWeights, card_line, fused_ptxas, sync_time
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
    sources = {"this": csrc / "mpc_fused_kernel.cu", "other": other_src,
               "clock": csrc / "mpc_fused_clock.cu"}
    infos = _build.build_sources(sources.values())  # one nvcc each, all started together
    built = {}
    for name, source in sources.items():
        lib = ctypes.CDLL(infos[source]["path"])
        lib.path = infos[source]["path"]
        built[name] = (lib, infos[source]["ptxas"])
        lib.wide = hasattr(lib, "mpc_fused_workspace_floats")  # the launch takes a workspace
        lib.traced = hasattr(lib, "mpc_fused_trace_fields")  # and the phase clock's buffer
        lib.mpc_fused_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * (9 + lib.wide + lib.traced)
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.mpc_fused_launch.restype = ctypes.c_int
        for fn in [lib.mpc_fused_shared_bytes] + ([lib.mpc_fused_workspace_floats]
                                                  if lib.wide else []):
            fn.argtypes = [ctypes.c_int] * 5
            fn.restype = ctypes.c_int
    clock_lib, clock_report = built.pop("clock")  # this build's clocked instantiations

    specs = {QUAD_3D: make_spec(QUAD_3D), VTOL_2D: make_spec(VTOL_2D),
             DYNAMIC_UNICYCLE_2D: make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5),
             SINGLE_INTEGRATOR_2D: make_spec(SINGLE_INTEGRATOR_2D),
             DOUBLE_INTEGRATOR_2D: make_spec(DOUBLE_INTEGRATOR_2D)}
    cfgs = {QUAD_3D: mpc_cbf.MPCConfig(horizon=10, num_obs=5),
            VTOL_2D: mpc_cbf.MPCConfig(horizon=16, num_obs=5),
            DYNAMIC_UNICYCLE_2D: mpc_cbf.MPCConfig(horizon=8, num_obs=5),
            SINGLE_INTEGRATOR_2D: mpc_cbf.MPCConfig(horizon=10, num_obs=5),
            DOUBLE_INTEGRATOR_2D: mpc_cbf.MPCConfig(horizon=10, num_obs=5)}

    specs.update({model: make_spec(model) for model in NARROW_MODELS})
    narrow_cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    reported = [(QUAD_3D, cfgs[QUAD_3D]), (VTOL_2D, cfgs[VTOL_2D]),
                (DYNAMIC_UNICYCLE_2D, narrow_cfg)] + [(m, narrow_cfg) for m in NARROW_MODELS]

    def threads_of(lib, model, cf):
        if hasattr(lib, "mpc_fused_block_threads"):
            lib.mpc_fused_block_threads.argtypes = [ctypes.c_int] * 5
            return lib.mpc_fused_block_threads(*mf._shape_args(model, specs[model], entry.DT, cf))
        if hasattr(lib, "mpc_fused_threads"):
            return lib.mpc_fused_threads()
        M = cf.horizon * mf._problem(model, specs[model], cf).m
        return 32 * ((M + 31) // 32)  # the first port's launch: 32 * ceil(M / 32)

    def ptxas_line(report, clock=False):
        return "; ".join(f"{mdl}{' (wide)' if wide else ''} {threads} threads: {r}, {frame}"
                         for mdl, wide, threads, r, frame in fused_ptxas(report, clock=clock))

    with UnitWeights():  # to size Manipulator2D's and the drift models' parameter blocks
        for name, (lib, report) in built.items():
            occ = []
            for model, cf in reported:
                shape = mf._shape_args(model, specs[model], entry.DT, cf)
                smem = lib.mpc_fused_shared_bytes(*shape)
                threads = threads_of(lib, model, cf)
                if hasattr(lib, "mpc_fused_blocks_per_sm"):
                    lib.mpc_fused_blocks_per_sm.argtypes = [ctypes.c_int] * 5
                    per_sm = lib.mpc_fused_blocks_per_sm(*shape)
                else:
                    lib.ab_blocks_per_sm.argtypes = [ctypes.c_int] * 3
                    per_sm = lib.ab_blocks_per_sm(shape[0], threads, smem)
                occ.append(f"{model} N={cf.horizon}: {threads} threads, {smem} bytes "
                           f"shared, {per_sm} blocks an SM")
            print(f"build {name} ({lib.path}): " + "; ".join(occ)
                  + f"; ptxas: {ptxas_line(report)}")
    print(f"build clock ({clock_lib.path}): ptxas: {ptxas_line(clock_report, clock=True)}")
    this_sass, other_sass = sass(built["this"][0].path), sass(built["other"][0].path)
    both = sorted(set(this_sass) & set(other_sass))
    differ = [k for k in both if this_sass[k] != other_sass[k]]
    print(f"SASS, this against other: {len(both) - len(differ)} of {len(both)} instantiations "
          f"both builds have are identical; differ: "
          + (", ".join(f"{mdl}{' (wide)' if wide else ''} {threads} threads"
                       for mdl, wide, threads, _ in differ) or "none")
          + "; only this: " + (", ".join(f"{mdl}{' (wide)' if wide else ''} {threads} threads"
                                         for mdl, wide, threads, _ in
                                         sorted(set(this_sass) - set(other_sass))) or "none"))

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

    def launcher(lib, model, args, cf=None, clock=None):
        """A launch of ``lib`` as ``solve_fused_batch`` makes it; ``run()``
        launches, ``run.outs`` holds (U, xs, viol).  ``clock``: the phase
        clock's buffer (a build that has one), or none."""
        sp, cf = specs[model], cf or cfgs[model]
        pb = mf._problem(model, sp, cf)
        B, M = args[0].shape[0], pb.N * pb.m
        ins = [t.contiguous() for t in args[:4]]
        U0 = mf._warm_start(args[4]).reshape(B, M).contiguous()
        params = torch.tensor(mf.kernel_params(model, sp, entry.DT, cf), dtype=torch.float32,
                              device=dev)
        outs = [torch.empty((B, M), device=dev), torch.empty((B, (pb.N + 1) * pb.n), device=dev),
                torch.empty((B,), device=dev)]
        shape = (mf.MODEL_IDS[model], pb.N, pb.K, len(pb.bounded), params.numel())
        ws_floats = lib.mpc_fused_workspace_floats(*shape) if lib.wide else 0
        ws = torch.empty((B * ws_floats,), device=dev)
        call = (shape[0], *(t.data_ptr() for t in ins), U0.data_ptr(), params.data_ptr(),
                *(t.data_ptr() for t in outs), *([ws.data_ptr() or None] if lib.wide else []),
                *([None if clock is None else clock.data_ptr()] if lib.traced else []),
                B, *shape[1:], cf.outer_iters, cf.newton_iters,
                torch.cuda.current_stream().cuda_stream)

        def run():
            err = lib.mpc_fused_launch(*call)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")
        run.tensors = ins + [U0, params, ws, clock]  # alive as long as the launches reading them
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

    # ---- the benchmark cells' shape, DynamicUnicycle2D N=10 (M=20) at B=1 and 4096:
    # with the phase clock off, other against this; this with the clock on ("clock")
    # against off, its totals' tiling and Newton steps ----------------------------------
    du10 = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    totals = torch.zeros((clock_lib.mpc_fused_trace_slots(), clock_lib.mpc_fused_trace_fields()),
                         dtype=torch.int64, device=dev)
    k = len(mf.PHASES)
    for B, reps in ((1, 50), (4096, 10)):
        args = entry.build_fused_step(B, model_name=DYNAMIC_UNICYCLE_2D, horizon=10,
                                      device=dev)[1]
        runs = {name: launcher(lib_, DYNAMIC_UNICYCLE_2D, args, du10)
                for name, (lib_, _) in built.items()}
        runs["clock"] = launcher(clock_lib, DYNAMIC_UNICYCLE_2D, args, du10, clock=totals)
        totals.zero_()
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        same = {name: all(torch.equal(a, b) for a, b in zip(runs["this"].outs, run.outs))
                for name, run in runs.items() if name != "this"}
        t = totals[:B].cpu()
        tiled = bool(torch.equal(t[:, :k].sum(1), t[:, 2 * k + 1]))
        share = {p: float(t[:, i].sum() / t[:, 2 * k + 1].sum()) for i, p in enumerate(mf.PHASES)}
        print(f"DU N=10 B={B}: this vs other bit-identical {same['other']}, clock on vs off "
              f"{same['clock']}; clock totals tile the blocks {tiled}, Newton steps a problem "
              f"{t[:, k + 1].float().mean().item():.1f}, active rows a step "
              f"{t[:, 2 * k].sum().item() / max(t[:, k + 1].sum().item(), 1):.3f}; cycle shares "
              + ", ".join(f"{p} {100 * v:.2f}%" for p, v in share.items()))
        failed |= not (same["clock"] and tiled)
        order = ("other", "this", "clock", "clock", "this", "other") * 3
        ms = [(name, sync_time(runs[name], reps)) for name in order]
        print(f"[{card}] DU N=10 B={B}: " + ", ".join(f"{name} {t_:.4f} ms" for name, t_ in ms))
    # between them, other against this where a wave of either block width ends
    big = entry.build_fused_step(4096, model_name=DYNAMIC_UNICYCLE_2D, horizon=10, device=dev)[1]
    for B in (17, 132, 264, 660, 1320, 1848):
        args = tuple(t[:B].contiguous() for t in big)
        runs = {name: launcher(lib_, DYNAMIC_UNICYCLE_2D, args, du10)
                for name, (lib_, _) in built.items()}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(runs["this"].outs, runs["other"].outs))
        ms = [(name, sync_time(runs[name], 10)) for name in ("other", "this", "this", "other")]
        print(f"[{card}] DU N=10 B={B}: this vs other bit-identical {same}; "
              + ", ".join(f"{name} {t_:.4f} ms" for name, t_ in ms))

    # ---- the other models of M <= 32 at N=10 (one warp in this build): the two builds'
    # bits at B=1, 17 and 4096, this against its plain version on the first 64, and
    # times in turns at B=1 and 4096 ------------------------------------------------------
    def same_bits(outs_a, outs_b):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(outs_a, outs_b))

    with UnitWeights():
        for model in NARROW_MODELS:
            big = entry.build_fused_step(4096, model_name=model, horizon=10, device=dev)[1]
            for B, reps in ((1, 20), (17, 0), (4096, 5)):
                args = tuple(t[:B].contiguous() for t in big)
                runs = {name: launcher(lib, model, args, narrow_cfg)
                        for name, (lib, _) in built.items()}
                for run in runs.values():
                    run()
                torch.cuda.synchronize()
                this = runs["this"].outs
                line = (f"{model} N=10 B={B}: this vs other bit-identical "
                        f"{same_bits(this, runs['other'].outs)}")
                if B == 4096:
                    k = N_PLAIN
                    plain = mf.solve_fused_batch_reference(model, specs[model],
                                                           *(t[:k] for t in args), entry.DT,
                                                           narrow_cfg)
                    du = (this[0][:k] - plain.U.reshape(k, -1)).abs().max().item()
                    dxs = (this[1][:k] - plain.xs.reshape(k, -1)).abs().max().item()
                    dv = (this[2][:k] - plain.viol).abs().max().item()
                    want = (plain.U.reshape(k, -1), plain.xs.reshape(k, -1), plain.viol)
                    line += (f"; this vs plain (first {k}) max|du| {du:.3e}, max|dxs| "
                             f"{dxs:.3e}, max|dviol| {dv:.3e}, bit-identical "
                             f"{same_bits([t[:k] for t in this], want)}")
                    failed |= not (du < U_TOL and dxs < U_TOL and dv <= VIOL_TOL)
                print(line)
                if reps:
                    ms = [(name, sync_time(runs[name], reps))
                          for name in ("other", "this", "this", "other")]
                    print(f"[{card}] {model} N=10 B={B}: "
                          + ", ".join(f"{name} {t:.4f} ms" for name, t in ms))

    # ---- the wide layouts, the RTI budget, B=64: VTOL2D N=30 (Jc in the workspace),
    # Quad3D N=30 and DynamicUnicycle2D N=64 (M=128; Jr and Jc both there) -----------
    from chip_smoke import vtol_starts

    wide = [name for name, (lib, _) in built.items() if lib.wide]
    for model, N in ((VTOL_2D, 30), (QUAD_3D, 30), (DYNAMIC_UNICYCLE_2D, 64)):
        wide_cfg = mpc_cbf.MPCConfig.rti(horizon=N, num_obs=5)
        args = (vtol_starts(dev, 64) if model == VTOL_2D else
                entry.build_fused_step(64, model_name=model, horizon=N, device=dev)[1])
        runs = {name: launcher(built[name][0], model, args, wide_cfg) for name in wide}
        for run in runs.values():
            run()
        plain = mf.solve_fused_batch_reference(model, specs[model], *args, entry.DT, wide_cfg)
        torch.cuda.synchronize()
        this = runs["this"].outs
        same = (all(torch.equal(a, b) for a, b in zip(this, runs["other"].outs))
                if "other" in runs else "n/a (the other build has no workspace)")
        du = (this[0] - plain.U.reshape(64, -1)).abs().max().item()
        dxs = (this[1] - plain.xs.reshape(64, -1)).abs().max().item()
        dv = (this[2] - plain.viol).abs().max().item()
        plain_same = torch.equal(this[0], plain.U.reshape(64, -1)) and torch.equal(
            this[1], plain.xs.reshape(64, -1)) and torch.equal(this[2], plain.viol)
        ws = built["this"][0].mpc_fused_workspace_floats(
            *mf._shape_args(model, specs[model], entry.DT, wide_cfg))
        print(f"{model} N={N} RTI B=64 (M={N * mf._problem(model, specs[model], wide_cfg).m}, "
              f"workspace {ws} "
              f"floats a problem; built with it: {', '.join(wide)}): this vs other "
              f"bit-identical {same}; this vs plain max|du| {du:.3e}, max|dxs| {dxs:.3e}, "
              f"max|dviol| {dv:.3e}, bit-identical {plain_same}")
        failed |= not (du < U_TOL and dxs < U_TOL and dv <= VIOL_TOL)
        order = ("other", "this", "this", "other") if "other" in runs else ("this", "this")
        ms = [(name, sync_time(runs[name], 5)) for name in order]
        print(f"[{card}] {model} N={N} RTI B=64: "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms))
    if failed:
        raise SystemExit("fused_kernel_ab: this kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
