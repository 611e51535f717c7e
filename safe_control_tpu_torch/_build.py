"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point, compiled for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of the
checkout.  The library's file name carries a hash of the sources (the
``.cu``, the ``.cu`` files it includes, and every ``csrc/*.h``) and the
compiler flags, so a changed source builds anew at first use and an
unchanged one loads from disk.  ``build_sources`` builds another tree's
kernels the same way (the A/B scripts at the root of the checkout).

No ``--use_fast_math``: the kernels' numerics assume IEEE ``cosf``,
``sinf``, ``powf``, ``sqrtf``, ``floorf`` and division.  ``-fmad=false``
keeps the compiler from contracting a multiply and an add into one rounding,
so a kernel rounds as its plain PyTorch version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

# name -> loaded library, and name -> what the build did (path, seconds,
# whether it came from disk, the compiler's register/spill report).
_LIBS: dict = {}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(source: Path) -> Path:
    """The library of ``source``, a ``.cu`` file: named by a hash of the
    compiler flags, the source, the ``.cu`` files it includes and every
    ``*.h`` beside it, so that two trees of different sources never share a
    path (a second ``dlopen`` of a path returns the first library).  The
    package's ``csrc/`` builds into ``BUILD_DIR``, any other tree into
    ``BUILD_DIR / "ab"``, so that a tree held against the package's loads
    its own library even where the sources are the same."""
    # Every *.h enters every kernel's hash, so a changed or new header
    # rebuilds all kernels once; that costs a build, never a wrong library.
    # (Headers are named *.h for that reason, and so ship as package data.)
    csrc = source.parent
    included = re.findall(r'^#include "(\w+\.cu)"', source.read_text(), flags=re.M)
    deps = [source] + [csrc / f for f in included] + sorted(csrc.glob("*.h"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in deps:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out_dir = BUILD_DIR if csrc.resolve() == _CSRC else BUILD_DIR / "ab"
    return out_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build_sources(sources) -> dict:
    """Compile each ``.cu`` file of ``sources`` (its headers beside it) into
    its library (see :func:`_library_path`), one nvcc process per source,
    all started together; a library already on disk is loaded from there.
    Returns source -> dict(path, seconds, cached, ptxas): the library, the
    build's seconds (0 from disk), and the compiler's register/spill report
    (from disk, the report of the build that made it)."""
    built, running = {}, {}
    for source in sources:
        out = _library_path(source)
        if out.exists():
            log = out.with_suffix(".log")
            built[source] = dict(path=str(out), seconds=0.0, cached=True,
                                 ptxas=log.read_text() if log.exists() else "")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(source.parent), "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[source] = (proc, out, tmp, time.perf_counter())
    failures = []
    for source, (proc, out, tmp, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building {source}:\n"
                            f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        report = (stdout + stderr).strip()
        out.with_suffix(".log").write_text(report + "\n")
        built[source] = dict(path=str(out), seconds=seconds, cached=False, ptxas=report)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/lib<name>-<hash>.so``
    for each name (see :func:`build_sources`); name -> library path."""
    built = build_sources([_CSRC / f"{name}.cu" for name in names])
    for name in names:
        info = built[_CSRC / f"{name}.cu"]
        if not info["cached"] or BUILD_INFO.get(name, {}).get("path") != info["path"]:
            BUILD_INFO[name] = info  # a load from disk keeps this process's build
    return {name: Path(BUILD_INFO[name]["path"]) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (see :func:`build_all`)."""
    return build_all([name])[name]


def load_mpc_du_kernel() -> ctypes.CDLL:
    """The fused DU MPC kernel library, built at first use."""
    lib = _LIBS.get("mpc_du_kernel")
    if lib is None:
        lib = ctypes.CDLL(str(build("mpc_du_kernel")))
        lib.mpc_du_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_float] * 8
            + [ctypes.c_void_p]
        )
        lib.mpc_du_launch.restype = ctypes.c_int
        _LIBS["mpc_du_kernel"] = lib
    return lib


def load_qp_admm_kernel() -> ctypes.CDLL:
    """The batched QP ADMM kernel library, built at first use."""
    lib = _LIBS.get("qp_admm_kernel")
    if lib is None:
        lib = ctypes.CDLL(str(build("qp_admm_kernel")))
        lib.qp_admm_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
            + [ctypes.c_void_p]
        )
        lib.qp_admm_launch.restype = ctypes.c_int
        lib.qp_admm_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.qp_admm_shape.restype = None
        _LIBS["qp_admm_kernel"] = lib
    return lib


def load_qp_finish_kernel() -> ctypes.CDLL:
    """The batched QP finish kernel library, built at first use."""
    lib = _LIBS.get("qp_finish_kernel")
    if lib is None:
        lib = bind_qp_finish(ctypes.CDLL(str(build("qp_finish_kernel"))))
        _LIBS["qp_finish_kernel"] = lib
    return lib


def bind_qp_finish(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/qp_finish_kernel.cu``, with its entry
    points' argument and result types declared."""
    lib.qp_finish_launch.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    lib.qp_finish_launch.restype = ctypes.c_int
    lib.qp_finish_workspace.argtypes = [ctypes.c_int] * 3
    lib.qp_finish_workspace.restype = ctypes.c_longlong
    return lib


def load_mpc_fused_kernel(clock: bool = False) -> ctypes.CDLL:
    """The generic fused MPC kernel library, or with ``clock`` the library
    of its instantiations with the phase clock (``csrc/mpc_fused_clock.cu``;
    its launch takes the clock's buffer).  Both are built at the first use
    of either, so that no build falls inside a traced run, and the clock's
    kernels are loaded on the device then."""
    name = "mpc_fused_clock" if clock else "mpc_fused_kernel"
    if name not in _LIBS:
        paths = build_all(["mpc_fused_kernel", "mpc_fused_clock"])
        for key, path in paths.items():
            lib = ctypes.CDLL(str(path))
            lib.mpc_fused_launch.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            )
            lib.mpc_fused_launch.restype = ctypes.c_int
            for fn in (lib.mpc_fused_shared_bytes, lib.mpc_fused_blocks_per_sm,
                       lib.mpc_fused_workspace_floats, lib.mpc_fused_block_threads):
                fn.argtypes = [ctypes.c_int] * 5
                fn.restype = ctypes.c_int
            for fn in (lib.mpc_fused_threads, lib.mpc_fused_trace_fields,
                       lib.mpc_fused_trace_slots, lib.mpc_fused_load):
                fn.restype = ctypes.c_int
            _LIBS[key] = lib
        err = _LIBS["mpc_fused_clock"].mpc_fused_load()
        if err != 0:
            raise RuntimeError(f"loading the fused kernel's clocked instantiations: CUDA error "
                               f"{err}")
    return _LIBS[name]
