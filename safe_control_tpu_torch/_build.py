"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point, compiled for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of the
checkout.  The library's file name carries a hash of the sources (the
``.cu`` and every ``csrc/*.h``) and the compiler flags, so a changed source
builds anew at first use and an unchanged one loads from disk.

No ``--use_fast_math``: the kernels' numerics assume IEEE ``cosf``,
``sinf``, ``powf``, ``sqrtf``, ``floorf`` and division.  ``-fmad=false``
keeps the compiler from contracting a multiply and an add into one rounding,
so a kernel rounds as its plain PyTorch version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def _library_path(name: str) -> Path:
    # Every csrc/*.h enters every kernel's hash, so a changed or new header
    # rebuilds all kernels once; that costs a build, never a wrong library.
    # (Headers are named *.h for that reason, and so ship as package data.)
    source = _CSRC / f"{name}.cu"
    deps = [source] + sorted(_CSRC.glob("*.h"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in deps:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/lib<name>-<hash>.so``
    for each name, one nvcc process per source, all started together."""
    outs, running = {}, {}
    for name in names:
        out = outs[name] = _library_path(name)
        if out.exists():
            if BUILD_INFO.get(name, {}).get("path") != str(out):  # keep this process's build
                log = out.with_suffix(".log")  # the report of the build that made it
                BUILD_INFO[name] = dict(path=str(out), seconds=0.0, cached=True,
                                        ptxas=log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        source = _CSRC / f"{name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                            f"{stdout}\n{stderr}")
            continue
        out = outs[name]
        os.replace(tmp, out)
        report = (stdout + stderr).strip()
        out.with_suffix(".log").write_text(report + "\n")
        BUILD_INFO[name] = dict(path=str(out), seconds=seconds, cached=False, ptxas=report)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


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
        _LIBS["qp_admm_kernel"] = lib
    return lib


def load_mpc_fused_kernel() -> ctypes.CDLL:
    """The generic fused MPC kernel library, built at first use."""
    lib = _LIBS.get("mpc_fused_kernel")
    if lib is None:
        lib = ctypes.CDLL(str(build("mpc_fused_kernel")))
        lib.mpc_fused_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.mpc_fused_launch.restype = ctypes.c_int
        for fn in (lib.mpc_fused_shared_bytes, lib.mpc_fused_blocks_per_sm):
            fn.argtypes = [ctypes.c_int] * 5
            fn.restype = ctypes.c_int
        lib.mpc_fused_threads.restype = ctypes.c_int
        _LIBS["mpc_fused_kernel"] = lib
    return lib
