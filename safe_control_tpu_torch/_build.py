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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/lib<name>-<hash>.so``."""
    source = _CSRC / f"{name}.cu"
    deps = [source] + sorted(_CSRC.glob("*.h"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in deps:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO[name] = dict(path=str(out), seconds=0.0, cached=True, ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    report = (proc.stdout + proc.stderr).strip()
    out.with_suffix(".log").write_text(report + "\n")
    BUILD_INFO[name] = dict(path=str(out), seconds=seconds, cached=False, ptxas=report)
    return out


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
