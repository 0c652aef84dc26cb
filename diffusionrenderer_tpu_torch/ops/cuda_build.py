"""Build the hand-written CUDA kernels on first use and load them with ctypes.

`csrc/flash_attention.cu` becomes a shared library with a plain C interface,
compiled by `nvcc` for `sm_90a` into
`build/torch_kernels/<hash of the source and flags>/`.  Nothing here runs at
import time: the CPU tests import every module and have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from source on first use")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Compile (if not yet built) and load the kernel library.  Raises
    RuntimeError with the compiler's output if the source fails to build."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = _build_dir()
    lib = out / f"lib{SOURCE.stem}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"lib{SOURCE.stem}.{os.getpid()}.tmp.so"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_seconds = time.perf_counter() - t0
        (out / f"{SOURCE.stem}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
        os.replace(tmp, lib)
    _lib = ctypes.CDLL(str(lib))
    return _lib


def build_log() -> str:
    """The compiler output (ptxas register and spill report)."""
    path = _build_dir() / f"{SOURCE.stem}.log"
    return path.read_text() if path.exists() else ""
