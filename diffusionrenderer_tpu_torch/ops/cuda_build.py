"""Build the hand-written CUDA kernels on first use and load them with ctypes.

Each source in `csrc/` becomes its own shared library with a plain C
interface, compiled by `nvcc` for `sm_90a` into
`build/torch_kernels/<hash of that source, the shared headers and the
flags>/`, so editing one source rebuilds only that one.  `build_all()` starts one `nvcc` per source,
all together, and waits for them.  Nothing here runs at import time: the CPU
tests import every module and have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("flash_attention", "quant_matmul", "flash_attention_int8", "flash_attention_wgmma",
           "dit_fused")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# Seconds of nvcc per source built by this process.
build_seconds: Dict[str, float] = {}


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


def _source(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; expected one of {SOURCES}")
    return CSRC / f"{name}.cu"


def _build_dir(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # included by some sources
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return _build_dir(name) / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source: (process, tmp path, start time)."""
    out = _build_dir(name)
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, proc, tmp: Path, t0: float) -> None:
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    (_build_dir(name) / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))


def build_all() -> None:
    """Compile every source not yet built, one nvcc each, all started at once.
    Raises RuntimeError with the compiler's output if any fails."""
    started = {n: _start(n) for n in SOURCES if not _lib_path(n).exists()}
    failures = []
    for name, job in started.items():
        try:
            _finish(name, *job)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))


def library(name: str) -> ctypes.CDLL:
    """Compile (if not yet built) and load the library of csrc/<name>.cu."""
    if name not in _libs:
        if not _lib_path(name).exists():
            _finish(name, *_start(name))
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return _libs[name]


def build_log(name: str) -> str:
    """The compiler output of one source (ptxas register and spill report)."""
    path = _build_dir(name) / f"{name}.log"
    return path.read_text() if path.exists() else ""
