"""Host-side HDR image I/O with the port's own native codec (counterpart of
diffusionrenderer_tpu/io.py and diffusionrenderer_tpu/native/rgbe.py).

`csrc/hdr_codec.cc` (Radiance RGBE .hdr read and write, PFM read) and
`csrc/exr_codec.cc` (scanline OpenEXR read, ZIP half-float write; links
zlib) are built on first use with the host C++ compiler into
`build/native/<hash of the sources and flags>/` and bound with ctypes.
`load_hdr_file` tries, in order: the native codec (.hdr, .pfm, .exr), then
imageio, then OpenCV, both imported only when reached.  Images are float32
(H, W, 3); uint8 and uint16 inputs are normalized to [0, 1].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hdr_codec.cc", "exr_codec.cc")
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdrt_codec.so"


def _build(path: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++, c++ or $CXX): the HDR codec is "
                           "built from csrc/ on first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / n) for n in SOURCES),
                          "-lz"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the HDR codec failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)


def codec() -> ctypes.CDLL:
    """The native codec library, built if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        pint = ctypes.POINTER(ctypes.c_int)
        for fn in (lib.rgbe_read, lib.exr_read):
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp), pint, pint]
            fn.restype = ctypes.c_int
        for fn in (lib.rgbe_write, lib.exr_write):
            fn.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.pfm_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp), pint, pint, pint]
        lib.pfm_read.restype = ctypes.c_int
        lib.drtpu_free.argtypes = [fp]
        lib.drtpu_free.restype = None
        _lib = lib
        return lib


def _take(lib, buf, h: int, w: int, c: int) -> np.ndarray:
    """Copy a codec-allocated float buffer into numpy and free it."""
    try:
        return np.ctypeslib.as_array(buf, shape=(h * w * c,)).copy().reshape(h, w, c)
    finally:
        lib.drtpu_free(buf)


def native_read(path: str) -> np.ndarray:
    """Read .hdr (RGBE), .pfm or .exr (scanline OpenEXR) with the native
    codec: float32 (H, W, 3); raises ValueError on a file it cannot read."""
    lib = codec()
    buf = ctypes.POINTER(ctypes.c_float)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    low = path.lower()
    if low.endswith(".pfm"):
        rc = lib.pfm_read(path.encode(), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c))
        what = "pfm_read"
    else:
        fn = lib.exr_read if low.endswith(".exr") else lib.rgbe_read
        rc = fn(path.encode(), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h))
        c.value, what = 3, fn.__name__
    if rc != 0:
        raise ValueError(f"{what} failed (code {rc}) for {path}")
    arr = _take(lib, buf, h.value, w.value, c.value)
    return np.repeat(arr, 3, axis=-1) if c.value == 1 else arr


def _write(fn_name: str, path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected a float (H, W, 3) image, got shape {img.shape}")
    h, w, _ = img.shape
    fn = getattr(codec(), fn_name)
    rc = fn(path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h)
    if rc != 0:
        raise ValueError(f"{fn_name} failed (code {rc}) for {path}")


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write float32 (H, W, 3) as a Radiance .hdr file (RGBE: one shared
    exponent per pixel, 8-bit mantissas)."""
    _write("rgbe_write", path, img)


def save_exr(path: str, img: np.ndarray) -> None:
    """Write float32 (H, W, 3) as a ZIP-compressed half-float OpenEXR file."""
    _write("exr_write", path, img)


def _imageio_load(path: str) -> Optional[np.ndarray]:
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(path))
    except (ImportError, OSError, ValueError, RuntimeError):
        return None


def _cv2_load(path: str) -> Optional[np.ndarray]:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError:
        return None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_hdr_file(path: str) -> np.ndarray:
    """Load .hdr / .exr / .pfm / common formats to float32 (H, W, 3)."""
    img = None
    if path.lower().endswith((".hdr", ".pfm", ".exr")):
        try:
            img = native_read(path)
        except (RuntimeError, ValueError, OSError):
            img = None
    if img is None:
        img = _imageio_load(path)
    if img is None:
        img = _cv2_load(path)
    if img is None:
        raise ValueError(f"All loading methods failed for {path}")

    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[..., :3]
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def load_hdr_image(path: str) -> np.ndarray:
    """(1, H, W, 3) float32, values may exceed 1 (the LoadHDRImage node)."""
    return load_hdr_file(path)[None]
