"""Host-side image I/O: HDR through the port's own native codec
(counterpart of diffusionrenderer_tpu/io.py and
diffusionrenderer_tpu/native/rgbe.py), PNG through a codec of its own, and
the CLI's frame loaders (counterparts of diffusionrenderer_tpu/cli.py
_load_image, _load_video, _save_frames).

`csrc/hdr_codec.cc` (Radiance RGBE .hdr read and write, PFM read) and
`csrc/exr_codec.cc` (scanline OpenEXR read, ZIP half-float write; links
zlib) are built on first use with the host C++ compiler into
`build/native/<hash of the sources and flags>/` and bound with ctypes.
`load_hdr_file` tries, in order: the native codec (.hdr, .pfm, .exr), then
imageio, then OpenCV, both imported only when reached.  Images are float32
(H, W, 3); uint8 and uint16 inputs are normalized to [0, 1].

`read_png` / `write_png` need nothing beyond zlib, struct and numpy (the
card's machine has neither imageio nor Pillow): 8- and 16-bit,
non-interlaced PNGs of colour types 0, 2, 4 and 6 are read, 8-bit gray and
RGB are written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import List, Optional

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


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels: gray, RGB, gray + alpha, RGBA (3, a palette, is
# refused).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunks(path: str, data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(path: str, raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8.  None, Sub and Up are
    whole-row numpy operations; Average and Paeth depend on the byte just
    reconstructed to their left, so they run byte by byte."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # Sub: a running sum per byte lane (mod 256).
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur_b = bytearray(stride)
            src, up = line.tobytes(), prior.tobytes()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur_b[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {ftype} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file as numpy: (H, W) for gray, (H, W, C) otherwise; uint8 or
    uint16 as stored.  Reads 8- and 16-bit non-interlaced files of colour
    types 0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA); refuses the
    others (palettes, interlacing, depths below 8) with a ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _png_chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not supported; "
                         "the reader takes colour types 0, 2, 4 and 6 (gray, RGB, "
                         "gray + alpha, RGBA)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported; the reader "
                         "takes 8- and 16-bit samples")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported; the reader "
                         "takes non-interlaced files only")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown PNG compression {compression} or "
                         f"filter method {filtering}")
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    rows = _unfilter(path, zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    arr = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    arr = arr.reshape(h, w, channels)
    return arr[..., 0] if channels == 1 else arr


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W) or (H, W, 1) gray, or (H, W, 3) RGB, as a PNG
    (every row Sub-filtered, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, channels = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        ctype, channels = 2, 3
    else:
        raise ValueError(f"write_png takes (H, W) gray or (H, W, 3) RGB, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, w * channels)
    sub = rows.copy()
    sub[:, channels:] -= rows[:, :-channels]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# The CLI's frames
# ---------------------------------------------------------------------------

def _imageio():
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError("this image format needs imageio, which is not installed; "
                           "PNG (.png) and HDR (.hdr, .exr, .pfm) files are read and "
                           "written without it") from e
    return iio


def load_image(path: str) -> np.ndarray:
    """Any image -> (H, W, 3): uint8 sources stay uint8 (uploaded raw and
    range-mapped on the device), uint16 ones become float32 in [0, 1], HDR
    files (.hdr, .exr, .pfm) float32 through load_hdr_file.  Gray is
    repeated to 3 channels and alpha dropped.  PNG is read by read_png;
    other LDR formats need imageio."""
    if path.lower().endswith((".hdr", ".exr", ".pfm")):
        return load_hdr_file(path)
    img = read_png(path) if path.lower().endswith(".png") else np.asarray(_imageio().imread(path))
    if img.ndim == 3 and img.shape[-1] in (1, 2):
        img = img[..., 0]  # gray, or gray + alpha
    img = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., :3]
    if img.dtype == np.uint8:
        return img
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def load_video(paths: List[str]) -> np.ndarray:
    """Frame paths -> (1, T, H, W, 3): uint8 when every frame is uint8,
    float32 in [0, 1] otherwise (uint8 frames rescaled, so mixed formats
    share one range)."""
    frames = [load_image(p) for p in paths]
    if not all(f.dtype == np.uint8 for f in frames):
        frames = [f.astype(np.float32) / 255.0 if f.dtype == np.uint8 else f for f in frames]
    return np.stack(frames)[None]


def _write_ldr(path: str, frame: np.ndarray) -> None:
    if path.lower().endswith(".png"):
        write_png(path, frame)
    else:
        _imageio().imwrite(path, frame)


def save_frames(arr: np.ndarray, out: str) -> None:
    """(N, H, W, C) in [0, 1] -> 8-bit image file(s): `out` for one frame,
    else <base>_0000<ext>, <base>_0001<ext>, ..."""
    arr8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr8.shape[0] == 1:
        _write_ldr(out, arr8[0])
        print(f"wrote {out}")
    else:
        base, ext = os.path.splitext(out)
        for i, frame in enumerate(arr8):
            _write_ldr(f"{base}_{i:04d}{ext or '.png'}", frame)
        print(f"wrote {arr8.shape[0]} frames to {base}_*{ext or '.png'}")
