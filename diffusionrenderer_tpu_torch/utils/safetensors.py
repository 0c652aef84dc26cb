"""A reader and a writer of the safetensors format, with no dependency on
the `safetensors` package.

Layout: an 8-byte little-endian header length, a JSON header (padded with
spaces to a multiple of 8 bytes) mapping each name to its dtype, shape and
[begin, end) byte offsets relative to the end of the header, an optional
"__metadata__" map of strings, then the raw little-endian tensor bytes,
contiguous and without gaps.  Tensors are written in the library's order
(wider dtypes first, then by name), so each offset is a multiple of its
dtype's width and the data start is 8-byte aligned.

`SafetensorsFile` maps a file and hands out one tensor at a time, copied
to the requested device, so a checkpoint larger than host memory can be
streamed to the card; `write_safetensors` writes one tensor at a time from
any device and never holds the whole dict on the host.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike

_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _dtype_of(x: Any) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, np.asarray(x).dtype)).dtype


def _read_header(f, path: str) -> Tuple[Dict[str, Any], int, int]:
    """(header, data start, file size) of an open safetensors file."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
    (n,) = struct.unpack("<Q", head)
    size = os.fstat(f.fileno()).st_size
    if n > size - 8:
        raise ValueError(f"{path}: not a safetensors file (header length {n} "
                         f"exceeds the file)")
    try:
        header = json.loads(f.read(n))
    except UnicodeDecodeError as e:
        raise ValueError(f"{path}: not a safetensors file ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: not a safetensors file (header is not a map)")
    return header, 8 + n, size


def read_header(path: str) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, str]]:
    """(tensor entries, "__metadata__" map) of a safetensors file, reading
    the header alone.  Raises ValueError when `path` is not one."""
    with open(path, "rb") as f:
        header, _, _ = _read_header(f, path)
    meta = header.pop("__metadata__", None) or {}
    return header, meta


class SafetensorsFile(Mapping[str, torch.Tensor]):
    """A read-only mapping name -> tensor over a memory-mapped safetensors
    file.  Each lookup copies one tensor out of the mapping onto `device`
    (the host when None); nothing else is read.  Use as a context manager,
    or call close()."""

    def __init__(self, path: str, device: DeviceLike = None):
        self.path = path
        self.device = torch.device("cpu") if device is None else torch.device(device)
        with open(path, "rb") as f:
            header, self._start, size = _read_header(f, path)
            # A private copy-on-write mapping: writable, so torch.frombuffer
            # takes it without a warning, and the file is never written.
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size > self._start else None)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']}, "
                                 f"supported: {sorted(_DTYPES)}")
            begin, end = e["data_offsets"]
            dtype = _DTYPES[e["dtype"]]
            shape = tuple(int(s) for s in e["shape"])
            if end - begin != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, "
                                 f"not its shape {shape} of {e['dtype']}")
            if self._start + end > size:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            self._entries[name] = (dtype, shape, begin, end)

    def __getitem__(self, name: str) -> torch.Tensor:
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=self.device)
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - begin,
                               offset=self._start + begin)
        view = raw.view(dtype).reshape(shape)
        # A copy, so no tensor handed out pins the mapping.
        return view.clone() if self.device.type == "cpu" else view.to(self.device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def shape_of(self, name: str) -> Tuple[int, ...]:
        return self._entries[name][1]

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_safetensors(path: str, device: DeviceLike = None
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) pairs in file order, one tensor at a time, each
    copied onto `device` (the host when None)."""
    with SafetensorsFile(path, device) as f:
        for name in sorted(f, key=lambda k: f._entries[k][2]):
            yield name, f[name]


def write_safetensors(path: str, tensors: Mapping[str, Any],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write tensors (torch tensors on any device, or numpy arrays) to
    `path`, one at a time: the header is computed from shapes and dtypes
    alone, then each tensor is copied to the host, written and dropped."""
    entries = []
    for name, x in tensors.items():
        dtype = _dtype_of(x)
        if dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {dtype}, supported: "
                             f"{sorted(_NAMES.values())}")
        entries.append((name, dtype, tuple(x.shape)))
    entries.sort(key=lambda e: (-e[1].itemsize, e[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, dtype, shape in entries:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        header[name] = {"dtype": _NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, _, _ in entries:
            t = _as_tensor(tensors[name]).detach()
            t = t.to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
            del t
    os.replace(tmp, path)
