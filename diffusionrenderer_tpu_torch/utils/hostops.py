"""Host-side bulk conversions of numpy arrays, done by torch's vectorized
CPU kernels (counterpart of diffusionrenderer_tpu/utils/hostops.py; numpy
stays the interchange type at the API boundary)."""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def u8_to_unit_float(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1]."""
    return _as_tensor(arr).to(torch.float32).div_(255.0).numpy()


def to_signed_range(arr: np.ndarray) -> np.ndarray:
    """[0, 1] float -> [-1, 1] float32."""
    return _as_tensor(arr).to(torch.float32).mul(2.0).sub_(1.0).numpy()


def to_float32(arr) -> np.ndarray:
    """Any dtype -> contiguous float32."""
    arr = np.asarray(arr)
    if arr.dtype == np.float32 and arr.flags.c_contiguous:
        return arr
    return _as_tensor(arr).to(torch.float32).numpy()
