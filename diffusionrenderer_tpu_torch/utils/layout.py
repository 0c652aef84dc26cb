"""Layout helpers between channels-first (B, C, T, H, W) and channels-last
(B, T, H, W, C) video tensors.

Counterpart of diffusionrenderer_tpu/utils/layout.py.  The public functions
of the port keep the JAX package's channels-last layout; the convolutions
inside the VAE run channels-first, PyTorch's own layout.
"""

from __future__ import annotations

import numpy as np
import torch


def ncthw_to_nthwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def nthwc_to_ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_5d_video(x):
    """Normalize 3D/4D/5D image input to (B, T, H, W, C):
      (H, W, C)       -> (1, 1, H, W, C)
      (B, H, W, C)    -> (B, 1, H, W, C)
      (B, T, H, W, C) -> unchanged
    Tensors stay tensors; anything else becomes a numpy array."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim == 3:
        return x[None, None]
    if x.ndim == 4:
        return x[:, None]
    if x.ndim == 5:
        return x
    raise ValueError(f"Unsupported tensor rank {x.ndim}; expected 3, 4 or 5.")
