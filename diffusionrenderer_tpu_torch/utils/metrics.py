"""Quality metrics for parity checks (counterpart of
diffusionrenderer_tpu/utils/metrics.py; numpy only)."""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays.

    Use peak=255 for uint8 video frames, peak=1.0 for [0,1] floats.
    Returns inf for identical inputs.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
