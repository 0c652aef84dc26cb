"""How far a job's outputs lie from the reference's: statistics over the
frames of every output (uint8 arrays of shape (T, H, W, C)), each the worst
frame's.  A cell's limits file names the statistics its check holds."""

from __future__ import annotations

from typing import Dict

import numpy as np

SHARE_LEVELS = (2, 3, 4, 6, 8, 12)


def frame_stats(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """One frame (H, W, C): the RMS difference in levels, and the share of
    values off by more than k levels for each k in SHARE_LEVELS (a cell's
    limit picks the level at which its control and its sound runs part)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    out = {"frame_rms_u8": float(np.sqrt(np.mean(d * d)))}
    ad = np.abs(d)
    for k in SHARE_LEVELS:
        out[f"share_off_{k}_levels"] = float(np.mean(ad > k))
    return out


def worst(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Each statistic's worst frame over every output of a job."""
    out: Dict[str, float] = {}
    for key in want:
        if got[key].shape != want[key].shape:
            raise ValueError(f"output {key}: shape {got[key].shape}, "
                             f"reference {want[key].shape}")
        for f in range(want[key].shape[0]):
            for name, v in frame_stats(got[key][f], want[key][f]).items():
                out[name] = max(out.get(name, -np.inf), v)
    return out
