"""The card a run measures: whether it is there, and what it is."""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import torch


def missing(chips: int) -> Optional[str]:
    """Why the run cannot measure `chips` cards, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: no card to measure"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return None


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(chips: int) -> Dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved()),
            "power_limit_w": power_limit_w()}
