"""Where the port runs.

Public entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`, as the tests do).  With no CUDA device and no explicit
request they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or CUDA when None; raises if CUDA is asked for but absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on CUDA by default "
            "and on the CPU only when asked (device='cpu')")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
