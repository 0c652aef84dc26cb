"""Sinusoidal sigma embedding and the shared AdaLN-LoRA vector
(counterpart of diffusionrenderer_tpu/ops/timestep.py)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) -> (B, dim) in [cos, sin] order, computed in fp32 and cast to
    the input's dtype."""
    half = dim // 2
    exponent = (-math.log(10000.0)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                / half)
    angles = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1).to(timesteps.dtype)


def timestep_embedding(timesteps: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(main_emb (B, D), adaln_lora (B, 3D)): the raw sinusoid, and
    W2 silu(W1 sinusoid); w1 (D, D), w2 (3D, D)."""
    sinusoid = sinusoidal_embedding(timesteps, dim)
    lora = F.linear(F.silu(F.linear(sinusoid, w1)), w2)
    return sinusoid, lora
