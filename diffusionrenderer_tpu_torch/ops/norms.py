"""Normalization and AdaLN modulation (counterpart of
diffusionrenderer_tpu/ops/norms.py).

Statistics are computed in fp32 and cast back, as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w over the last axis, in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x * (1 + scale) + shift; x: (B, L, D), shift/scale: (B, D)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def adaln_modulation(
    emb: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    lora: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """AdaLN-LoRA MLP in fp32: SiLU -> Linear(D->r) -> Linear(r->k*D), plus
    the shared lora vector.  w1: (r, D) and w2: (k*D, r), PyTorch's
    (out, in) layout."""
    h = F.silu(emb.float())
    h = F.linear(h, w1.float())
    h = F.linear(h, w2.float())
    if lora is not None:
        h = h + lora.float()
    return h
