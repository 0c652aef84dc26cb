"""Patchify / unpatchify for the DiT (counterpart of
diffusionrenderer_tpu/ops/patch.py).  Channels-last (B, T, H, W, C).

patchify orders each patch vector (C, pt, ph, pw), C slowest; unpatchify
expects the final layer's channels ordered (ph, pw, pt, C)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def patchify(x: torch.Tensor, patch_spatial: int, patch_temporal: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/pt, H/ps, W/ps, C*pt*ps*ps)."""
    b, t, h, w, c = x.shape
    ps, pt = patch_spatial, patch_temporal
    if t % pt or h % ps or w % ps:
        raise ValueError(f"(T, H, W)=({t}, {h}, {w}) not divisible by "
                         f"patch ({pt}, {ps}, {ps})")
    tp, hp, wp = t // pt, h // ps, w // ps
    x = x.reshape(b, tp, pt, hp, ps, wp, ps, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, tp, hp, wp, c * pt * ps * ps)


def unpatchify(x: torch.Tensor, tp: int, hp: int, wp: int, patch_spatial: int,
               patch_temporal: int, out_channels: int) -> torch.Tensor:
    """(B, Tp*Hp*Wp, ph*pw*pt*C) -> (B, T, H, W, C)."""
    b = x.shape[0]
    ps, pt, c = patch_spatial, patch_temporal, out_channels
    x = x.reshape(b, tp, hp, wp, ps, ps, pt, c)
    x = x.permute(0, 1, 6, 2, 4, 3, 5, 7)
    return x.reshape(b, tp * pt, hp * ps, wp * ps, c)


def patch_embed(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                patch_spatial: int, patch_temporal: int) -> torch.Tensor:
    """Patchify + linear projection: (B, T, H, W, C) -> (B, Tp, Hp, Wp, D);
    weight (D, patch_dim)."""
    out = F.linear(patchify(x, patch_spatial, patch_temporal), weight)
    if bias is not None:
        out = out + bias
    return out
