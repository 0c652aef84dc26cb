"""3D rotary position embeddings for video token grids (counterpart of
diffusionrenderer_tpu/ops/rope.py).

head_dim splits t/h/w as (remainder, dim//6*2, dim//6*2) -> 44/42/42 for
128; theta = 10000 * ntk factor per axis; the half table [t, h, w] is
repeated twice to fill head_dim (rotate-half convention)."""

from __future__ import annotations

from typing import Tuple

import torch


def _rope_dims(head_dim: int) -> Tuple[int, int, int]:
    dim_h = head_dim // 6 * 2
    dim_t = head_dim - 2 * dim_h
    return dim_t, dim_h, dim_h


def rope_3d_angles(
    t: int,
    h: int,
    w: int,
    head_dim: int,
    *,
    h_ntk_factor: float = 1.0,
    w_ntk_factor: float = 1.0,
    t_ntk_factor: float = 2.0,
    device=None,
) -> torch.Tensor:
    """The (T*H*W, head_dim) fp32 table of raw angles."""
    dim_t, dim_h, _ = _rope_dims(head_dim)
    f32 = torch.float32

    def freqs(theta: float, dim: int) -> torch.Tensor:
        rng = torch.arange(0, dim, 2, dtype=f32, device=device)[: dim // 2] / dim
        return 1.0 / (torch.tensor(theta, dtype=f32, device=device) ** rng)

    ang_t = torch.outer(torch.arange(t, dtype=f32, device=device),
                        freqs(10000.0 * t_ntk_factor, dim_t))
    ang_h = torch.outer(torch.arange(h, dtype=f32, device=device),
                        freqs(10000.0 * h_ntk_factor, dim_h))
    ang_w = torch.outer(torch.arange(w, dtype=f32, device=device),
                        freqs(10000.0 * w_ntk_factor, dim_h))
    half = torch.cat([
        ang_t[:, None, None, :].expand(t, h, w, -1),
        ang_h[None, :, None, :].expand(t, h, w, -1),
        ang_w[None, None, :, :].expand(t, h, w, -1),
    ], dim=-1)
    return torch.cat([half, half], dim=-1).reshape(t * h * w, head_dim)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin; x: (B, L, H, Dh), cos/sin: (L, Dh)
    fp32, cast to x's dtype before the multiply."""
    cos = cos.to(x.dtype)[None, :, None, :]
    sin = sin.to(x.dtype)[None, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin
