"""Whole render jobs, plainly: the conditions' VAE encode (times
sigma_data), the EDM Euler trajectory through the DiT (15 steps of a sigma
table log-spaced from sigma_max to sigma_min, then 0), the VAE decode, the
normal pass's renormalization, and the map of [-1, 1] to uint8
(truncating).  Float32; guidance 0 (no unconditional rows)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import dit, envmap, vae
from .precision import fp32_exact

GBUFFER_INDEX = {"basecolor": 0, "metallic": 1, "roughness": 2, "normal": 3, "depth": 4}
FORWARD_KEYS = ("basecolor", "normal", "metallic", "roughness", "depth",
                "env_ldr", "env_log", "env_nrm")


def sigma_table(steps: int, sigma_max: float, sigma_min: float) -> np.ndarray:
    s = np.logspace(np.log10(sigma_max), np.log10(sigma_min), steps).astype(np.float32)
    return np.concatenate([s, np.zeros(1, np.float32)])


def initial_noise(seed: int, shape, device) -> torch.Tensor:
    """N(0, 1) of `shape`, float32, from a torch.Generator on `device`
    seeded with `seed` (the renderer's documented noise for a seed)."""
    gen = torch.Generator(device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _encode(vae_params, vcfg, pixels_chw: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1] -> (B, T', h, w, 16) times sigma_data."""
    return (vae.encode(vae_params, vcfg, pixels_chw) * sigma_data).permute(0, 2, 3, 4, 1)


def _denoise(dit_params, cfg: Dict, cond: torch.Tensor, ctx, x: torch.Tensor,
             steps: int) -> torch.Tensor:
    sch = cfg["scheduler"]
    sd = float(sch["sigma_data"])
    for s, s_next in zip(*(lambda t: (t[:-1], t[1:]))(
            sigma_table(steps, sch["sigma_max"], sch["sigma_min"]).tolist())):
        s32 = torch.tensor(s, dtype=torch.float32, device=x.device)
        n32 = torch.tensor(s_next, dtype=torch.float32, device=x.device)
        c_in = 1.0 / torch.sqrt(s32 ** 2 + sd ** 2)
        f = dit.forward(dit_params, cfg["net"], x * c_in, s32.expand(x.shape[0]), cond, ctx)
        c_skip = sd ** 2 / (s32 ** 2 + sd ** 2)
        c_out = s32 * sd / torch.sqrt(s32 ** 2 + sd ** 2)
        den = c_skip * x + c_out * f
        x = x + (x - den) / s32 * (n32 - s32)
    return x


def _to_u8(video: torch.Tensor, normal_rows: Sequence[bool]) -> np.ndarray:
    """(B, 3, T, H, W) float -> uint8 (B, T, H, W, 3)."""
    norm = video.norm(dim=1, keepdim=True)
    blend = ((norm - 0.2) / 0.2).clamp(0, 1)
    renormed = video / norm.clamp_min(1e-12) * blend + video * (1 - blend)
    sel = torch.tensor([float(r) for r in normal_rows], device=video.device)[:, None, None,
                                                                             None, None]
    video = renormed * sel + video * (1 - sel)
    u8 = ((1 + video).clamp(0, 2) / 2 * 255).floor().to(torch.uint8)
    return u8.permute(0, 2, 3, 4, 1).cpu().numpy()


def _u8_pixels(img: torch.Tensor) -> torch.Tensor:
    """uint8 (T, H, W, 3) -> (1, 3, T, H, W) in [-1, 1]."""
    return (img.float() / 127.5 - 1.0).permute(3, 0, 1, 2)[None]


def inverse_job(weights: Dict, cfg: Dict, rgb: torch.Tensor, passes: Sequence[str],
                seed: int, steps: int) -> Dict[str, np.ndarray]:
    """rgb uint8 (T, H, W, 3) -> {pass: uint8 (T, H, W, 3)}, every pass one
    row of one batch sharing one noise draw."""
    with fp32_exact(), torch.no_grad():
        sd = float(cfg["scheduler"]["sigma_data"])
        z = _encode(weights["vae"], cfg["vae"], _u8_pixels(rgb), sd)
        n = len(passes)
        cond = z.repeat(n, 1, 1, 1, 1)
        ctx = torch.tensor([GBUFFER_INDEX[p] for p in passes], device=rgb.device)
        x = initial_noise(seed, (1, *z.shape[1:4], cfg["vae"]["latent_channels"]), rgb.device)
        x = (x * float(cfg["scheduler"]["sigma_max"])).repeat(n, 1, 1, 1, 1)
        x = _denoise(weights["dit"], cfg, cond, ctx, x, steps)
        video = vae.decode(weights["vae"], cfg["vae"], x.permute(0, 4, 1, 2, 3) / sd)
        u8 = _to_u8(video, [p == "normal" for p in passes])
    return {p: u8[i] for i, p in enumerate(passes)}


def forward_job(weights: Dict, cfg: Dict, gbuffers: Dict[str, torch.Tensor],
                panorama: torch.Tensor, env: Dict, seed: int, steps: int) -> np.ndarray:
    """G-buffers uint8 (T, H, W, 3) each and an HDR panorama -> relit uint8
    (T, H, W, 3)."""
    with fp32_exact(), torch.no_grad():
        sd = float(cfg["scheduler"]["sigma_data"])
        t, h, w, _ = gbuffers["basecolor"].shape
        maps = envmap.env_conditions(panorama, (h, w), env["rotation"], env["flip"],
                                     env["brightness"], env["cube_res"])
        parts = []
        for key in FORWARD_KEYS:
            if key in gbuffers:
                px = _u8_pixels(gbuffers[key])
            else:
                m = maps[key] if key == "env_nrm" else maps[key] * 2 - 1
                px = m.permute(2, 0, 1)[None, :, None].expand(-1, -1, t, -1, -1)
            z = _encode(weights["vae"], cfg["vae"], px, sd)
            parts += [z, torch.ones_like(z[..., :1])]
        cond = torch.cat(parts, dim=-1)
        x = initial_noise(seed, (1, *cond.shape[1:4], cfg["vae"]["latent_channels"]),
                          panorama.device) * float(cfg["scheduler"]["sigma_max"])
        x = _denoise(weights["dit"], cfg, cond, None, x, steps)
        video = vae.decode(weights["vae"], cfg["vae"], x.permute(0, 4, 1, 2, 3) / sd)
        return _to_u8(video, [False])[0]
