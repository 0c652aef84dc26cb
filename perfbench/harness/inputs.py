"""A run's inputs, drawn from its seed: seeds derived by name, and the
images a job takes (smooth random fields with fine grain), made on the
device by a torch.Generator and handed over as host arrays, as a user's
decoded files would be."""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def derive(seed: int, *parts) -> int:
    """A 60-bit seed for (seed, parts): distinct names give unrelated draws."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).hexdigest()
    return int(h[:15], 16)


def _field(gen, device, frames: int, h: int, w: int, ch: int, cells: int) -> torch.Tensor:
    """(frames, h, w, ch) smooth noise in about [-1, 1]: a cells x cells grid
    of normals, upsampled bilinearly, a little grain on top."""
    coarse = torch.randn(frames, ch, cells, cells, generator=gen, device=device) * 0.5
    up = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    grain = torch.randn(frames, ch, h, w, generator=gen, device=device) * 0.03
    return (up + grain).permute(0, 2, 3, 1)


def _u8(x: torch.Tensor) -> np.ndarray:
    return ((x.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).cpu().numpy()


def rgb_video(seed: int, frames: int, h: int, w: int, device) -> np.ndarray:
    gen = torch.Generator(device).manual_seed(seed)
    return _u8(_field(gen, device, frames, h, w, 3, 8))


def gbuffers(seed: int, frames: int, h: int, w: int, device) -> Dict[str, np.ndarray]:
    """uint8 (frames, h, w, 3) depth, normal, roughness, metallic, basecolor."""
    gen = torch.Generator(device).manual_seed(seed)
    normal = _field(gen, device, frames, h, w, 3, 6)
    normal = normal + torch.tensor([0.0, 0.0, 1.0], device=device)
    normal = normal / normal.norm(dim=-1, keepdim=True)
    gray = {k: _field(gen, device, frames, h, w, 1, c).expand(-1, -1, -1, 3)
            for k, c in (("depth", 4), ("roughness", 6), ("metallic", 6))}
    return {"depth": _u8(gray["depth"]), "normal": _u8(normal),
            "roughness": _u8(gray["roughness"]), "metallic": _u8(gray["metallic"]),
            "basecolor": _u8(_field(gen, device, frames, h, w, 3, 8))}


def hdr_panorama(seed: int, h: int, w: int, device) -> np.ndarray:
    """float32 (h, w, 3) radiance: a smooth log-normal sky and one sun, a
    Gaussian of peak 50 to 500."""
    gen = torch.Generator(device).manual_seed(seed)
    sky = torch.exp(_field(gen, device, 1, h, w, 3, 16)[0] * 1.5)
    cy, cx, peak = torch.rand(3, generator=gen, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    d2 = (yy - cy * 0.5) ** 2 + (xx - cx) ** 2
    sun = (50.0 + 450.0 * peak) * torch.exp(-d2 / (2 * 0.01 ** 2))
    return (sky + sun[..., None]).float().cpu().numpy()
