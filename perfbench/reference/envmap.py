"""The relighting renderer's environment conditions, plainly, in float32:
an HDR lat-long panorama is cleaned (non-finite values and the range
clamped to [0, 65504]), rolled by the rotation, resampled to a 6-face
cubemap by bilinear lookups (align_corners=False, edge clamped), and the
cubemap is read along the reversed lat-long direction of each output pixel
with bilinear filtering that continues across face edges (a tap past an
edge reads the neighbouring face's texel the edge continues to; past a cube
corner, the mean of the three texels that meet there); the result is
flipped on both axes and tone mapped (Reinhard to 16, clamped, sRGB; and
log1p / log1p(1e4), sRGB, clamped).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# face: (axis, sign, u axis and sign, v axis and sign) as direction = sign
# on the major axis, u and v the in-face coordinates.
_FACES = {0: (0, 1.0, (2, -1.0), (1, -1.0)), 1: (0, -1.0, (2, 1.0), (1, -1.0)),
          2: (1, 1.0, (0, 1.0), (2, 1.0)), 3: (1, -1.0, (0, 1.0), (2, -1.0)),
          4: (2, 1.0, (0, 1.0), (1, -1.0)), 5: (2, -1.0, (0, -1.0), (1, -1.0))}


def latlong_dirs(h: int, w: int, device) -> torch.Tensor:
    """nvdiffrec's lat-long direction field: polar angle over
    linspace(1/h, 1 - 1/h, h) x pi, azimuth over linspace(-1 + 1/w, 1 - 1/w, w)
    x pi."""
    gy = torch.linspace(1.0 / h, 1.0 - 1.0 / h, h, dtype=torch.float64, device=device)
    gx = torch.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w, dtype=torch.float64, device=device)
    th, ph = torch.meshgrid(gy * math.pi, gx * math.pi, indexing="ij")
    return torch.stack([th.sin() * ph.sin(), th.cos(), -th.sin() * ph.cos()], -1).float()


def _bilinear_clamped(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    h, w, _ = img.shape
    x0, y0 = px.floor(), py.floor()
    fx, fy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()

    def at(yy, xx):
        return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    return ((at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx) * (1 - fy)
            + (at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx) * fy)


def _equirect(pano: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of the panorama along directions d (..., 3)."""
    h, w, _ = pano.shape
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2 * math.pi) + 0.5
    v = torch.arccos(d[..., 1].clamp(-1, 1)) / math.pi
    return _bilinear_clamped(pano, u * w - 0.5, v * h - 0.5)


def _face_dir(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    axis, sign, (ua, us), (va, vs) = _FACES[face]
    comps = [None, None, None]
    comps[axis] = torch.full_like(u, sign)
    comps[ua] = us * u
    comps[va] = vs * v
    return torch.stack(comps, -1)


def to_cubemap(pano: torch.Tensor, res: int) -> torch.Tensor:
    g = (torch.arange(res, dtype=torch.float32, device=pano.device) * 2 + 1) / res - 1
    v, u = torch.meshgrid(g, g, indexing="ij")
    faces = []
    for f in range(6):
        d = _face_dir(f, u, v)
        faces.append(_equirect(pano, d / d.norm(dim=-1, keepdim=True)))
    return torch.stack(faces)


def _locate(d: torch.Tensor):
    """(face, u, v) of directions: the major axis picks the face (x before y
    before z on ties)."""
    a = d.abs()
    is_x = (a[..., 0] >= a[..., 1]) & (a[..., 0] >= a[..., 2])
    is_y = ~is_x & (a[..., 1] >= a[..., 2])
    face = torch.where(is_x, torch.where(d[..., 0] > 0, 0, 1),
                       torch.where(is_y, torch.where(d[..., 1] > 0, 2, 3),
                                   torch.where(d[..., 2] > 0, 4, 5)))
    u = torch.zeros_like(d[..., 0])
    v = torch.zeros_like(d[..., 0])
    for f, (axis, sign, (ua, us), (va, vs)) in _FACES.items():
        sel = face == f
        ma = d[..., axis].abs().clamp_min(1e-12)
        u = torch.where(sel, us * d[..., ua] / ma, u)
        v = torch.where(sel, vs * d[..., va] / ma, v)
    return face, u, v


def _texel(cube: torch.Tensor, face, xi, yi):
    """One texel per tap; a tap past an edge follows the direction of its
    texel centre onto the neighbouring face."""
    r = cube.shape[1]
    inside = (xi >= 0) & (xi < r) & (yi >= 0) & (yi < r)
    u = (xi.float() + 0.5) * 2 / r - 1
    v = (yi.float() + 0.5) * 2 / r - 1
    d = torch.zeros(*face.shape, 3, device=cube.device)
    for f in range(6):
        d = torch.where((face == f)[..., None], _face_dir(f, u, v), d)
    f2, u2, v2 = _locate(d)
    x2 = ((u2 + 1) * r / 2 - 0.5).round().long().clamp(0, r - 1)
    y2 = ((v2 + 1) * r / 2 - 0.5).round().long().clamp(0, r - 1)
    own = cube[face, yi.clamp(0, r - 1), xi.clamp(0, r - 1)]
    return torch.where(inside[..., None], own, cube[f2, y2, x2])


def _fetch(cube, face, xi, yi):
    r = cube.shape[1]
    xo = (xi < 0) | (xi > r - 1)
    yo = (yi < 0) | (yi > r - 1)
    xc, yc = xi.clamp(0, r - 1), yi.clamp(0, r - 1)
    own = cube[face, yc, xc]
    via_x = _texel(cube, face, xi, yc)
    via_y = _texel(cube, face, xc, yi)
    corner = (xo & yo)[..., None]
    one = torch.where(xo[..., None], via_x, torch.where(yo[..., None], via_y, own))
    return torch.where(corner, (own + via_x + via_y) / 3, one)


def sample_cube(cube: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    r = cube.shape[1]
    face, u, v = _locate(d)
    gx, gy = (u + 1) * r / 2 - 0.5, (v + 1) * r / 2 - 0.5
    x0, y0 = gx.floor(), gy.floor()
    fx, fy = (gx - x0)[..., None], (gy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    top = _fetch(cube, face, x0, y0) * (1 - fx) + _fetch(cube, face, x0 + 1, y0) * fx
    bot = _fetch(cube, face, x0, y0 + 1) * (1 - fx) + _fetch(cube, face, x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _srgb(x):
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * x.clamp(1e-8, 1.0) ** (1 / 2.4) - 0.055)


def env_conditions(pano: torch.Tensor, size: Tuple[int, int], rotation_deg: float,
                   flip: bool, brightness: float, cube_res: int) -> Dict[str, torch.Tensor]:
    """{'env_ldr', 'env_log'} (H, W, 3) in [0, 1], 'env_nrm' the direction
    field."""
    h, w = size
    x = pano.float() * brightness
    x = torch.nan_to_num(x, nan=0.0, posinf=65504.0, neginf=0.0).clamp(0.0, 65504.0)
    if flip:
        x = x.flip(1)
    x = torch.roll(x, int(x.shape[1] * rotation_deg / 360.0), dims=1)
    dirs = latlong_dirs(h, w, pano.device)
    env = sample_cube(to_cubemap(x, cube_res), -dirs).flip(0, 1)
    ldr = _srgb((env / (env + 1) * 16).clamp(0, 1))
    log = _srgb(torch.log1p(env) / math.log1p(1e4)).clamp(0, 1)
    return {"env_ldr": ldr, "env_log": log, "env_nrm": dirs}
