"""Environment-map preprocessing for the forward (relighting) renderer
(counterpart of diffusionrenderer_tpu/envmap.py).

* HDR loading stays host-side I/O (io.py: the port's native RGBE / PFM /
  EXR codec, then imageio, then OpenCV);
* preprocessing: brightness multiply, NaN/inf cleanup clamped to the fp16
  maximum 65504, optional horizontal flip, rotation as a pixel roll;
* panorama -> 6 x R x R cubemap by bilinear equirect sampling, then the
  cubemap fetched along the lat-long direction field (ops.resample); the
  `direct` mode resamples the panorama once along the same directions;
* Reinhard + sRGB tone mapping -> env_ldr; log1p / log1p(1e4) + sRGB ->
  env_log; the lat-long direction field itself -> env_nrm;
* a content-hash LRU cache of processed results.

The tensor path runs on the device the caller names, CUDA unless asked
for the CPU (device="cpu"), in float32.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .ops.resample import grid_sample_bilinear, resize_bilinear, sample_cubemap
from .utils.cache import LRUCache
from .utils.device import DeviceLike, resolve_device

FP16_MAX = 65504.0


# ---------------------------------------------------------------------------
# Tone mapping
# ---------------------------------------------------------------------------

def rgb_to_srgb(rgb: torch.Tensor) -> torch.Tensor:
    """The sRGB transfer function."""
    return torch.where(rgb <= 0.0031308, 12.92 * rgb,
                       1.055 * torch.pow(rgb.clamp(1e-8, 1.0), 1.0 / 2.4) - 0.055)


def reinhard(x: torch.Tensor, max_point: float = 16.0) -> torch.Tensor:
    return x / (x + 1.0) * max_point


def hdr_tonemaps(env_hdr: torch.Tensor, log_scale: float = 10000.0) -> Dict[str, torch.Tensor]:
    """env_hdr (..., 3) -> {'env_ldr', 'env_log'} in [0, 1]."""
    env_ldr = rgb_to_srgb(reinhard(env_hdr, 16.0).clamp(0.0, 1.0))
    env_log = rgb_to_srgb(torch.log1p(env_hdr) / math.log1p(log_scale)).clamp(0.0, 1.0)
    return {"env_ldr": env_ldr, "env_log": env_log}


# ---------------------------------------------------------------------------
# Direction fields and cubemap construction
# ---------------------------------------------------------------------------

def latlong_vec(height: int, width: int, device: DeviceLike = None) -> torch.Tensor:
    """(H, W, 3) lat-long direction field: gy in (1/H, 1-1/H), gx in
    (-1+1/W, 1-1/W), dir = (sin(gy pi) sin(gx pi), cos(gy pi),
    -sin(gy pi) cos(gx pi))."""
    dev = resolve_device(device)
    gy = torch.linspace(1.0 / height, 1.0 - 1.0 / height, height, device=dev)
    gx = torch.linspace(-1.0 + 1.0 / width, 1.0 - 1.0 / width, width, device=dev)
    gy, gx = torch.meshgrid(gy, gx, indexing="ij")
    sin_t, cos_t = torch.sin(gy * math.pi), torch.cos(gy * math.pi)
    sin_p, cos_p = torch.sin(gx * math.pi), torch.cos(gx * math.pi)
    return torch.stack([sin_t * sin_p, cos_t, -sin_t * cos_p], dim=-1)


def _cube_face_dirs(face: int, res: int, device) -> torch.Tensor:
    """Unit directions of one cube face's texel grid (res, res, 3)."""
    g = torch.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res, device=device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    one = torch.ones_like(gx)
    table = {
        0: (one, -gy, -gx),
        1: (-one, -gy, gx),
        2: (gx, one, gy),
        3: (gx, -one, -gy),
        4: (gx, -gy, one),
        5: (-gx, -gy, -one),
    }
    v = torch.stack(table[face], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _dirs_to_equirect_grid(v: torch.Tensor) -> torch.Tensor:
    """Directions -> grid-sample coordinates in [-1, 1]^2 of an equirect map."""
    tu = torch.atan2(v[..., 0], -v[..., 2]) / (2 * math.pi) + 0.5
    tv = torch.arccos(v[..., 1].clamp(-1.0, 1.0)) / math.pi
    return torch.stack([tu, tv], dim=-1) * 2.0 - 1.0


def latlong_to_cubemap(latlong: torch.Tensor, res: int = 512) -> torch.Tensor:
    """(H, W, 3) panorama -> (6, res, res, 3) cubemap, on its device."""
    return torch.stack([
        grid_sample_bilinear(latlong, _dirs_to_equirect_grid(
            _cube_face_dirs(face, res, latlong.device)))
        for face in range(6)])


# ---------------------------------------------------------------------------
# Preprocessing and the projections
# ---------------------------------------------------------------------------

def preprocess_panorama(latlong: torch.Tensor, brightness: float = 1.0, flip: bool = False,
                        rotation_deg: float = 0.0) -> torch.Tensor:
    """Brightness, NaN/inf clamp to [0, 65504], flip, roll by the rotation."""
    x = latlong.float()
    if brightness != 1.0:
        x = x * brightness
    x = torch.nan_to_num(x, nan=0.0, posinf=FP16_MAX, neginf=0.0).clamp(0.0, FP16_MAX)
    if flip:
        x = x.flip(1)
    if rotation_deg:
        x = torch.roll(x, int(x.shape[1] * rotation_deg / 360.0), dims=1)
    return x


def _project_panorama(latlong: torch.Tensor, height: int, width: int, brightness: float,
                      flip: bool, rotation_deg: float, mode: str,
                      cubemap_res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pano = preprocess_panorama(latlong, brightness, flip, rotation_deg)
    vec = latlong_vec(height, width, latlong.device)
    if mode == "cubemap":
        env = sample_cubemap(latlong_to_cubemap(pano, cubemap_res), -vec)
    elif mode == "direct":  # one resampling stage instead of two
        env = grid_sample_bilinear(pano, _dirs_to_equirect_grid(-vec))
    else:
        raise ValueError(f"unknown projection mode {mode!r}; expected 'cubemap' or 'direct'")
    maps = hdr_tonemaps(env.flip(0, 1), 10000.0)
    return maps["env_ldr"], maps["env_log"]


_env_cache = LRUCache(max_size=10)


def _content_hash(arr: np.ndarray) -> str:
    """md5 of ~1000 regularly spaced elements."""
    flat = np.asarray(arr).reshape(-1)
    if flat.size > 1000:
        flat = flat[np.linspace(0, flat.size - 1, 1000).astype(np.int64)]
    return hashlib.md5(flat.astype(np.float32).tobytes()).hexdigest()


def _frames(ldr: torch.Tensor, log: torch.Tensor, num_frames: int) -> Dict[str, torch.Tensor]:
    h, w, _ = ldr.shape
    return {"env_ldr": ldr[None].expand(num_frames, h, w, 3),
            "env_log": log[None].expand(num_frames, h, w, 3)}


def render_projection_from_panorama(
    env_input: Union[np.ndarray, torch.Tensor, str],
    resolution: Tuple[int, int],
    env_brightness: float = 1.0,
    env_flip: bool = True,
    env_rot: float = 180.0,
    num_frames: int = 1,
    use_cache: bool = True,
    mode: str = "cubemap",
    cubemap_res: int = 512,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Panorama -> {'env_ldr', 'env_log'}, each (num_frames, H, W, 3) float32
    on `device`.  mode='cubemap' is the panorama -> cubemap -> fetch chain;
    mode='direct' resamples the panorama once along the same directions."""
    dev = resolve_device(device)
    h, w = resolution
    latlong = _load_env_input(env_input)
    key = None
    if use_cache:
        key = (_content_hash(latlong), tuple(resolution), f"proj-{mode}", env_brightness,
               env_flip, env_rot, num_frames, str(dev))
        hit = _env_cache.get(key)
        if hit is not None:
            return hit
    ldr, log = _project_panorama(torch.from_numpy(latlong).to(dev), h, w, float(env_brightness),
                                 bool(env_flip), float(env_rot), mode, cubemap_res)
    result = _frames(ldr, log, num_frames)
    if use_cache:
        _env_cache.put(key, result)
    return result


def tonemap_image_direct(
    env_input: Union[np.ndarray, torch.Tensor, str],
    resolution: Tuple[int, int],
    num_frames: int = 1,
    use_cache: bool = True,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """A pre-rendered (chrome ball) HDR image -> the tone maps only, resized
    to `resolution`: the 'ball' path."""
    dev = resolve_device(device)
    h, w = resolution
    env = _load_env_input(env_input)
    key = None
    if use_cache:
        key = (_content_hash(env), tuple(resolution), "ball", num_frames, str(dev))
        hit = _env_cache.get(key)
        if hit is not None:
            return hit
    x = torch.from_numpy(env).to(dev)
    if x.shape[:2] != (h, w):
        x = resize_bilinear(x, h, w)
    maps = hdr_tonemaps(x, 10000.0)
    result = _frames(maps["env_ldr"], maps["env_log"], num_frames)
    if use_cache:
        _env_cache.put(key, result)
    return result


def _load_env_input(env_input) -> np.ndarray:
    """A path, numpy array or tensor -> (H, W, 3) float32 numpy."""
    if isinstance(env_input, str):
        from .io import load_hdr_file

        arr = load_hdr_file(env_input)
    elif isinstance(env_input, torch.Tensor):
        arr = env_input.detach().float().cpu().numpy()
    else:
        arr = np.asarray(env_input, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    elif arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return np.ascontiguousarray(arr, np.float32)


def clear_environment_cache() -> None:
    _env_cache.clear()


def get_cache_stats() -> Dict[str, int]:
    return {"cache_size": len(_env_cache), "max_size": _env_cache.max_size,
            "hits": _env_cache.hits, "misses": _env_cache.misses}
