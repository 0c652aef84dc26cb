"""High-level API (counterpart of diffusionrenderer_tpu/api.py):

    load_pipeline(...)   -> DiffusionRendererPipeline
    inverse_render(...)  -> {basecolor, metallic, roughness, normal, depth}

Images are float arrays in [0, 1] (or uint8), channels last; 3D (H, W, C),
4D (B, H, W, C) and 5D (B, T, H, W, C) inputs are accepted.  The pipeline
runs on CUDA unless `load_pipeline(device="cpu")` asks for the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .config import GBUFFER_INDEX_MAPPING, DiTConfig, VAEConfig
from .models.dit import init_dit_params
from .models.vae import init_vae_params
from .pipeline import DiffusionRendererPipeline
from .utils.device import DeviceLike, resolve_device
from .utils.hostops import to_float32, to_signed_range, u8_to_unit_float
from .utils.layout import to_5d_video

INVERSE_PASSES = ("basecolor", "metallic", "roughness", "normal", "depth")


def load_pipeline(
    dit_checkpoint: Optional[str] = None,
    vae_checkpoint: Optional[str] = None,
    model_type: str = "inverse",
    guidance: float = 0.0,
    num_steps: int = 15,
    seed: int = 42,
    dtype: torch.dtype = torch.bfloat16,
    compute_dtype: Optional[str] = None,
    net_config: Optional[DiTConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    device: DeviceLike = None,
) -> DiffusionRendererPipeline:
    """Build a pipeline with random weights at the model_type's architecture
    (the full FADITV2_7B DiT and CV8x8x8 VAE unless configs are given),
    drawn from fixed seeds directly on `device` (CUDA by default)."""
    if dit_checkpoint is not None or vae_checkpoint is not None:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP.md queue 1, "
            "'DiT and VAE checkpoint I/O'); call load_pipeline() without "
            "checkpoints for random weights")
    dev = resolve_device(device)
    if net_config is not None:
        net_cfg = net_config
    elif model_type == "inverse":
        net_cfg = DiTConfig(additional_concat_ch=16, use_context_embedding=True)
    else:
        net_cfg = DiTConfig(additional_concat_ch=17 * 8, use_context_embedding=False)
    vae_cfg = vae_config if vae_config is not None else VAEConfig()
    return DiffusionRendererPipeline(
        init_dit_params(net_cfg, device=dev, dtype=dtype, seed=0),
        init_vae_params(vae_cfg, device=dev, dtype=dtype, seed=1),
        model_type=model_type,
        guidance=guidance,
        num_steps=num_steps,
        seed=seed,
        compute_dtype=compute_dtype,
        net_config=net_config,
        vae_config=vae_config,
    )


def _prep_input_video(image) -> np.ndarray:
    """uint8 stays uint8 (range-mapped on the device); floats map
    [0, 1] -> [-1, 1] on the host."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        return np.asarray(to_5d_video(arr))
    return to_signed_range(np.asarray(to_5d_video(to_float32(arr))))


def _job_fingerprint(video: np.ndarray, pipeline, seed: int,
                     guidance: float) -> Dict[str, Any]:
    """Identity of a multi-pass job, for resume-safety checks: shape, dtype
    and a ~1 MiB stride sample of the input, plus the sampling settings."""
    h = hashlib.sha256()
    h.update(repr((video.shape, str(video.dtype))).encode())
    flat = np.ascontiguousarray(video).reshape(-1).view(np.uint8)
    step = max(1, flat.size // (1 << 20))
    h.update(np.ascontiguousarray(flat[::step]).tobytes())
    return {
        "input": h.hexdigest(),
        "seed": int(seed),
        "guidance": float(guidance),
        "num_steps": int(pipeline.num_steps),
        "model_type": "inverse",
    }


def inverse_render(
    pipeline: DiffusionRendererPipeline,
    image,
    guidance: float = 0.0,
    seed: int = 42,
    passes: Sequence[str] = INVERSE_PASSES,
    batch_passes: bool = True,
    resume_dir: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """RGB video -> G-buffers; returns {pass: (B*T, H, W, C) float32 in
    [0, 1]}.

    batch_passes=True runs all passes as one batched diffusion (one
    context_index per row, one VAE encode, one noise draw shared by the
    pass rows); False runs them one after another with the same seed, so
    both give the same result.  resume_dir makes the serial job durable:
    each finished pass is written atomically to <resume_dir>/<pass>.npy
    beside a manifest of the job's identity, and a re-run computes only the
    missing passes (a different job in the directory raises)."""
    pipeline.set_model_type("inverse")
    pipeline.guidance = guidance
    pipeline.seed = seed

    video = _prep_input_video(image)
    b, t, h, w, c = video.shape
    outputs: Dict[str, np.ndarray] = {}

    done: Dict[str, np.ndarray] = {}
    if resume_dir is not None:
        batch_passes = False
        fp = _job_fingerprint(video, pipeline, seed, guidance)
        os.makedirs(resume_dir, exist_ok=True)
        manifest_path = os.path.join(resume_dir, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                existing = json.load(f)
            if existing != fp:
                mismatch = [k for k in fp if existing.get(k) != fp[k]]
                raise ValueError(
                    f"resume_dir {resume_dir!r} holds a different job "
                    f"(mismatched: {mismatch}); point at a fresh directory "
                    "or delete the stale one")
        else:
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(fp, f)
            os.replace(tmp, manifest_path)
        for p in passes:
            path = os.path.join(resume_dir, f"{p}.npy")
            if os.path.exists(path):
                done[p] = np.load(path)

    if batch_passes and len(passes) > 1:
        n = len(passes)
        vid = pipeline.prepare_pixel_input(video)
        ctx = np.repeat(np.asarray([GBUFFER_INDEX_MAPPING[p] for p in passes], np.int64), b)
        normal_mask = np.repeat(np.asarray([float(p == "normal") for p in passes]), b)
        out = pipeline.generate({"rgb": vid, "video": vid, "context_index": ctx},
                                normalize_normal=normal_mask, seed=seed,
                                noise_tile=n, batch_tile=n)
        unit = u8_to_unit_float(out)
        for i, p in enumerate(passes):
            outputs[p] = unit[i * b:(i + 1) * b].reshape(b * t, h, w, c)
        return outputs

    todo = [p for p in passes if p not in done]
    vid = pipeline.prepare_pixel_input(video) if todo else None
    for p in passes:
        if p in done:
            raw_u8 = done[p]
        else:
            ctx = np.full((b,), GBUFFER_INDEX_MAPPING[p], np.int64)
            raw_u8 = pipeline.generate({"rgb": vid, "video": vid, "context_index": ctx},
                                       normalize_normal=(p == "normal"), seed=seed)
            if resume_dir is not None:
                path = os.path.join(resume_dir, f"{p}.npy")
                np.save(path + ".tmp.npy", raw_u8)
                os.replace(path + ".tmp.npy", path)
        outputs[p] = u8_to_unit_float(raw_u8).reshape(b * t, h, w, c)
    return outputs
