"""High-level API (counterpart of diffusionrenderer_tpu/api.py):

    load_pipeline(...)   -> DiffusionRendererPipeline
    inverse_render(...)  -> {basecolor, metallic, roughness, normal, depth}
    forward_render(...)  -> relit RGB video
    load_hdr(path)       -> float HDR image

Images are float arrays in [0, 1] (or uint8), channels last; 3D (H, W, C),
4D (B, H, W, C) and 5D (B, T, H, W, C) inputs are accepted.  The pipeline
runs on CUDA unless `load_pipeline(device="cpu")` asks for the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .config import GBUFFER_INDEX_MAPPING, DiTConfig, VAEConfig
from .envmap import latlong_vec, render_projection_from_panorama, tonemap_image_direct
from .io import load_hdr_image
from .models.dit import init_dit_params
from .models.quant import quantize_block
from .models.vae import init_vae_params, load_latent_stats
from .pipeline import DiffusionRendererPipeline
from .utils.device import DeviceLike, resolve_device, synchronize
from .utils.hostops import to_float32, to_signed_range, u8_to_unit_float
from .utils.layout import to_5d_video
from .utils.profiling import phase_timer

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
    vae_config_json: Optional[str] = None,
    net_config: Optional[DiTConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    device: DeviceLike = None,
    quantize_int8: bool = False,
    act_quant: bool = False,
    quant_group_size: Optional[int] = None,
    quant_keep_bf16: Sequence[str] = (),
    quant_mse_clip: bool = False,
    quant_hadamard: bool = False,
) -> DiffusionRendererPipeline:
    """Build a pipeline at the model_type's architecture (the full
    FADITV2_7B DiT and CV8x8x8 VAE unless configs are given), with its
    weights placed straight on `device` (CUDA by default).

    dit_checkpoint: a reference `.pt` / `.safetensors` state dict, converted
    and streamed to the device tensor by tensor, or a native file
    (checkpoint.save_native), restored as saved.  vae_checkpoint: a
    diffusers directory or safetensors file, or a native file.
    vae_config_json: a diffusers config.json whose latents_mean / std
    replace the checkpoint's.  Without checkpoints the weights are random,
    drawn from fixed seeds on the device.

    quantize_int8 quantizes the DiT's block matmuls to int8 on the device,
    block by block as they are loaded or drawn (models/quant.quantize_block:
    a random pipeline keeps the weights of the unquantized one of the same
    seed): act_quant for W8A8 (the int8 matmul kernel), quant_group_size
    for per-group scales, quant_keep_bf16 for matmuls left unquantized
    ('wo', 'mlp.w2', ...), quant_mse_clip and quant_hadamard for the
    calibration-free quantizers.  A native checkpoint ignores them."""
    from .checkpoint import is_native_checkpoint, load_dit_checkpoint
    from .checkpoint_vae import load_vae_checkpoint, refuse_identity_stats

    dev = resolve_device(device)
    if dit_checkpoint is not None and is_native_checkpoint(dit_checkpoint):
        # A convert_meta.json beside a native checkpoint names the model
        # type it was converted for: fail fast on a mismatch rather than
        # with an opaque shape error at generate time.
        meta_path = os.path.join(os.path.dirname(os.path.abspath(dit_checkpoint)),
                                 "convert_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("model_type") and meta["model_type"] != model_type:
                raise ValueError(
                    f"native checkpoint {dit_checkpoint} was converted for "
                    f"model_type={meta['model_type']!r} but load_pipeline "
                    f"was called with model_type={model_type!r}")
    if net_config is not None:
        net_cfg = net_config
    elif model_type == "inverse":
        net_cfg = DiTConfig(additional_concat_ch=16, use_context_embedding=True)
    else:
        net_cfg = DiTConfig(additional_concat_ch=17 * 8, use_context_embedding=False)
    quant_kw = dict(act_quant=act_quant, group_size=quant_group_size,
                    keep_bf16=tuple(quant_keep_bf16), mse_clip=quant_mse_clip,
                    hadamard=quant_hadamard)
    if dit_checkpoint is not None:
        dit_params = load_dit_checkpoint(dit_checkpoint, net_cfg, dtype,
                                         quantize_int8=quantize_int8, device=dev, **quant_kw)
    else:
        block_fn = functools.partial(quantize_block, **quant_kw) if quantize_int8 else None
        dit_params = init_dit_params(net_cfg, device=dev, dtype=dtype, seed=0,
                                     block_fn=block_fn)

    vae_cfg = vae_config if vae_config is not None else VAEConfig()
    if vae_checkpoint is not None:
        vae_params = load_vae_checkpoint(vae_checkpoint, vae_cfg, dtype, device=dev)
    else:
        vae_params = init_vae_params(vae_cfg, device=dev, dtype=dtype, seed=1)
    if vae_config_json is not None:
        with open(vae_config_json) as f:
            vc = json.load(f)
        vae_params = load_latent_stats(vae_params, vc["latents_mean"], vc["latents_std"],
                                       vae_cfg)
    if vae_checkpoint is not None:
        # Diffusers loads fall back to the bundled table; only a native file
        # saved with identity statistics gets here with them.
        refuse_identity_stats(vae_params, vae_cfg, vae_checkpoint)
    return DiffusionRendererPipeline(
        dit_params,
        vae_params,
        model_type=model_type,
        guidance=guidance,
        num_steps=num_steps,
        seed=seed,
        compute_dtype=compute_dtype,
        net_config=net_config,
        vae_config=vae_config,
    )


@contextlib.contextmanager
def _phase(name: str, device):
    """phase_timer closed after the device's queued work (the upload)."""
    with phase_timer(name):
        yield
        synchronize(device)


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
    missing passes (a different job in the directory raises); on a sharded
    pipeline every rank computes and reads, and rank 0 alone writes."""
    pipeline.set_model_type("inverse")
    pipeline.guidance = guidance
    pipeline.seed = seed

    video = _prep_input_video(image)
    b, t, h, w, c = video.shape
    outputs: Dict[str, np.ndarray] = {}

    done: Dict[str, np.ndarray] = {}
    writer = pipeline.mesh is None or pipeline.mesh.rank == 0
    if resume_dir is not None:
        batch_passes = False
        fp = _job_fingerprint(video, pipeline, seed, guidance)
        if writer:
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
        elif writer:
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

    # The serial job records the JAX package's phases: one upload, one
    # generate per missing pass (each finished pass saved at once under
    # resume_dir), one conversion per pass.
    todo = [p for p in passes if p not in done]
    raw: Dict[str, np.ndarray] = dict(done)
    if todo:
        with _phase("api/upload_input", pipeline.device):
            vid = pipeline.prepare_pixel_input(video)
    for p in todo:
        ctx = np.full((b,), GBUFFER_INDEX_MAPPING[p], np.int64)
        with phase_timer("api/generate_pass"):
            raw[p] = pipeline.generate({"rgb": vid, "video": vid, "context_index": ctx},
                                       normalize_normal=(p == "normal"), seed=seed)
            if resume_dir is not None and writer:
                path = os.path.join(resume_dir, f"{p}.npy")
                np.save(path + ".tmp.npy", raw[p])
                os.replace(path + ".tmp.npy", path)
    for p in passes:
        with phase_timer("api/fetch_convert_output"):
            outputs[p] = u8_to_unit_float(raw.pop(p)).reshape(b * t, h, w, c)
    return outputs


def forward_render(
    pipeline: DiffusionRendererPipeline,
    depth,
    normal,
    roughness,
    metallic,
    base_color,
    env_map,
    guidance: float = 0.0,
    seed: int = 42,
    env_format: str = "proj",
    env_brightness: float = 1.0,
    env_flip_horizontal: bool = False,
    env_rotation: float = 180.0,
) -> np.ndarray:
    """G-buffers + HDR environment -> relit RGB video, (B*T, H, W, 3) float32
    in [0, 1].  The G-buffers are images or videos as for inverse_render
    (uint8, or floats in [0, 1]); env_map is an HDR panorama (or, for
    'ball', a chrome-ball image): a path, an array or a tensor.

    env_format: 'proj' (panorama -> cubemap -> projection), 'proj_direct'
    (one equirect resampling) or 'ball' (tone mapping only).  The env
    projection is the same for every frame: it is computed once, for one
    frame, on the pipeline's device, and reaches the pipeline as
    (B, 1, H, W, 3), which broadcasts it over the clip's frames."""
    pipeline.set_model_type("forward")
    pipeline.guidance = guidance
    pipeline.seed = seed

    gbuffers = {"depth": depth, "normal": normal, "roughness": roughness,
                "metallic": metallic, "basecolor": base_color}
    data_batch: Dict[str, Any] = {name: _prep_input_video(g) for name, g in gbuffers.items()}
    b, t, h, w, _ = data_batch["depth"].shape
    data_batch["video"] = data_batch["depth"]

    if env_format in ("proj", "proj_direct"):
        env = render_projection_from_panorama(
            env_map, resolution=(h, w), env_brightness=env_brightness,
            env_flip=env_flip_horizontal, env_rot=env_rotation, num_frames=1,
            mode="cubemap" if env_format == "proj" else "direct", device=pipeline.device)
    elif env_format == "ball":
        env = tonemap_image_direct(env_map, resolution=(h, w), num_frames=1,
                                   device=pipeline.device)
    else:
        raise ValueError(f"Unknown env_format {env_format!r}")

    # env_ldr and env_log map to [-1, 1]; env_nrm, the direction field, is
    # not rescaled.
    env_ldr = to_signed_range(env["env_ldr"][0].cpu().numpy())
    env_log = to_signed_range(env["env_log"][0].cpu().numpy())
    env_nrm = latlong_vec(h, w, pipeline.device).cpu().numpy()
    for name, x in (("env_ldr", env_ldr), ("env_log", env_log), ("env_nrm", env_nrm)):
        data_batch[name] = np.repeat(x[None, None], b, axis=0)  # (B, 1, H, W, 3)

    out = pipeline.generate(data_batch, seed=seed)
    return u8_to_unit_float(out).reshape(b * t, h, w, 3)


def load_hdr(path: str) -> np.ndarray:
    """(1, H, W, 3) float32 HDR image; values may exceed 1."""
    return load_hdr_image(path)
