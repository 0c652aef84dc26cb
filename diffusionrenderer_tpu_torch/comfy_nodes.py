"""ComfyUI node surface over the port (counterpart of
diffusionrenderer_tpu/comfy_nodes.py).

The reference package is a ComfyUI plugin: four node classes registered
through NODE_CLASS_MAPPINGS.  This module declares the same nodes (names,
INPUT_TYPES, RETURN_TYPES / RETURN_NAMES, FUNCTION, CATEGORY and the
loader's QUANT_MODES and defaults) over the port's `api` layer, so an
existing workflow graph loads unchanged and renders on the CUDA card.

ComfyUI conventions:
  * IMAGE values are torch float tensors in [0, 1], channels last;
    3D (H,W,C) / 4D (B,H,W,C) / 5D (B,T,H,W,C) and lists are coerced with
    the reference's fallbacks (_coerce_5d_torch).
  * The loader resolves checkpoints through `folder_paths` inside ComfyUI;
    standalone it takes plain paths.
  * HDR env maps flow between nodes as IMAGE tensors whose values may
    exceed 1.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from . import api

try:  # Inside ComfyUI these exist; standalone they don't.
    import folder_paths  # type: ignore

    _HAS_COMFY = True
except ImportError:
    folder_paths = None  # type: ignore
    _HAS_COMFY = False

# Deployment quant modes on the loader node (the grammar of
# models.quant.parse_quant_mode).  "bf16" is the reference's lossless
# default; "w8a8" (the int8 matmul kernel) is the node's default, so
# workflows saved against the JAX package load unchanged.
QUANT_MODES = (
    "bf16",
    "w8a8",
    "w8",
    "w8a8_g128",
    "w8a8_g32",
    "w8_g32_keepres_keepattn",
)


def _coerce_5d_torch(value: Any, name: str) -> torch.Tensor:
    """List/3D/4D/5D IMAGE input -> 5D (B,T,H,W,C) torch tensor, with the
    reference's fallbacks."""
    if isinstance(value, list):
        try:
            return torch.stack(value, dim=0)
        except RuntimeError:
            # Ragged list: the reference processes the first item only.
            return value[0].unsqueeze(0)
    if isinstance(value, torch.Tensor):
        if value.ndim == 3:
            return value.unsqueeze(0).unsqueeze(0)
        if value.ndim == 4:
            return value.unsqueeze(1)
        if value.ndim == 5:
            return value
        raise ValueError(
            f"Unsupported tensor dimension for {name!r}: {value.ndim}. "
            "Expected 3D, 4D, or 5D."
        )
    raise TypeError(
        f"Unsupported input type for {name!r}: {type(value)}. "
        "Expected torch.Tensor or list of Tensors."
    )


def _to_numpy(value: Any, name: str) -> np.ndarray:
    """IMAGE input -> host float32 (B,T,H,W,C) numpy, zero-copy when the
    tensor is already contiguous fp32 on the CPU."""
    t = _coerce_5d_torch(value, name).detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.float().contiguous().numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """api output (frames, H, W, C) float32 in [0,1] -> ComfyUI IMAGE."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


class LoadDiffusionRendererModel:
    """Loader node.

    Inside ComfyUI: `model` is a filename from models/diffusion_models and
    the VAE is found at models/vae/Cosmos-1.0-Tokenizer-CV8x8x8/vae.
    Standalone: `model` and `vae_path` are plain paths (reference checkpoints
    are converted on load; native files from `cli convert` restore as
    saved).  The pipeline lands on the CUDA card.
    """

    @classmethod
    def INPUT_TYPES(cls):
        if _HAS_COMFY:
            model_spec = (
                folder_paths.get_filename_list("diffusion_models"),
                {"tooltip":
                 "Models are loaded from 'ComfyUI/models/diffusion_models'"},
            )
        else:
            model_spec = ("STRING", {
                "tooltip": "Path to a DiT checkpoint "
                           "(.safetensors/.pt or a native file)"})
        return {
            "required": {"model": model_spec},
            "optional": {
                "quant_mode": (list(QUANT_MODES), {"default": "w8a8"}),
                "vae_path": ("STRING", {"default": ""}),
            },
        }

    RETURN_TYPES = ("DIFFUSION_RENDERER_PIPELINE",)
    FUNCTION = "load_pipeline"
    CATEGORY = "Cosmos1"

    def load_pipeline(self, model: str, quant_mode: str = "w8a8",
                      vae_path: str = ""):
        dit_path = model
        if _HAS_COMFY:
            resolved = folder_paths.get_full_path("diffusion_models", model)
            if resolved is not None:
                dit_path = resolved
            if not vae_path:
                vae_path = os.path.join(
                    folder_paths.models_dir, "vae",
                    "Cosmos-1.0-Tokenizer-CV8x8x8", "vae",
                )
        kwargs: Dict[str, Any] = {}
        if quant_mode != "bf16":
            from .models.quant import parse_quant_mode

            qm = parse_quant_mode(quant_mode)
            if qm.needs_calibration:
                raise ValueError(
                    f"quant mode {quant_mode!r} needs calibration stats — "
                    "convert the checkpoint offline with the CLI and load "
                    "the native checkpoint instead")
            kwargs.update(quantize_int8=True, act_quant=qm.act_quant,
                          quant_group_size=qm.group_size,
                          quant_keep_bf16=qm.keep,
                          quant_mse_clip=qm.mse_clip,
                          quant_hadamard=qm.hadamard)
        # The reference's defaults guidance=0.0, num_steps=15, seed=42; the
        # renderer nodes set guidance and seed per run.
        pipeline = api.load_pipeline(
            dit_checkpoint=dit_path,
            vae_checkpoint=vae_path or None,
            model_type="inverse",
            guidance=0.0,
            num_steps=15,
            seed=42,
            **kwargs,
        )
        return (pipeline,)


class Cosmos1InverseRenderer:
    """RGB video -> 5 G-buffers, the passes as one batched diffusion
    (api.inverse_render): one VAE encode, one generation."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pipeline": ("DIFFUSION_RENDERER_PIPELINE",),
                "image": ("IMAGE",),
            },
            "optional": {
                "guidance": ("FLOAT",
                             {"default": 0.0, "min": 0.0, "max": 10.0,
                              "step": 0.1}),
                "seed": ("INT", {"default": 42, "min": 0,
                                 "max": 0xFFFFFFFFFFFFFFFF}),
            },
        }

    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = ("base_color", "metallic", "roughness", "normal", "depth")
    FUNCTION = "run_inverse_pass"
    CATEGORY = "Cosmos1"

    def run_inverse_pass(self, pipeline, image, guidance: float = 0.0,
                         seed: int = 42):
        video = _to_numpy(image, "image")
        outputs = api.inverse_render(
            pipeline, video, guidance=guidance, seed=seed
        )
        return tuple(
            _from_numpy(outputs[p]) for p in api.INVERSE_PASSES
        )


class Cosmos1ForwardRenderer:
    """G-buffers + HDR env map -> relit RGB video."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pipeline": ("DIFFUSION_RENDERER_PIPELINE",),
                "depth": ("IMAGE",),
                "normal": ("IMAGE",),
                "roughness": ("IMAGE",),
                "metallic": ("IMAGE",),
                "base_color": ("IMAGE",),
                "env_map": ("IMAGE",),
            },
            "optional": {
                "guidance": ("FLOAT", {"default": 0.0, "min": 0.0,
                                       "max": 2.0, "step": 0.1}),
                "seed": ("INT", {"default": 42, "min": 0,
                                 "max": 0xFFFFFFFFFFFFFFFF}),
                "env_format": (["proj", "proj_direct", "ball"],
                               {"default": "proj"}),
                "env_brightness": ("FLOAT", {"default": 1.0, "min": 0.0,
                                             "max": 2.0, "step": 0.1}),
                "env_flip_horizontal": ("BOOLEAN", {"default": False}),
                "env_rotation": ("FLOAT", {"default": 180.0, "min": 0,
                                           "max": 360, "step": 1.0}),
            },
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "run_forward_pass"
    CATEGORY = "Cosmos1"

    def run_forward_pass(self, pipeline, depth, normal, roughness, metallic,
                         base_color, env_map, guidance: float = 0.0,
                         seed: int = 42, env_format: str = "proj",
                         env_brightness: float = 1.0,
                         env_flip_horizontal: bool = False,
                         env_rotation: float = 180.0):
        env = env_map
        if isinstance(env, torch.Tensor):
            # HDR panorama as an IMAGE tensor (values may exceed 1).
            env = env.detach().cpu().float().numpy()
        out = api.forward_render(
            pipeline,
            depth=_to_numpy(depth, "depth"),
            normal=_to_numpy(normal, "normal"),
            roughness=_to_numpy(roughness, "roughness"),
            metallic=_to_numpy(metallic, "metallic"),
            base_color=_to_numpy(base_color, "base_color"),
            env_map=env,
            guidance=guidance,
            seed=seed,
            env_format=env_format,
            env_brightness=env_brightness,
            env_flip_horizontal=env_flip_horizontal,
            env_rotation=env_rotation,
        )
        return (_from_numpy(out),)


class LoadHDRImage:
    """Load a .hdr/.exr/.pfm file as an IMAGE whose values may exceed 1
    (the port's native codec first)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "path": ("STRING",
                         {"tooltip": "Path to HDR image (.hdr, .exr)"}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "load_hdr"
    CATEGORY = "Cosmos1"

    def load_hdr(self, path: str):
        return (_from_numpy(api.load_hdr(path)),)


NODE_CLASS_MAPPINGS = {
    "LoadDiffusionRendererModel": LoadDiffusionRendererModel,
    "Cosmos1InverseRenderer": Cosmos1InverseRenderer,
    "Cosmos1ForwardRenderer": Cosmos1ForwardRenderer,
    "LoadHDRImage": LoadHDRImage,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "LoadDiffusionRendererModel": "Load Diffusion Renderer Model (CUDA)",
    "Cosmos1InverseRenderer": "Cosmos1 Inverse Renderer (CUDA)",
    "Cosmos1ForwardRenderer": "Cosmos1 Forward Renderer (CUDA)",
    "LoadHDRImage": "Load HDR Image (CUDA)",
}
