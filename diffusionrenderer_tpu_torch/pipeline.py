"""Pipeline orchestration: condition encode -> EDM denoise -> decode -> uint8.

Counterpart of diffusionrenderer_tpu/pipeline.py along the path that
`generate()` takes by default there (staged, with `batch_tile` and
`noise_tile`):

1. each present condition video is VAE-encoded and scaled by sigma_data
   (`encode_condition`), then the conditioning tensor is assembled with
   zeros and mask channels for the missing keys (`assemble_conditions`);
2. the EDM Euler loop runs the DiT, with classifier-free guidance on the
   batch axis (`make_denoise_fn`, `sample`);
3. the result is VAE-decoded, the normal pass renormalized and blended,
   and the video mapped to uint8 (`decode`).

Video tensors are channels-last (B, T, H, W, C) at the public functions;
pixel conditions travel channels-first into the VAE.  The random initial
state comes from seeded torch.Generators; `generate(x_init=...)` takes an
explicit one instead (the tests inject the same noise into both packages).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import RendererConfig, get_config_by_model_type, validate_config
from .models.dit import dit_forward
from .models.vae import vae_decode, vae_encode
from .sampling.edm import edm_sigmas, sample_edm
from .utils.device import synchronize
from .utils.hostops import to_float32
from .utils.layout import ncthw_to_nthwc, nthwc_to_ncthw

# Keys searched, in order, to infer the input dimensions.
SHAPE_INFERENCE_KEYS = (
    "rgb", "image", "basecolor", "normal", "depth", "roughness", "metallic",
)


class PixelInput(NamedTuple):
    """A pixel video already on the pipeline's device, channels-first
    (B, C, T, H, W): uint8 in [0, 255], or the compute dtype in [-1, 1].
    shape5 is the logical (B, T, H, W, C).  Built by
    DiffusionRendererPipeline.prepare_pixel_input, so that several
    generations share one upload."""

    arr: torch.Tensor
    shape5: Tuple[int, int, int, int, int]


def compute_dtype_of(cfg: RendererConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _cond_to_ncdhw(z: torch.Tensor, cfg: RendererConfig) -> torch.Tensor:
    """A channels-first condition, uint8 range-mapped [0, 255] -> [-1, 1] as
    x * (2/255) - 1 in the compute dtype, and a one-frame condition
    broadcast over the clip's frames."""
    if z.dtype == torch.uint8:
        dt = compute_dtype_of(cfg)
        z = (z.to(dt) * torch.tensor(2.0 / 255.0, dtype=dt, device=z.device)
             - torch.tensor(1.0, dtype=dt, device=z.device))
    if z.shape[2] == 1 and cfg.num_frames > 1:
        z = z.expand(-1, -1, cfg.num_frames, -1, -1)
    return z


def encode_condition(vae_params, x: torch.Tensor, *, cfg: RendererConfig) -> torch.Tensor:
    """VAE-encode one channels-first condition video, times sigma_data."""
    if x.dtype != torch.uint8:
        x = x.to(compute_dtype_of(cfg))
    z = vae_encode(vae_params, _cond_to_ncdhw(x, cfg), cfg.vae, in_layout="NCDHW")
    return z * cfg.sigma_data


def assemble_conditions(latents: Sequence[torch.Tensor], *, cfg: RendererConfig,
                        present: Tuple[bool, ...], tile: int = 1) -> torch.Tensor:
    """Concatenate the per-key latents (one per present key, in key order)
    with zeros for missing keys and a 0/1 mask channel per key when the
    config appends one; `tile` replicates the result on the batch axis."""
    it = iter(latents)
    ref = latents[0]
    b, t, h, w, c = ref.shape

    def filled(channels, value):
        return torch.full((b, t, h, w, channels), value, dtype=ref.dtype, device=ref.device)

    out = []
    for is_present in present:
        out.append(next(it) if is_present else filled(c, 0.0))
        if cfg.append_condition_mask:
            out.append(filled(1, 1.0 if is_present else 0.0))
    latent = torch.cat(out, dim=-1)
    if tile > 1:
        latent = latent.repeat(tile, 1, 1, 1, 1)
    return latent


def make_denoise_fn(dit_params, latent_condition: torch.Tensor, ctx: torch.Tensor,
                    guidance: float, *, cfg: RendererConfig, use_cfg: bool,
                    attn_backend: str = "auto"):
    """denoise_fn(x_scaled, sigma) -> F(x).  Under classifier-free guidance
    the (cond, uncond) pair rides the batch axis of one forward, combined
    as cond + g * (cond - uncond) in fp32."""
    dtype = compute_dtype_of(cfg)
    b = latent_condition.shape[0]
    if use_cfg:
        lc2 = torch.cat([latent_condition, torch.zeros_like(latent_condition)], dim=0)
        ctx2 = torch.cat([ctx, torch.zeros_like(ctx)], dim=0)
        g = torch.tensor(guidance, dtype=torch.float32, device=latent_condition.device)

        def denoise_fn(x_scaled, sigma):
            out2 = dit_forward(dit_params, torch.cat([x_scaled, x_scaled], dim=0),
                               sigma.to(dtype).expand(2 * b), lc2, ctx2, cfg.net,
                               attn_backend=attn_backend)
            out_c, out_u = out2[:b].float(), out2[b:].float()
            return (out_c + g * (out_c - out_u)).to(dtype)

        return denoise_fn

    def denoise_fn(x_scaled, sigma):
        return dit_forward(dit_params, x_scaled, sigma.to(dtype).expand(b),
                           latent_condition, ctx, cfg.net, attn_backend=attn_backend)

    return denoise_fn


def sample(dit_params, latent_condition: torch.Tensor, context_index: torch.Tensor,
           x: torch.Tensor, guidance: float, sigmas: torch.Tensor, *,
           cfg: RendererConfig, use_cfg: bool, attn_backend: str = "auto") -> torch.Tensor:
    """Run the Euler trajectory of x over the sigma table `sigmas`."""
    dtype = compute_dtype_of(cfg)
    latent_condition = latent_condition.to(dtype)
    ctx = context_index.reshape(latent_condition.shape[0]).long()
    denoise_fn = make_denoise_fn(dit_params, latent_condition, ctx, guidance, cfg=cfg,
                                 use_cfg=use_cfg, attn_backend=attn_backend)
    return sample_edm(denoise_fn, x.to(dtype), sigmas, cfg.scheduler.sigma_data)


def noise_init(seed: Union[int, Sequence[int]], sigma0: float, *, shape,
               noise_tile: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The initial state: N(0, 1) * sigma0.  An int seed draws
    shape[0] // noise_tile rows from one generator and tiles them
    noise_tile times; a sequence of seeds draws each row from its own
    generator, so a batched row equals a solo run with that seed."""
    def draw(s, rows):
        gen = torch.Generator(device).manual_seed(int(s))
        return torch.randn((rows, *shape[1:]), generator=gen, device=device,
                           dtype=torch.float32)

    if isinstance(seed, (list, tuple, np.ndarray)):
        noise = torch.cat([draw(s, 1) for s in seed], dim=0)
    else:
        noise = draw(seed, shape[0] // noise_tile).repeat(noise_tile, 1, 1, 1, 1)
    return (noise * sigma0).to(dtype)


def decode(vae_params, sample_: torch.Tensor, normal_mask: torch.Tensor, *,
           cfg: RendererConfig) -> torch.Tensor:
    """Decode, renormalize and blend the rows that normal_mask selects, and
    map [-1, 1] -> uint8 (B, T, H, W, C)."""
    dtype = compute_dtype_of(cfg)
    descaled = (sample_ / cfg.scheduler.sigma_data).to(dtype)
    video = vae_decode(vae_params, descaled, cfg.vae, out_layout="NCDHW").float()
    norm = torch.linalg.vector_norm(video, dim=1, keepdim=True)
    normalized = video / norm.clamp_min(1e-12)
    blend = ((norm - 0.2) / (0.4 - 0.2)).clamp(0.0, 1.0)
    renormed = normalized * blend + video * (1.0 - blend)
    sel = normal_mask.float()[:, None, None, None, None]
    video = renormed * sel + video * (1.0 - sel)
    u8 = ((1.0 + video).clamp(0.0, 2.0) / 2.0 * 255.0).to(torch.uint8)
    return ncthw_to_nthwc(u8)


class DiffusionRendererPipeline:
    """Holds the model parameters and runs generations on their device.

    Public surface of the JAX pipeline: set_model_type, generate, and the
    runtime guidance / num_steps / seed.  `timings` holds the wall seconds
    of the last generation's phases (encode, denoise, decode), each closed
    by a device synchronize."""

    def __init__(
        self,
        dit_params: Mapping[str, Any],
        vae_params: Mapping[str, Any],
        model_type: Optional[str] = "inverse",
        guidance: float = 0.0,
        num_steps: int = 15,
        seed: int = 42,
        compute_dtype: Optional[str] = None,
        net_config=None,
        vae_config=None,
    ):
        self.dit_params = dit_params
        self.vae_params = vae_params
        self.model_type = model_type.lower() if model_type else None
        self.guidance = guidance
        self.num_steps = num_steps
        self.seed = seed
        conv_w = vae_params["encoder"]["conv_in"]["conv_s"]["w"]
        self.device = conv_w.device
        if compute_dtype is None:
            # Follow the weights: fp32 parameters run fp32, bf16 run bf16.
            compute_dtype = "float32" if conv_w.dtype == torch.float32 else "bfloat16"
        self.compute_dtype = compute_dtype
        self.net_config = net_config
        self.vae_config = vae_config
        self.timings: Dict[str, float] = {}

    def set_model_type(self, model_type: str) -> None:
        """Inverse and forward use different checkpoints; switching only
        changes the config (the weights are checked at generate time)."""
        self.model_type = model_type.lower()

    def prepare_pixel_input(self, video) -> PixelInput:
        """Upload a host (B, T, H, W, C) video (uint8, or floats in [-1, 1])
        once, channels-first on the pipeline's device, for any number of
        generate() calls."""
        shape5 = tuple(np.shape(video))
        return PixelInput(self._upload(video), shape5)

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, PixelInput):
            return x.arr
        if isinstance(x, torch.Tensor):
            t = x
        else:
            arr = np.asarray(x)
            t = torch.from_numpy(arr if arr.dtype == np.uint8 else to_float32(arr))
        if t.dtype != torch.uint8:
            t = t.to(torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32)
        return nthwc_to_ncthw(t.to(self.device))

    def _config_for(self, shape_5d: Tuple[int, ...]) -> RendererConfig:
        _, t, h, w, _ = shape_5d
        cfg = get_config_by_model_type(self.model_type, height=h, width=w, num_frames=t,
                                       compute_dtype=self.compute_dtype)
        if self.net_config is not None:
            cfg = dataclasses.replace(cfg, net=self.net_config)
        if self.vae_config is not None:
            cfg = dataclasses.replace(cfg, vae=self.vae_config)
        validate_config(cfg)
        patch_dim = self.dit_params["x_embedder"]["weight"].shape[1]
        if patch_dim != cfg.net.patch_dim:
            raise ValueError(
                f"Loaded DiT weights have patch_dim {patch_dim} but model_type "
                f"{self.model_type!r} needs {cfg.net.patch_dim}. Load the "
                f"matching checkpoint (inverse=132, forward=612).")
        return cfg

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0

    @torch.inference_mode()
    def generate(
        self,
        data_batch: Mapping[str, Any],
        normalize_normal=False,
        seed: Union[int, Sequence[int], None] = None,
        noise_tile: int = 1,
        batch_tile: int = 1,
        x_init: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """Run one generation; returns uint8 (B, T, H, W, C) on the host.

        data_batch maps condition keys to (B, T, H, W, C) videos (host
        arrays, tensors or PixelInputs) and may hold a (B,) context_index.
        batch_tile=n encodes the condition video once and replicates its
        latent n-fold (the batched multi-pass inverse job); noise_tile=n
        replicates one noise draw over n row groups; a sequence of seeds
        gives each row its own.  x_init, when given, is the initial state
        (B, T', H', W', C_lat), already scaled by sigma_max."""
        if self.model_type is None:
            raise RuntimeError("model_type not set; call set_model_type first")
        shape_key = next((k for k in SHAPE_INFERENCE_KEYS if k in data_batch), None)
        if shape_key is None:
            raise ValueError(f"No tensor for shape inference; looked for {SHAPE_INFERENCE_KEYS}")
        sval = data_batch[shape_key]
        shape5 = tuple(sval.shape5) if isinstance(sval, PixelInput) else tuple(np.shape(sval))
        cfg = self._config_for(shape5)
        dtype = compute_dtype_of(cfg)
        present = tuple((k in data_batch) or (k == "image" and "rgb" in data_batch)
                        for k in cfg.condition_keys)

        b = shape5[0] * batch_tile
        ctx = data_batch.get("context_index")
        ctx = (torch.zeros(b, dtype=torch.long, device=self.device) if ctx is None
               else torch.as_tensor(np.asarray(ctx)).reshape(b).long().to(self.device))
        seed = self.seed if seed is None else seed
        per_row = isinstance(seed, (list, tuple, np.ndarray))
        if per_row:
            seed = [int(s) for s in np.asarray(seed).reshape(-1)]
            if len(seed) != b:
                raise ValueError(f"got {len(seed)} per-row seeds for batch of {b}")
            if noise_tile != 1:
                raise ValueError("per-row seeds and noise_tile are exclusive")
        if isinstance(normalize_normal, bool):
            normal_mask = torch.full((b,), float(normalize_normal), device=self.device)
        else:
            normal_mask = torch.as_tensor(
                np.asarray(normalize_normal, np.float32)).reshape(b).to(self.device)

        with self._phase("encode"):
            latents = []
            for i, key in enumerate(cfg.condition_keys):
                if present[i]:
                    src = key if key in data_batch else "rgb"
                    latents.append(encode_condition(
                        self.vae_params, self._upload(data_batch[src]), cfg=cfg))
            latent_condition = assemble_conditions(latents, cfg=cfg, present=present,
                                                   tile=batch_tile)
            del latents
        with self._phase("denoise"):
            sigmas = edm_sigmas(self.num_steps, cfg.scheduler.sigma_max,
                                cfg.scheduler.sigma_min)
            state_shape = (*latent_condition.shape[:4], cfg.vae.latent_channels)
            if x_init is not None:
                if tuple(x_init.shape) != state_shape:
                    raise ValueError(f"x_init has shape {tuple(x_init.shape)}, "
                                     f"expected {state_shape}")
                x = x_init.to(device=self.device, dtype=dtype)
            else:
                x = noise_init(seed, float(sigmas[0]), shape=state_shape,
                               noise_tile=noise_tile, dtype=dtype, device=self.device)
            x = sample(self.dit_params, latent_condition, ctx, x, self.guidance, sigmas,
                       cfg=cfg, use_cfg=self.guidance > 0)
            del latent_condition
        with self._phase("decode"):
            video_u8 = decode(self.vae_params, x, normal_mask, cfg=cfg).cpu().numpy()
        return video_u8
