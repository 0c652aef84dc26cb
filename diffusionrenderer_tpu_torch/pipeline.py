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
   and the video mapped to uint8 (`decode`); with `decode_chunk_frames`
   set, in overlapping latent-time chunks (`_decode_overlapped`), which
   bounds the decoder's peak memory on long clips.

Video tensors are channels-last (B, T, H, W, C) at the public functions;
pixel conditions travel channels-first into the VAE.  The random initial
state comes from seeded torch.Generators; `generate(x_init=...)` takes an
explicit one instead (the tests inject the same noise into both packages).

`DiffusionRendererPipeline.shard(mesh)` runs generations over a (data, seq,
tensor) mesh of torch.distributed ranks (parallel/sharding.py): batch rows
split over data when they divide it, DiT tokens over seq, the DiT's heads
and MLP over tensor, and every rank returns the whole result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import RendererConfig, VAEConfig, get_config_by_model_type, validate_config
from .models.dit import dit_forward
from .models.vae import vae_decode, vae_encode
from .parallel.sharding import batch_rows_split, batch_slice, gather_batch
from .sampling.edm import edm_sigmas, sample_edm
from .utils.device import synchronize
from .utils.hostops import to_float32
from .utils.layout import ncthw_to_nthwc, nthwc_to_ncthw
from .utils.profiling import metrics

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
                    attn_backend: str = "auto", mesh=None):
    """denoise_fn(x_scaled, sigma) -> F(x).  Under classifier-free guidance
    the (cond, uncond) pair rides the batch axis of one forward, combined
    as cond + g * (cond - uncond) in fp32.  mesh: dit_forward's."""
    dtype = compute_dtype_of(cfg)
    b = latent_condition.shape[0]
    if use_cfg:
        lc2 = torch.cat([latent_condition, torch.zeros_like(latent_condition)], dim=0)
        ctx2 = torch.cat([ctx, torch.zeros_like(ctx)], dim=0)
        g = torch.tensor(guidance, dtype=torch.float32, device=latent_condition.device)

        def denoise_fn(x_scaled, sigma):
            out2 = dit_forward(dit_params, torch.cat([x_scaled, x_scaled], dim=0),
                               sigma.to(dtype).expand(2 * b), lc2, ctx2, cfg.net,
                               attn_backend=attn_backend, mesh=mesh)
            out_c, out_u = out2[:b].float(), out2[b:].float()
            return (out_c + g * (out_c - out_u)).to(dtype)

        return denoise_fn

    def denoise_fn(x_scaled, sigma):
        return dit_forward(dit_params, x_scaled, sigma.to(dtype).expand(b),
                           latent_condition, ctx, cfg.net, attn_backend=attn_backend, mesh=mesh)

    return denoise_fn


def sample(dit_params, latent_condition: torch.Tensor, context_index: torch.Tensor,
           x: torch.Tensor, guidance: float, sigmas: torch.Tensor, *,
           cfg: RendererConfig, use_cfg: bool, attn_backend: str = "auto",
           mesh=None) -> torch.Tensor:
    """Run the Euler trajectory of x over the sigma table `sigmas`."""
    dtype = compute_dtype_of(cfg)
    latent_condition = latent_condition.to(dtype)
    ctx = context_index.reshape(latent_condition.shape[0]).long()
    denoise_fn = make_denoise_fn(dit_params, latent_condition, ctx, guidance, cfg=cfg,
                                 use_cfg=use_cfg, attn_backend=attn_backend, mesh=mesh)
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
    by a device synchronize; the same seconds go to the metrics registry
    (utils/profiling.metrics) as generate/encode_conditions,
    generate/denoise and generate/decode, and the whole call as
    generate/{model_type}.  After shard(mesh), `mesh` is this rank's
    parallel.sharding.Mesh and `sp_attn` the DiT's attention backend under
    it.  decode_chunk_frames, when set below the clip's latent frame count,
    decodes it in chunks of that many latent frames (_decode_overlapped)."""

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
        self.mesh = None
        self.sp_attn = "auto"
        # Latent frames per decode chunk (None: one decode).  Each chunk
        # restarts the decoder's causal state one latent early, the
        # reference's own long-video behaviour.
        self.decode_chunk_frames: Optional[int] = None

    def shard(self, mesh, sp_attn: Optional[str] = None) -> "DiffusionRendererPipeline":
        """Run generations over a (data, seq, tensor) mesh
        (parallel.sharding.make_mesh or make_hybrid_mesh; every rank builds
        the same pipeline and calls generate alike).  With tensor > 1 the
        DiT's block matmuls are cut to this rank's Megatron shard
        (parallel.dit_param_shardings) and the whole weights freed; the VAE
        stays whole on every rank.  sp_attn overrides the DiT's attention
        under the mesh: 'auto', 'flash_sp', 'ring', or an ops.attention
        backend run on the all-gathered KV."""
        from .parallel.sharding import dit_param_shardings, shard_params, vae_param_shardings

        if self.mesh is not None and self.mesh.tensor > 1:
            raise ValueError("the pipeline's DiT is already cut to a tensor-parallel shard")
        if sp_attn is not None:
            self.sp_attn = sp_attn
        self.dit_params = shard_params(self.dit_params,
                                       dit_param_shardings(self.dit_params, mesh))
        self.vae_params = shard_params(self.vae_params,
                                       vae_param_shardings(self.vae_params, mesh))
        if mesh.tensor > 1 and self.device.type == "cuda":
            torch.cuda.empty_cache()  # the whole weights' blocks, for the other ranks
        self.mesh = mesh
        return self

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

    def _vae_cfg(self, cfg: Optional[RendererConfig]) -> VAEConfig:
        if cfg is not None:
            return cfg.vae
        return self.vae_config if self.vae_config is not None else VAEConfig()

    def encode(self, x: torch.Tensor, cfg: Optional[RendererConfig] = None) -> torch.Tensor:
        """VAE encode with the EDM scaling vae.encode(x) * sigma_data;
        x: (B, T, H, W, 3) in [-1, 1]."""
        sd = cfg.sigma_data if cfg is not None else 0.5
        return vae_encode(self.vae_params, x, self._vae_cfg(cfg)) * sd

    def decode(self, z: torch.Tensor, cfg: Optional[RendererConfig] = None) -> torch.Tensor:
        """VAE decode with the EDM scaling vae.decode(z / sigma_data)."""
        sd = cfg.sigma_data if cfg is not None else 0.5
        return vae_decode(self.vae_params, z / sd, self._vae_cfg(cfg))

    def reset_dtype(self, dtype: torch.dtype) -> None:
        """Cast the weights to `dtype`, with the JAX package's rule on its
        stacked tree: int8 leaves, the quantization scales ('s', 'sa') and
        1-D leaves stay as they are.  A per-block leaf of the port counts
        the JAX package's stacked block axis, so a block's (D,) norm weight
        is cast as JAX's (nb, D) one is."""
        def cast(tree, path=(), ndim_extra=0):
            if isinstance(tree, dict):
                return {k: cast(v, path + (k,), ndim_extra) for k, v in tree.items()}
            if isinstance(tree, list):
                extra = 1 if path and path[-1] == "blocks" else 0
                return [cast(v, path, ndim_extra + extra) for v in tree]
            if any(k in ("s", "sa") for k in path) or tree.dtype == torch.int8:
                return tree
            return tree.to(dtype) if tree.dim() + ndim_extra > 1 else tree

        self.dit_params = cast(self.dit_params)
        self.vae_params = cast(self.vae_params)

    def _decode_overlapped(self, sample: torch.Tensor, normal_mask: torch.Tensor,
                           cfg: RendererConfig, chunk: int, overlap: int = 1) -> np.ndarray:
        """Decode latent-time chunks of `chunk` latents, each after the first
        starting `overlap` latents early (causal context) and keeping only
        its frames past the overlap; uint8 (B, (T_lat-1)*8+1, H, W, C) on
        the host.  The first chunk's frames are exactly the unchunked
        decode's.  Batch rows decode one at a time (the decoder's peak grows
        with them too).  Every chunk is queued before the first is fetched,
        so each fetch overlaps the next chunk's decode."""
        if sample.shape[0] > 1:
            return np.concatenate([
                self._decode_overlapped(sample[i:i + 1], normal_mask[i:i + 1], cfg, chunk,
                                        overlap)
                for i in range(sample.shape[0])], axis=0)
        t_lat = sample.shape[1]
        step = chunk - overlap
        if step < 1:
            raise ValueError(f"decode chunk {chunk} must exceed the overlap {overlap}")
        queued = []
        start = 0
        while start < t_lat:
            length = min(chunk, t_lat - start)
            if start > 0 and length <= overlap:
                break  # fully covered by the previous chunk
            queued.append((start, length,
                           decode(self.vae_params, sample[:, start:start + length],
                                  normal_mask, cfg=cfg)))
            start += step
        pieces = []
        for start, length, video in queued:
            keep = (video.shape[1] if start == 0
                    else cfg.vae.temporal_compression_ratio * (length - overlap))
            pieces.append(video[:, -keep:].cpu().numpy())
        return np.concatenate(pieces, axis=1)

    @contextlib.contextmanager
    def _phase(self, metric: str, timing: Optional[str] = None):
        """Time a phase up to a device synchronize: the seconds go to the
        metrics registry under `metric` and, when `timing` is given, to
        timings[timing]; one clock for both."""
        t0 = time.perf_counter()
        try:
            yield
            synchronize(self.device)
        finally:
            seconds = time.perf_counter() - t0
            if timing is not None:
                self.timings[timing] = seconds
            metrics.record(metric, seconds)

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
        (B, T', H', W', C_lat), already scaled by sigma_max.

        On a sharded pipeline the B rows split over the mesh's data axis
        when they divide it (before the encode when batch_tile is 1, after
        the tiling otherwise) and are replicated when they do not; the noise
        is drawn for all rows on every rank and then sliced, so the result
        equals an unsharded run's; every rank returns all B rows."""
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

        mesh = self.mesh
        split = mesh is not None and batch_rows_split(b, mesh)
        pre_split = split and batch_tile == 1  # slice the pixel rows before the encode
        rows = (lambda x: batch_slice(x, mesh)) if split else (lambda x: x)  # noqa: E731

        with self._phase(f"generate/{self.model_type}"):
            with self._phase("generate/encode_conditions", "encode"):
                latents = []
                for i, key in enumerate(cfg.condition_keys):
                    if present[i]:
                        src = key if key in data_batch else "rgb"
                        pixels = self._upload(data_batch[src])
                        latents.append(encode_condition(
                            self.vae_params, rows(pixels) if pre_split else pixels, cfg=cfg))
                latent_condition = assemble_conditions(latents, cfg=cfg, present=present,
                                                       tile=batch_tile)
                if split and not pre_split:
                    latent_condition = rows(latent_condition)
                del latents
            with self._phase("generate/denoise", "denoise"):
                sigmas = edm_sigmas(self.num_steps, cfg.scheduler.sigma_max,
                                    cfg.scheduler.sigma_min)
                state_shape = (b, *latent_condition.shape[1:4], cfg.vae.latent_channels)
                if x_init is not None:
                    if tuple(x_init.shape) != state_shape:
                        raise ValueError(f"x_init has shape {tuple(x_init.shape)}, "
                                         f"expected {state_shape}")
                    x = x_init.to(device=self.device, dtype=dtype)
                else:
                    x = noise_init(seed, float(sigmas[0]), shape=state_shape,
                                   noise_tile=noise_tile, dtype=dtype, device=self.device)
                x = sample(self.dit_params, latent_condition, rows(ctx), rows(x), self.guidance,
                           sigmas, cfg=cfg, use_cfg=self.guidance > 0,
                           attn_backend="auto" if mesh is None else self.sp_attn, mesh=mesh)
                del latent_condition
            with self._phase("generate/decode", "decode"):
                ck = self.decode_chunk_frames
                if ck and x.shape[1] > ck:
                    video_u8 = self._decode_overlapped(x, rows(normal_mask), cfg, ck)
                    if split:
                        video_u8 = gather_batch(torch.from_numpy(video_u8).to(self.device),
                                                mesh, b).cpu().numpy()
                else:
                    video = decode(self.vae_params, x, rows(normal_mask), cfg=cfg)
                    if split:
                        video = gather_batch(video, mesh, b)
                    video_u8 = video.cpu().numpy()
        return video_u8
