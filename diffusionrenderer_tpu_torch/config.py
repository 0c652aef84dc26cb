"""Configuration system of the PyTorch port (a copy of diffusionrenderer_tpu/config.py).

Dataclass-based replacement for the reference's plain-dict config system
(diffusion_renderer_config.py:24-366).  Semantics preserved:

* FADITV2_7B network architecture   (ref: diffusion_renderer_config.py:47-103)
* EDM Euler scheduler constants      (ref: diffusion_renderer_config.py:106-118)
* VAE compression ratios             (ref: diffusion_renderer_config.py:121-128)
* inverse config: condition_keys=['rgb'], additional_concat_ch=16,
  use_context_embedding=True, no condition mask
                                     (ref: diffusion_renderer_config.py:131-188)
* forward config: 8 condition keys, additional_concat_ch=17*8=136, mask on
                                     (ref: diffusion_renderer_config.py:191-251)
* shape-derived config generation    (ref: diffusion_renderer_config.py:277-305)
* validation                         (ref: diffusion_renderer_config.py:308-348)
* named presets                      (ref: diffusion_renderer_config.py:352-366)

Everything is hashable/frozen, and config_hash() hashes the same JSON as the
JAX package, so both packages give one config the same identity.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

# Official G-buffer pass -> context_index mapping (ref: nodes.py:35-41).
GBUFFER_INDEX_MAPPING: Dict[str, int] = {
    "basecolor": 0,
    "metallic": 1,
    "roughness": 2,
    "normal": 3,
    "depth": 4,
}

INVERSE_CONDITION_KEYS: Tuple[str, ...] = ("rgb",)
FORWARD_CONDITION_KEYS: Tuple[str, ...] = (
    "basecolor",
    "normal",
    "metallic",
    "roughness",
    "depth",
    "env_ldr",
    "env_log",
    "env_nrm",
)


@dataclass(frozen=True)
class DiTConfig:
    """GeneralDIT (FADITV2_7B) architecture.

    Field values mirror diffusion_renderer_config.py:47-103 and
    the renderer-subclass overrides at CleanGeneralDIT.py:721-727
    (use_adaln_lora forced True, adaln_lora_dim 256, patch-embed bias off).
    """

    model_channels: int = 4096
    num_blocks: int = 28
    num_heads: int = 32
    in_channels: int = 16
    out_channels: int = 16
    # Condition channels concatenated onto the noised latent on the channel
    # axis: 16 for inverse (rgb latent), 17*8=136 for forward.
    additional_concat_ch: int = 16
    concat_padding_mask: bool = True
    patch_spatial: int = 2
    patch_temporal: int = 1
    mlp_ratio: float = 4.0
    crossattn_emb_channels: int = 1024
    adaln_lora_dim: int = 256
    use_adaln_lora: bool = True
    affline_emb_norm: bool = True
    patch_embed_bias: bool = False
    # RoPE NTK extrapolation ratios (ref: diffusion_renderer_config.py:87-89,
    # CleanGeneralDIT.py:113-117).
    rope_h_extrapolation_ratio: float = 1.0
    rope_w_extrapolation_ratio: float = 1.0
    rope_t_extrapolation_ratio: float = 2.0
    # Inverse renderer selects the G-buffer pass via a learned 16-entry
    # embedding table over context_index (ref: CleanGeneralDIT.py:728-737);
    # forward renderer uses a zero context (ref: CleanGeneralDIT.py:738-742).
    use_context_embedding: bool = True
    num_context_embeddings: int = 16

    @property
    def head_dim(self) -> int:
        return self.model_channels // self.num_heads

    @property
    def total_in_channels(self) -> int:
        """Channels entering the patch embed: [x, latent_condition, pad mask]
        concatenated on C (ref: CleanGeneralDIT.py:669-675)."""
        return (
            self.in_channels
            + self.additional_concat_ch
            + (1 if self.concat_padding_mask else 0)
        )

    @property
    def patch_dim(self) -> int:
        return self.total_in_channels * self.patch_spatial**2 * self.patch_temporal

    @property
    def hidden_dim(self) -> int:
        return int(self.model_channels * self.mlp_ratio)


@dataclass(frozen=True)
class SchedulerConfig:
    """EDM Euler scheduler constants (ref: model_diffusion_renderer.py:16-28,
    diffusion_renderer_config.py:106-118)."""

    sigma_max: float = 80.0
    sigma_min: float = 0.02
    sigma_data: float = 0.5


@dataclass(frozen=True)
class VAEConfig:
    """Cosmos-1.0-Tokenizer-CV8x8x8 architecture, reconstructed from the
    shipped diffusers config (VAE_config.json) rather than
    from diffusers code: 8x spatial / 8x temporal compression, 16 latent
    channels, Haar wavelet patching with patch_size 4, causal in time."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    encoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decode_block_out_channels: Tuple[int, ...] = (256, 512, 512, 512)
    num_layers: int = 2  # resblocks per level (VAE_config.json "num_layers")
    patch_size: int = 4
    patch_type: str = "haar"
    spatial_compression_ratio: int = 8
    temporal_compression_ratio: int = 8
    scaling_factor: float = 1.0
    # Max latent frames covered by the per-(channel, frame) latent statistics
    # vectors (256 entries = 16 channels x 16 frames, VAE_config.json:21-535).
    max_latent_frames: int = 16
    # --- Convention switches ------------------------------------------------
    # Three conventions of the diffusers AutoencoderKLCosmos implementation
    # that were reconstructed from its config rather than observed against a
    # real checkpoint (NOTES.md item 1).  Defaults are the believed-correct
    # conventions; each switch makes the alternative a config flip instead of
    # a code change, and checkpoint_vae.calibrate_vae_conventions detects a
    # wrong choice at convert time from the constant-frame roundtrip
    # invariant.
    # Haar analysis rescale per level: 'gain1' = entries +-1/8 (diffusers
    # rescale=True; DC gain exactly 1) | 'orthonormal' = +-1/sqrt8 per level.
    dwt_rescale: str = "gain1"
    # CosmosCausalGroupNorm checkpoint keys: 'nested' = '<mod>.norm.weight'
    # (a GroupNorm submodule) | 'flat' = '<mod>.weight'.
    norm_nesting: str = "nested"
    # Where latents_mean/std normalization is applied: 'encode' = inside
    # vae_encode/vae_decode (diffusers applies them inside encode/decode) |
    # 'external' = caller's responsibility, encode returns raw latents.
    stats_location: str = "encode"

    def latent_num_frames(self, num_pixel_frames: int) -> int:
        """Causal frame math (ref: CleanVAE.py:34-37)."""
        if num_pixel_frames == 1:
            return 1
        return (num_pixel_frames - 1) // self.temporal_compression_ratio + 1

    def pixel_num_frames(self, num_latent_frames: int) -> int:
        """(ref: CleanVAE.py:39-42)"""
        if num_latent_frames == 1:
            return 1
        return (num_latent_frames - 1) * self.temporal_compression_ratio + 1


@dataclass(frozen=True)
class RendererConfig:
    """One fully-resolved renderer configuration (inverse or forward)."""

    model_type: str  # "inverse" | "forward"
    height: int = 704
    width: int = 1280
    num_frames: int = 57
    sigma_data: float = 0.5
    condition_keys: Tuple[str, ...] = INVERSE_CONDITION_KEYS
    condition_drop_rate: float = 0.1
    append_condition_mask: bool = False
    input_data_key: str = "video"
    guidance: float = 0.0
    num_steps: int = 15
    net: DiTConfig = field(default_factory=DiTConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    # Numerics policy: 'bfloat16' runs block bodies in bf16 with fp32
    # accumulation (production); 'float32' reproduces the reference's fp32
    # block-body autocast (ref: CleanGeneralDIT.py:509) for parity testing.
    compute_dtype: str = "bfloat16"

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        """[C, T, H, W] of the diffusion state
        (ref: diffusion_renderer_pipeline.py:270-278)."""
        return (
            self.vae.latent_channels,
            self.vae.latent_num_frames(self.num_frames),
            self.height // self.vae.spatial_compression_ratio,
            self.width // self.vae.spatial_compression_ratio,
        )

    def config_hash(self) -> str:
        """Deterministic identity, replacing the reference's md5-of-JSON
        cache key (ref: diffusion_renderer_pipeline.py:159-166)."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.md5(payload.encode()).hexdigest()


def get_inverse_renderer_config(
    height: int = 704,
    width: int = 1280,
    num_frames: int = 57,
    **overrides: Any,
) -> RendererConfig:
    """Inverse renderer (RGB video -> G-buffers).
    Mirrors diffusion_renderer_config.py:131-188."""
    net = overrides.pop(
        "net", DiTConfig(additional_concat_ch=16, use_context_embedding=True)
    )
    return RendererConfig(
        model_type="inverse",
        height=height,
        width=width,
        num_frames=num_frames,
        condition_keys=INVERSE_CONDITION_KEYS,
        condition_drop_rate=0.1,
        append_condition_mask=False,
        net=net,
        **overrides,
    )


def get_forward_renderer_config(
    height: int = 704,
    width: int = 1280,
    num_frames: int = 57,
    **overrides: Any,
) -> RendererConfig:
    """Forward renderer (G-buffers + env maps -> RGB).
    Mirrors diffusion_renderer_config.py:191-251."""
    net = overrides.pop(
        "net",
        DiTConfig(additional_concat_ch=17 * 8, use_context_embedding=False),
    )
    return RendererConfig(
        model_type="forward",
        height=height,
        width=width,
        num_frames=num_frames,
        condition_keys=FORWARD_CONDITION_KEYS,
        condition_drop_rate=0.05,
        append_condition_mask=True,
        net=net,
        **overrides,
    )


def get_config_by_model_type(
    model_type: str,
    height: int = 704,
    width: int = 1280,
    num_frames: int = 57,
    **overrides: Any,
) -> RendererConfig:
    """(ref: diffusion_renderer_config.py:254-274)"""
    model_type = model_type.lower()
    if model_type == "inverse":
        return get_inverse_renderer_config(height, width, num_frames, **overrides)
    if model_type == "forward":
        return get_forward_renderer_config(height, width, num_frames, **overrides)
    raise ValueError(
        f"Unknown model type: {model_type!r}. Must be 'inverse' or 'forward'."
    )


def get_config_from_tensor_shape(
    model_type: str, tensor_shape: Tuple[int, ...], **overrides: Any
) -> RendererConfig:
    """Derive a config from a 5D (B, C, T, H, W) input tensor shape
    (ref: diffusion_renderer_config.py:277-305)."""
    if len(tensor_shape) != 5:
        raise ValueError(
            f"Expected a 5D tensor shape, got {len(tensor_shape)} dimensions."
        )
    _, _, t, h, w = tensor_shape
    return get_config_by_model_type(model_type, height=h, width=w, num_frames=t,
                                    **overrides)


def validate_config(config: RendererConfig) -> None:
    """Structural validation (ref: diffusion_renderer_config.py:308-348)."""
    if config.model_type not in ("inverse", "forward"):
        raise ValueError(f"Invalid model_type: {config.model_type}")
    c, t, h, w = config.latent_shape
    if c != config.vae.latent_channels:
        raise ValueError("latent channel mismatch")
    if t < 1 or h < 1 or w < 1:
        raise ValueError(f"Degenerate latent shape {config.latent_shape}")
    if config.height % config.vae.spatial_compression_ratio:
        raise ValueError(f"height {config.height} not divisible by "
                         f"{config.vae.spatial_compression_ratio}")
    if config.width % config.vae.spatial_compression_ratio:
        raise ValueError(f"width {config.width} not divisible by "
                         f"{config.vae.spatial_compression_ratio}")
    if h % config.net.patch_spatial or w % config.net.patch_spatial:
        raise ValueError("latent spatial dims not divisible by patch size")
    if t % config.net.patch_temporal:
        raise ValueError("latent temporal dim not divisible by patch size")
    if config.net.model_channels % config.net.num_heads:
        raise ValueError("model_channels must divide evenly into heads")
    expected_concat = 16 if config.model_type == "inverse" else 17 * 8
    if config.net.additional_concat_ch != expected_concat:
        raise ValueError(
            f"additional_concat_ch {config.net.additional_concat_ch} does not "
            f"match model_type {config.model_type} (expected {expected_concat})"
        )


def get_preset_config(preset_name: str) -> RendererConfig:
    """Named presets (ref: diffusion_renderer_config.py:352-366)."""
    presets = {
        "inverse_1024x1024": lambda: get_inverse_renderer_config(1024, 1024, 1),
        "forward_1024x1024": lambda: get_forward_renderer_config(1024, 1024, 1),
        "inverse_704x1280_video": lambda: get_inverse_renderer_config(704, 1280, 57),
        "forward_704x1280_video": lambda: get_forward_renderer_config(704, 1280, 57),
    }
    if preset_name not in presets:
        raise ValueError(
            f"Unknown preset: {preset_name}. Available: {sorted(presets)}"
        )
    return presets[preset_name]()


PRESET_NAMES = (
    "inverse_1024x1024",
    "forward_1024x1024",
    "inverse_704x1280_video",
    "forward_704x1280_video",
)
