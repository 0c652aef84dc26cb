"""VAE checkpoint I/O (counterpart of diffusionrenderer_tpu/checkpoint_vae.py).

Two formats:

1. **Diffusers AutoencoderKLCosmos**, the Cosmos-1.0-Tokenizer-CV8x8x8
   directory the reference loads with from_pretrained: factorized convs
   `<conv>.conv_s` / `<conv>.conv_t`, norms nesting a GroupNorm as
   `<norm>.norm` (VAEConfig.norm_nesting), hybrid samplers' conv1..conv3,
   and diffusers Attention in the mid block.  Its conv weights
   (Cout, Cin, kt, kh, kw) and dense weights (out, in) are already the
   port's layouts: the converter maps keys, as the JAX package's does, and
   transposes nothing.  Strict: a missing key raises KeyError, an
   unconsumed one ValueError.
2. **Native**: a flat safetensors file of a parameter tree with '/'-joined
   keys.  The port writes its own layout (metadata layout=torch) and reads
   both its own files and the JAX package's (DHWIO conv weights, (in, out)
   dense weights, through checkpoint.vae_params_from_numpy).  The JAX
   package's orbax directories are n/a on CUDA and raise.

latents_mean / latents_std come from the config.json beside the weights
(models.vae.load_latent_stats); a flagship CV8x8x8 load that finds none
falls back to the table bundled in data/, so identity statistics never
reach a flagship pipeline silently.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .checkpoint import (_cast_weights, _flatten, _get, _listify, _refuse_orbax, _set,
                         _unflatten, vae_params_from_numpy)
from .config import VAEConfig
from .models.vae import init_vae_params, load_latent_stats, vae_decode, vae_encode
from .utils.device import DeviceLike, resolve_device
from .utils.safetensors import SafetensorsFile, read_header, write_safetensors

Params = Dict[str, Any]
logger = logging.getLogger(__name__)

# The flagship Cosmos-1.0-Tokenizer-CV8x8x8 architecture (VAE_config.json),
# the only checkpoint family whose latent statistics are bundled.
_FLAGSHIP_ENC_CHANNELS = (128, 256, 512, 512)
_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors")
_TORCH_LAYOUT = "torch"


def bundled_latent_stats() -> Dict[str, Any]:
    """The published per-(channel, latent-frame) CV8x8x8 statistics (256
    mean and 256 std entries, a copy of the JAX package's table)."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "cosmos_cv8x8x8_latent_stats.json")
    with open(path) as f:
        return json.load(f)


def _is_flagship_vae(cfg: VAEConfig) -> bool:
    return (cfg.latent_channels == 16 and cfg.max_latent_frames == 16
            and tuple(cfg.encoder_block_out_channels) == _FLAGSHIP_ENC_CHANNELS)


def _identity_stats(params: Params) -> bool:
    mean, std = params.get("latents_mean"), params.get("latents_std")
    return bool(torch.all(torch.as_tensor(mean) == 0.0)) and bool(
        torch.all(torch.as_tensor(std) == 1.0))


def ensure_latent_stats(params: Params, cfg: VAEConfig) -> Params:
    """Install the bundled CV8x8x8 statistics when a flagship-config load
    left identity ones (no config.json, or one without statistics).
    Non-flagship configs pass through: there is no table for them, and
    identity is right for random weights."""
    if not _is_flagship_vae(cfg) or not _identity_stats(params):
        return params
    logger.info("VAE checkpoint carried no latents_mean/std; installing the "
                "bundled CV8x8x8 statistics table")
    stats = bundled_latent_stats()
    return load_latent_stats(params, stats["latents_mean"], stats["latents_std"], cfg)


def refuse_identity_stats(params: Params, cfg: VAEConfig, source: str) -> None:
    """Raise when a flagship VAE carries identity latents_mean / std: they
    would corrupt every latent silently."""
    if _is_flagship_vae(cfg) and _identity_stats(params):
        raise ValueError(
            f"VAE checkpoint {source!r} has identity "
            "latents_mean/std at the flagship CV8x8x8 architecture — "
            "this silently corrupts every latent.  Re-convert the "
            "checkpoint (the converter now bundles the statistics "
            "table), or pass vae_config_json pointing at the diffusers "
            "config.json.")


# ---------------------------------------------------------------------------
# Native flat format
# ---------------------------------------------------------------------------

def save_vae_native(path: str, params: Params) -> None:
    """Write the port's VAE parameters, as stored, to one flat safetensors
    file ('/'-joined keys, the port's layouts)."""
    write_safetensors(path, _flatten(params), {"layout": _TORCH_LAYOUT})


def load_vae_native(path: str, dtype: torch.dtype = torch.bfloat16,
                    cfg: Optional[VAEConfig] = None, *,
                    device: DeviceLike = None) -> Params:
    """A native VAE file -> the port's parameters on `device`, weights and
    biases in `dtype`, norms and statistics fp32.  A file the JAX package
    wrote (no layout metadata: DHWIO convs, (in, out) dense weights) goes
    through checkpoint.vae_params_from_numpy against `cfg` (the flagship
    when None)."""
    device = resolve_device(device)
    _, meta = read_header(path)
    if meta.get("layout") == _TORCH_LAYOUT:
        with SafetensorsFile(path, device) as f:
            return _cast_weights(_unflatten({k: f[k] for k in f}), dtype)
    with SafetensorsFile(path) as f:
        flat = {k: f[k].numpy() for k in f}
    return vae_params_from_numpy(flat, cfg if cfg is not None else VAEConfig(),
                                 device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Diffusers conversion
# ---------------------------------------------------------------------------

Path = Tuple[Any, ...]


def _diffusers_key_map(cfg: VAEConfig) -> List[Tuple[str, Path, Optional[str]]]:
    """(diffusers key, path in the port's tree, the key a norm would have
    under the other norm_nesting convention or None) of every VAE weight, in
    the order the JAX package's converter reads them."""
    template = init_vae_params(cfg, device="meta", dtype=torch.float32)
    nested = cfg.norm_nesting == "nested"
    m: List[Tuple[str, Path, Optional[str]]] = []

    def conv(path: Path, key: str) -> None:
        m.extend([(key + ".weight", path + ("w",), None), (key + ".bias", path + ("b",), None)])

    def conv_proj(path: Path, key: str) -> None:
        conv(path + ("conv_s",), key + ".conv_s")
        conv(path + ("conv_t",), key + ".conv_t")

    def norm(path: Path, key: str) -> None:
        # CosmosCausalGroupNorm keys: 'nested' = the GroupNorm lives at
        # '<mod>.norm.*'; 'flat' = the affine parameters sit on the module.
        infix, other = (".norm", "") if nested else ("", ".norm")
        for ours, theirs in (("scale", "weight"), ("bias", "bias")):
            m.append((f"{key}{infix}.{theirs}", path + (ours,), f"{key}{other}.{theirs}"))

    def resblock(path: Path, key: str, has_shortcut: bool) -> None:
        norm(path + ("norm1",), key + ".norm1")
        conv_proj(path + ("conv1",), key + ".conv1")
        norm(path + ("norm2",), key + ".norm2")
        conv_proj(path + ("conv2",), key + ".conv2")
        if has_shortcut:
            conv(path + ("shortcut",), key + ".conv_shortcut")

    def attn(path: Path, key: str) -> None:
        m.extend([(key + ".group_norm.weight", path + ("norm", "scale"), None),
                  (key + ".group_norm.bias", path + ("norm", "bias"), None)])
        for ours, theirs in (("wq", "to_q"), ("wk", "to_k"), ("wv", "to_v"), ("wo", "to_out.0")):
            conv(path + (ours,), f"{key}.{theirs}")

    for side in ("encoder", "decoder"):
        t = template[side]
        conv_proj((side, "conv_in"), f"{side}.conv_in")
        conv_proj((side, "conv_out"), f"{side}.conv_out")
        norm((side, "norm_out"), f"{side}.norm_out")
        blocks = "down_blocks" if side == "encoder" else "up_blocks"
        for li, level in enumerate(t["levels"]):
            for ri, rb in enumerate(level["resblocks"]):
                resblock((side, "levels", li, "resblocks", ri),
                         f"{side}.{blocks}.{li}.resnets.{ri}", "shortcut" in rb)
            for kind, name in (("downsample", "downsamplers"), ("upsample", "upsamplers")):
                if kind in level:
                    for c in ("conv1", "conv2", "conv3"):
                        conv((side, "levels", li, kind, c), f"{side}.{blocks}.{li}.{name}.0.{c}")
        mid = t["mid"]
        resblock((side, "mid", "res1"), f"{side}.mid_block.resnets.0", "shortcut" in mid["res1"])
        resblock((side, "mid", "res2"), f"{side}.mid_block.resnets.1", "shortcut" in mid["res2"])
        attn((side, "mid", "attn_s"), f"{side}.mid_block.attentions.0")
        attn((side, "mid", "attn_t"), f"{side}.mid_block.temp_attentions.0")
    return m


def convert_diffusers_vae_state_dict(sd: Mapping[str, Any], cfg: VAEConfig,
                                     dtype: torch.dtype = torch.bfloat16, *,
                                     device: DeviceLike = None) -> Params:
    """A diffusers AutoencoderKLCosmos state dict (tensors or numpy arrays)
    -> the port's VAE parameters on `device` (weights and biases in `dtype`,
    norms fp32, identity latent statistics).  Strict: a missing key raises
    KeyError (naming the norm_nesting switch when the key exists under the
    other convention), an unconsumed one ValueError, a wrong shape
    ValueError."""
    device = resolve_device(device)
    template = init_vae_params(cfg, device="meta", dtype=torch.float32)
    keymap = _diffusers_key_map(cfg)
    for key, _, other in keymap:
        if key in sd:
            continue
        if other is not None and other in sd:
            raise KeyError(
                f"checkpoint has {other!r} where norm_nesting="
                f"{cfg.norm_nesting!r} expects {key!r} — this checkpoint "
                f"uses the {'flat' if cfg.norm_nesting == 'nested' else 'nested'!r} "
                f"convention; pass VAEConfig(norm_nesting="
                f"{'flat' if cfg.norm_nesting == 'nested' else 'nested'!r})")
        raise KeyError(f"diffusers VAE checkpoint missing: {key}")
    leftovers = sorted(set(sd) - {key for key, _, _ in keymap})
    if leftovers:
        raise ValueError(
            f"Unconsumed diffusers VAE keys ({len(leftovers)}): {leftovers[:10]}...")
    params: Params = {}
    for key, path, _ in keymap:
        v = sd[key]
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        like = _get(template, path)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"diffusers VAE parameter {key!r} has shape "
                             f"{tuple(t.shape)}, expected {tuple(like.shape)}")
        to = torch.float32 if path[-1] in ("scale", "bias") else dtype
        _set(params, path, t.to(device=device, dtype=to, copy=t.device == device))
    params = _listify(params)
    shape = (cfg.latent_channels, cfg.max_latent_frames)
    params["latents_mean"] = torch.zeros(shape, dtype=torch.float32, device=device)
    params["latents_std"] = torch.ones(shape, dtype=torch.float32, device=device)
    return params


def export_diffusers_vae_state_dict(params: Params, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """Inverse of convert_diffusers_vae_state_dict: the port's VAE weights
    under their diffusers names (the same tensors, no copy).  The latent
    statistics are not weights: they go to config.json
    (latents_mean / latents_std, flattened channel-major)."""
    return {key: _get(params, path) for key, path, _ in _diffusers_key_map(cfg)}


# ---------------------------------------------------------------------------
# Convention calibration
# ---------------------------------------------------------------------------

class VAECalibrationError(ValueError):
    """A convert-time VAE convention check failed (see the VAEConfig
    dwt_rescale / norm_nesting / stats_location switches)."""


def calibrate_vae_conventions(
    params: Params,
    cfg: VAEConfig,
    *,
    tol: float = 0.15,
    size: int = 64,
    encode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, float]:
    """Convert-time check of a trained checkpoint: encode -> decode of
    constant frames must give them back (a trained autoencoder's DC gain is
    about 1).  A wrong dwt_rescale scales the latent about 8x; statistics
    applied in the wrong place (stats_location) shift or scale the
    constants per channel; norm_nesting is caught earlier, by the strict
    key map.

    Returns {input value: mean abs error}; raises VAECalibrationError naming
    the suspect switch otherwise.  Meaningful for trained weights only:
    random ones fail by design.  encode_fn / decode_fn replace the bound
    vae_encode / vae_decode (the tests inject stand-ins)."""
    enc = encode_fn or (lambda x: vae_encode(params, x, cfg))
    dec = decode_fn or (lambda z: vae_decode(params, z, cfg))
    device, dtype = torch.device("cpu"), torch.float32
    if encode_fn is None:
        w = params["encoder"]["conv_in"]["conv_s"]["w"]
        device, dtype = w.device, w.dtype
    errs: Dict[str, float] = {}
    latent_rms = []
    with torch.no_grad():
        for v in (-0.5, 0.0, 0.5):
            x = torch.full((1, 1, size, size, cfg.in_channels), v, dtype=dtype, device=device)
            z = enc(x)
            latent_rms.append(float(torch.sqrt(torch.mean(torch.square(z.float())))))
            y = dec(z).float().cpu().numpy()
            errs[str(v)] = float(np.abs(y - v).mean())
    worst = max(errs.values())
    if worst <= tol:
        return errs
    rms = max(latent_rms)
    if rms > 8.0 or rms < 0.125:
        suspect = (
            f"latent RMS {rms:.3g} is far from the ~1 a trained model "
            f"produces — consistent with a DWT rescale convention mismatch "
            f"(try VAEConfig(dwt_rescale="
            f"{'orthonormal' if cfg.dwt_rescale == 'gain1' else 'gain1'!r}))"
            f" or latent statistics applied at the wrong place "
            f"(stats_location={cfg.stats_location!r})")
    else:
        suspect = (
            f"latent RMS {rms:.3g} looks calibrated, so the DWT scale is "
            f"likely right — check stats_location "
            f"(currently {cfg.stats_location!r}) and that latents_mean/std "
            f"match this checkpoint")
    raise VAECalibrationError(
        f"constant-frame roundtrip failed: mean abs error {worst:.4f} > "
        f"tol {tol} (per-input {errs}).  {suspect}.  If these weights are "
        f"untrained/random this check is meaningless — skip it.")


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_vae_checkpoint(path: str, cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16, *,
                        device: DeviceLike = None) -> Params:
    """Load a VAE checkpoint onto `device` (CUDA unless it says otherwise):
    a diffusers directory (diffusion_pytorch_model.safetensors or
    model.safetensors, with its config.json's statistics), a bare diffusers
    safetensors file, or a native file (the port's or the JAX package's)."""
    _refuse_orbax(path)
    device = resolve_device(device)
    if os.path.isdir(path):
        weight_file = next((os.path.join(path, n) for n in _WEIGHT_FILES
                            if os.path.exists(os.path.join(path, n))), None)
        if weight_file is None:
            raise FileNotFoundError(f"No weights found under {path}")
        with SafetensorsFile(weight_file, device) as sd:
            params = convert_diffusers_vae_state_dict(sd, cfg, dtype, device=device)
        cfg_json = os.path.join(path, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                vc = json.load(f)
            if "latents_mean" in vc:
                params = load_latent_stats(params, vc["latents_mean"], vc["latents_std"], cfg)
        # A missing or stats-less config.json must not leave identity
        # statistics on a flagship checkpoint: fall back to the bundled table.
        return ensure_latent_stats(params, cfg)
    entries, _ = read_header(path)
    if any("/" in k for k in entries):
        return load_vae_native(path, dtype, cfg, device=device)
    # A bare safetensors file has no config.json at all; the same fallback.
    with SafetensorsFile(path, device) as sd:
        params = convert_diffusers_vae_state_dict(sd, cfg, dtype, device=device)
    return ensure_latent_stats(params, cfg)
