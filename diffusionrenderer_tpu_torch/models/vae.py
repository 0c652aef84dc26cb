"""Cosmos-1.0-Tokenizer-CV8x8x8, the causal 3D video VAE, in PyTorch.

Counterpart of diffusionrenderer_tpu/models/vae.py, with the same math:
two-level causal Haar patching (first frame repeated patch_size times,
per-level scale by `dwt_rescale`), factorized spatial (1,3,3) + causal
temporal (3,1,1) convolutions, per-frame GroupNorm(1), hybrid stride-2
down- and upsampling, a mid block of resnet - spatial attention - causal
temporal attention - resnet, and per-(channel, latent-frame) latent
statistics (`load_latent_stats` installs the published table).
`vae_encode_chunked` / `vae_decode_chunked` micro-batch the batch axis and
`vae_encode_temporal_chunks` / `vae_decode_temporal_chunks` cut a long
clip into causal chunks, as the JAX package does.

The public functions keep the JAX package's channels-last (B, T, H, W, C)
layout (or channels-first on request); inside, the network runs
channels-first (B, C, T, H, W), the layout of F.conv3d.  Parameters are a
nested dict in PyTorch's layouts: conv weights (Cout, Cin, kt, kh, kw),
dense weights (out, in).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VAEConfig
from ..ops.attention import attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Haar wavelet patcher (channels-first)
# ---------------------------------------------------------------------------

def _halves(u: torch.Tensor, dim: int):
    """(low, high) = (even + odd, even - odd) along `dim`."""
    u0, u1 = u.unfold(dim, 2, 2).unbind(-1)
    return u0 + u1, u0 - u1


def _haar_level(x: torch.Tensor, scale: float) -> torch.Tensor:
    """One exact stride-2 Haar level of a (B, C, T, H, W) tensor ->
    (B, 8C, T/2, H/2, W/2).  Subband s = (t_high<<2)|(h_high<<1)|w_high sits
    at channels s*C..(s+1)*C.  Combines run in fp32."""
    xw = x.float()
    lw, hw = _halves(xw, 4)
    subs_hw = [_halves(uw, 3) for uw in (lw, hw)]
    subbands: List[Optional[torch.Tensor]] = [None] * 8
    for w_bit in range(2):
        for h_bit in range(2):
            lt, ht = _halves(subs_hw[w_bit][h_bit], 2)
            subbands[(h_bit << 1) | w_bit] = lt
            subbands[4 | (h_bit << 1) | w_bit] = ht
    return (torch.cat(subbands, dim=1) * scale).to(x.dtype)


def _interleave2(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """out[2i] = a[i], out[2i+1] = b[i] along `dim`."""
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def _haar_level_inverse(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Inverse of _haar_level: (B, 8C, T2, H2, W2) -> (B, C, 2T2, 2H2, 2W2);
    per axis x0 = a + d, x1 = a - d."""
    c = x.shape[1] // 8
    subs = {s: x[:, s * c:(s + 1) * c].float() for s in range(8)}
    for bit, dim in ((4, 2), (2, 3), (1, 4)):
        subs = {s: _interleave2(subs[s] + subs[s | bit], subs[s] - subs[s | bit], dim)
                for s in subs if not s & bit}
    out = subs[0]
    if scale != 1.0:
        out = out * scale
    return out.to(x.dtype)


def _check_frames(t: int, patch: int) -> None:
    if t != 1 and (t - 1) % patch != 0:
        raise ValueError(
            f"Unsupported frame count T={t}: the causal Haar patcher needs "
            f"T == 1 or (T-1) % {patch} == 0.")


def _dwt_scales(rescale: str):
    """Per-level (analysis, synthesis) multipliers of the sum/diff butterfly."""
    if rescale == "gain1":
        return 0.125, 1.0
    if rescale == "orthonormal":
        s = 1.0 / math.sqrt(8.0)
        return s, s
    raise ValueError(f"unknown dwt_rescale convention {rescale!r}")


def haar_patch(x: torch.Tensor, levels: int, rescale: str = "gain1") -> torch.Tensor:
    """Causal patching of (B, C, T, H, W): repeat the first frame 2^levels
    times, then exact halvings."""
    p = 2 ** levels
    ana, _ = _dwt_scales(rescale)
    _check_frames(x.shape[2], p)
    x = torch.cat([x[:, :, :1].expand(-1, -1, p, -1, -1), x[:, :, 1:]], dim=2)
    for _ in range(levels):
        x = _haar_level(x, ana)
    return x


def haar_unpatch(x: torch.Tensor, levels: int, orig_t: int,
                 rescale: str = "gain1") -> torch.Tensor:
    """Inverse recursive Haar of (B, C', T', H', W'); drops the leading
    2^levels - 1 frames synthesized from the repeated first frame."""
    p = 2 ** levels
    _, syn = _dwt_scales(rescale)
    _check_frames(orig_t, p)
    for _ in range(levels):
        x = _haar_level_inverse(x, syn)
    return x[:, :, p - 1:]


# ---------------------------------------------------------------------------
# Primitive layers (channels-first)
# ---------------------------------------------------------------------------

def causal_conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  stride: Sequence[int] = (1, 1, 1),
                  spatial_pad: str = "same") -> torch.Tensor:
    """3D conv causal in time: the first frame is replicated kt-1 times in
    front.  x: (B, Cin, T, H, W); w: (Cout, Cin, kt, kh, kw).
    spatial_pad 'same' pads kh//2 / kw//2 on both sides, 'none' not at all."""
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
    pad = (0, kh // 2, kw // 2) if spatial_pad == "same" else 0
    return F.conv3d(x, w, b, stride=tuple(stride), padding=pad)


def _conv_proj(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Factorized conv: spatial (1,3,3), then causal temporal (3,1,1)."""
    x = causal_conv3d(x, p["conv_s"]["w"], p["conv_s"]["b"])
    return causal_conv3d(x, p["conv_t"]["w"], p["conv_t"]["b"], spatial_pad="none")


def group_norm_per_frame(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(1) over (C, H, W) of each frame, in fp32."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 3, 4), unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    shape = (1, -1, 1, 1, 1)
    return (y * scale.float().view(shape) + bias.float().view(shape)).to(x.dtype)


def _resblock(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = F.silu(group_norm_per_frame(x, p["norm1"]["scale"], p["norm1"]["bias"]))
    h = _conv_proj(h, p["conv1"])
    h = F.silu(group_norm_per_frame(h, p["norm2"]["scale"], p["norm2"]["bias"]))
    h = _conv_proj(h, p["conv2"])
    skip = x
    if "shortcut" in p:
        skip = causal_conv3d(x, p["shortcut"]["w"], p["shortcut"]["b"],
                             spatial_pad="none")
    return skip + h


def _attn_spatial(x: torch.Tensor, p: Params, attn_backend: str = "auto") -> torch.Tensor:
    """Single-head self-attention over (H*W) per frame, head dim C, through
    the attention dispatcher (the flash kernel at full resolution)."""
    b, c, t, h, w = x.shape
    y = group_norm_per_frame(x, p["norm"]["scale"], p["norm"]["bias"])
    y = y.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    q = F.linear(y, p["wq"]["w"], p["wq"]["b"])[:, :, None, :]  # (BT, HW, 1, C)
    k = F.linear(y, p["wk"]["w"], p["wk"]["b"])[:, :, None, :]
    v = F.linear(y, p["wv"]["w"], p["wv"]["b"])[:, :, None, :]
    o = attention(q, k, v, backend=attn_backend)[:, :, 0, :].to(x.dtype)
    o = F.linear(o, p["wo"]["w"], p["wo"]["b"])
    return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def _attn_temporal(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Single-head causal self-attention over T per spatial location."""
    b, c, t, h, w = x.shape
    y = group_norm_per_frame(x, p["norm"]["scale"], p["norm"]["bias"])
    y = y.permute(0, 3, 4, 2, 1).reshape(b * h * w, t, c)
    q = F.linear(y, p["wq"]["w"], p["wq"]["b"])
    k = F.linear(y, p["wk"]["w"], p["wk"]["b"])
    v = F.linear(y, p["wv"]["w"], p["wv"]["b"])
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) / math.sqrt(c)
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    logits = torch.where(mask[None], logits, torch.full_like(logits, -1e30))
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", attn.float(), v.float()).to(x.dtype)
    o = F.linear(o, p["wo"]["w"], p["wo"]["b"])
    return x + o.reshape(b, h, w, t, c).permute(0, 4, 3, 1, 2)


def _avg_pool(x: torch.Tensor, window) -> torch.Tensor:
    """VALID average pool over (T, H, W), summed in fp32."""
    return F.avg_pool3d(x.float(), window, window).to(x.dtype)


def _downsample(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Hybrid stride-2: per axis group the strided conv and the average pool
    of the same padded input are summed; a 1x1x1 conv follows."""
    xp = F.pad(x, (0, 1, 0, 1))  # zero-pad right and bottom
    x = causal_conv3d(xp, p["conv1"]["w"], p["conv1"]["b"], stride=(1, 2, 2),
                      spatial_pad="none") + _avg_pool(xp, (1, 2, 2))
    conv = causal_conv3d(x, p["conv2"]["w"], p["conv2"]["b"], stride=(2, 1, 1),
                         spatial_pad="none")
    x = conv + _avg_pool(torch.cat([x[:, :, :1], x], dim=2), (2, 1, 1))
    return causal_conv3d(x, p["conv3"]["w"], p["conv3"]["b"], spatial_pad="none")


def _upsample(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Hybrid upsample: repeat-interleave (time drops the leading duplicate,
    T -> 2T-1), conv with a residual add per axis group, then 1x1x1."""
    x = x.repeat_interleave(2, dim=2)[:, :, 1:]
    x = causal_conv3d(x, p["conv1"]["w"], p["conv1"]["b"], spatial_pad="none") + x
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    x = causal_conv3d(x, p["conv2"]["w"], p["conv2"]["b"]) + x
    return causal_conv3d(x, p["conv3"]["w"], p["conv3"]["b"], spatial_pad="none")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_vae_params(cfg: VAEConfig, *, device, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 1) -> Params:
    """Random weights (normal / sqrt(fan_in), zero biases, unit norms,
    identity latent statistics) drawn on `device` from a seeded
    torch.Generator; device='meta' gives the shapes only."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    levels = int(math.log2(cfg.patch_size))
    enc_ch, dec_ch = cfg.encoder_block_out_channels, cfg.decode_block_out_channels
    num_downs = int(math.log2(cfg.spatial_compression_ratio)) - levels

    def randn(*shape, fan_in):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.div_(math.sqrt(fan_in)).to(dtype)

    def conv(kt, kh, kw, cin, cout):
        return {"w": randn(cout, cin, kt, kh, kw, fan_in=kt * kh * kw * cin),
                "b": torch.zeros(cout, device=dev, dtype=dtype)}

    def conv_proj(cin, cout):
        return {"conv_s": conv(1, 3, 3, cin, cout), "conv_t": conv(3, 1, 1, cout, cout)}

    def norm(c):
        return {"scale": torch.ones(c, device=dev, dtype=torch.float32),
                "bias": torch.zeros(c, device=dev, dtype=torch.float32)}

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv_proj(cin, cout),
             "norm2": norm(cout), "conv2": conv_proj(cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(1, 1, 1, cin, cout)
        return p

    def attn(c):
        def dense():
            return {"w": randn(c, c, fan_in=c),
                    "b": torch.zeros(c, device=dev, dtype=dtype)}
        return {"norm": norm(c), "wq": dense(), "wk": dense(), "wv": dense(),
                "wo": dense()}

    def mid(c):
        return {"res1": res(c, c), "attn_s": attn(c), "attn_t": attn(c),
                "res2": res(c, c)}

    enc_levels = []
    for i in range(len(enc_ch) - 1):
        blocks = [res(enc_ch[i], enc_ch[i + 1])]
        blocks += [res(enc_ch[i + 1], enc_ch[i + 1]) for _ in range(cfg.num_layers - 1)]
        level: Params = {"resblocks": blocks}
        if i < min(num_downs, len(enc_ch) - 2):
            c = enc_ch[i + 1]
            level["downsample"] = {"conv1": conv(1, 3, 3, c, c),
                                   "conv2": conv(3, 1, 1, c, c),
                                   "conv3": conv(1, 1, 1, c, c)}
        enc_levels.append(level)

    dch = list(reversed(dec_ch))
    dec_levels = []
    for i in range(len(dch) - 1):
        blocks = [res(dch[i], dch[i + 1])]
        blocks += [res(dch[i + 1], dch[i + 1]) for _ in range(cfg.num_layers)]
        level = {"resblocks": blocks}
        if i < len(dch) - 2 and (len(dch) - 2 - i) <= num_downs:
            c = dch[i + 1]
            level["upsample"] = {"conv1": conv(3, 1, 1, c, c),
                                 "conv2": conv(1, 3, 3, c, c),
                                 "conv3": conv(1, 1, 1, c, c)}
        dec_levels.append(level)

    stats_shape = (cfg.latent_channels, cfg.max_latent_frames)
    return {
        "encoder": {
            "conv_in": conv_proj(cfg.in_channels * 8 ** levels, enc_ch[0]),
            "levels": enc_levels,
            "mid": mid(enc_ch[-1]),
            "norm_out": norm(enc_ch[-1]),
            "conv_out": conv_proj(enc_ch[-1], cfg.latent_channels),
        },
        "decoder": {
            "conv_in": conv_proj(cfg.latent_channels, dch[0]),
            "mid": mid(dch[0]),
            "levels": dec_levels,
            "norm_out": norm(dch[-1]),
            "conv_out": conv_proj(dch[-1], cfg.out_channels * 8 ** levels),
        },
        "latents_mean": torch.zeros(stats_shape, device=dev, dtype=torch.float32),
        "latents_std": torch.ones(stats_shape, device=dev, dtype=torch.float32),
    }


def load_latent_stats(params: Params, latents_mean, latents_std,
                      cfg: VAEConfig) -> Params:
    """A new parameter dict with the flat (C * F) latents_mean / latents_std
    vectors of the diffusers config installed, reshaped channel-major to
    (C, F) fp32 on the device of the parameters' current statistics."""
    device = params["latents_mean"].device if "latents_mean" in params else "cpu"
    shape = (cfg.latent_channels, cfg.max_latent_frames)
    out = dict(params)
    for key, vec in (("latents_mean", latents_mean), ("latents_std", latents_std)):
        arr = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec, np.float32)
        out[key] = torch.from_numpy(arr.reshape(shape).copy()).to(device)
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _latent_stats(params: Params, t_lat: int):
    """(1, C, T', 1, 1) fp32 mean and std of the first t_lat latent frames."""
    mean = params["latents_mean"][:, :t_lat].float()[None, :, :, None, None]
    std = params["latents_std"][:, :t_lat].float()[None, :, :, None, None]
    return mean, std


def _mid(h: torch.Tensor, mid: Params, attn_backend: str) -> torch.Tensor:
    h = _resblock(h, mid["res1"])
    h = _attn_spatial(h, mid["attn_s"], attn_backend)
    h = _attn_temporal(h, mid["attn_t"])
    return _resblock(h, mid["res2"])


def vae_encode(params: Params, x: torch.Tensor, cfg: VAEConfig,
               in_layout: str = "NDHWC", attn_backend: str = "auto") -> torch.Tensor:
    """(B, T, H, W, 3) (or (B, 3, T, H, W) with in_layout='NCDHW') ->
    normalized latent (B, T', H/8, W/8, 16).  Deterministic."""
    levels = int(math.log2(cfg.patch_size))
    enc = params["encoder"]
    if in_layout == "NDHWC":
        x = x.permute(0, 4, 1, 2, 3)
    h = haar_patch(x, levels, rescale=cfg.dwt_rescale)
    h = _conv_proj(h, enc["conv_in"])
    for level in enc["levels"]:
        for rb in level["resblocks"]:
            h = _resblock(h, rb)
        if "downsample" in level:
            h = _downsample(h, level["downsample"])
    h = _mid(h, enc["mid"], attn_backend)
    h = F.silu(group_norm_per_frame(h, enc["norm_out"]["scale"], enc["norm_out"]["bias"]))
    z = _conv_proj(h, enc["conv_out"])
    if cfg.stats_location == "encode":
        mean, std = _latent_stats(params, z.shape[2])
        z = ((z.float() - mean) / std * cfg.scaling_factor).to(z.dtype)
    return z.permute(0, 2, 3, 4, 1)


def vae_decode(params: Params, z: torch.Tensor, cfg: VAEConfig,
               out_layout: str = "NDHWC", attn_backend: str = "auto") -> torch.Tensor:
    """Normalized latent (B, T', H', W', 16) -> (B, T, 8H', 8W', 3), or
    (B, 3, T, 8H', 8W') with out_layout='NCDHW'."""
    levels = int(math.log2(cfg.patch_size))
    dec = params["decoder"]
    z = z.permute(0, 4, 1, 2, 3)
    t_lat = z.shape[2]
    if cfg.stats_location == "encode":
        mean, std = _latent_stats(params, t_lat)
        z = (z.float() / cfg.scaling_factor * std + mean).to(z.dtype)
    h = _conv_proj(z, dec["conv_in"])
    h = _mid(h, dec["mid"], attn_backend)
    for level in dec["levels"]:
        for rb in level["resblocks"]:
            h = _resblock(h, rb)
        if "upsample" in level:
            h = _upsample(h, level["upsample"])
    h = F.silu(group_norm_per_frame(h, dec["norm_out"]["scale"], dec["norm_out"]["bias"]))
    h = _conv_proj(h, dec["conv_out"])
    video = haar_unpatch(h, levels, cfg.pixel_num_frames(t_lat), rescale=cfg.dwt_rescale)
    return video if out_layout == "NCDHW" else video.permute(0, 2, 3, 4, 1)


def vae_encode_chunked(params: Params, x: torch.Tensor, cfg: VAEConfig,
                       max_batch: int = 8) -> torch.Tensor:
    """vae_encode of (B, T, H, W, 3) in micro-batches of at most max_batch
    rows, to bound peak memory (the reference's max_enc_batch_size)."""
    if x.shape[0] <= max_batch:
        return vae_encode(params, x, cfg)
    return torch.cat([vae_encode(params, x[i:i + max_batch], cfg)
                      for i in range(0, x.shape[0], max_batch)], dim=0)


def vae_decode_chunked(params: Params, z: torch.Tensor, cfg: VAEConfig,
                       max_batch: int = 4) -> torch.Tensor:
    """vae_decode in micro-batches of at most max_batch rows (the
    reference's max_dec_batch_size)."""
    if z.shape[0] <= max_batch:
        return vae_decode(params, z, cfg)
    return torch.cat([vae_decode(params, z[i:i + max_batch], cfg)
                      for i in range(0, z.shape[0], max_batch)], dim=0)


def vae_encode_temporal_chunks(params: Params, x: torch.Tensor, cfg: VAEConfig,
                               pixel_chunk_duration: int,
                               max_batch: int = 8) -> torch.Tensor:
    """Long-clip encode: (B, n*t, H, W, C) -> (B*n, t, H, W, C) chunks, each
    encoded causally from its own first frame, micro-batched, and joined on
    the latent time axis."""
    b, t, h, w, c = x.shape
    if t % pixel_chunk_duration != 0:
        raise ValueError(
            f"T={t} not divisible by pixel_chunk_duration={pixel_chunk_duration}")
    n = t // pixel_chunk_duration
    z = vae_encode_chunked(params, x.reshape(b * n, pixel_chunk_duration, h, w, c), cfg,
                           max_batch=max_batch)
    s = cfg.spatial_compression_ratio
    return z.reshape(b, n * z.shape[1], h // s, w // s, cfg.latent_channels)


def vae_decode_temporal_chunks(params: Params, z: torch.Tensor, cfg: VAEConfig,
                               latent_chunk_duration: int,
                               max_batch: int = 4) -> torch.Tensor:
    """Inverse of vae_encode_temporal_chunks."""
    b, t, h, w, c = z.shape
    if t % latent_chunk_duration != 0:
        raise ValueError(f"latent T={t} not divisible by {latent_chunk_duration}")
    n = t // latent_chunk_duration
    y = vae_decode_chunked(params, z.reshape(b * n, latent_chunk_duration, h, w, c), cfg,
                           max_batch=max_batch)
    return y.reshape(b, n * y.shape[1], *y.shape[2:])
