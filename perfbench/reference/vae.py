"""Cosmos-1.0-Tokenizer-CV8x8x8, the causal video VAE (diffusers
AutoencoderKLCosmos as its published config sets it), written out plainly in
float32, channels-first (B, C, T, H, W).

* Two levels of causal 3D Haar patching: the first frame is repeated 4
  times in front, then each level maps every 2 x 2 x 2 cell to 8 subbands
  (subband index (t, h, w) bits of "difference" in that order, subband
  major over channels), scaled by 1/8; the inverse drops the 3 frames the
  repetition made.
* Factorized convolutions: spatial (1, 3, 3) zero-padded, then temporal
  (3, 1, 1) causal (the first frame replicated in front).
* GroupNorm with one group over (C, H, W) of each frame.
* Downsampling: a stride-(1, 2, 2) conv plus a 2 x 2 average pool of the
  right / bottom zero-padded input, then a causal stride-(2, 1, 1) conv
  plus a causal 2-frame average pool, then a 1 x 1 x 1 conv; upsampling
  repeats (time: all but the first copy), with a residual conv per axis
  group, then a 1 x 1 x 1 conv.
* The mid block: resnet, single-head spatial attention per frame, causal
  single-head temporal attention per pixel, resnet.
* Latents are normalized per (channel, latent frame) by the published
  statistics table's layout (mean, std of shape (16, 16)).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Shapes = List[Tuple[Tuple, Tuple[int, ...], str]]


def param_shapes(vae: Dict) -> Shapes:
    """(path, shape, kind) of every weight; kind 'conv' / 'dense' (N(0, 1)
    / sqrt(fan_in), in the served dtype), 'bias' (N(0, 0.02), served dtype),
    'gn_scale' / 'gn_bias' (1 + N(0, 0.1) / N(0, 0.1), float32),
    'lat_mean' / 'lat_std' (float32)."""
    levels = int(math.log2(vae["patch_size"]))
    enc, dec = vae["encoder_block_out_channels"], vae["decode_block_out_channels"]
    downs = int(math.log2(vae["spatial_compression_ratio"])) - levels
    out: Shapes = []

    def conv(p, kt, kh, kw, cin, cout, kind="conv"):
        out.append((p + ("w",), (cout, cin, kt, kh, kw), kind))
        out.append((p + ("b",), (cout,), "bias"))

    def proj(p, cin, cout):
        conv(p + ("conv_s",), 1, 3, 3, cin, cout)
        conv(p + ("conv_t",), 3, 1, 1, cout, cout)

    def norm(p, c):
        out.append((p + ("scale",), (c,), "gn_scale"))
        out.append((p + ("bias",), (c,), "gn_bias"))

    def res(p, cin, cout):
        norm(p + ("norm1",), cin)
        proj(p + ("conv1",), cin, cout)
        norm(p + ("norm2",), cout)
        proj(p + ("conv2",), cout, cout)
        if cin != cout:
            conv(p + ("shortcut",), 1, 1, 1, cin, cout)

    def attn(p, c):
        norm(p + ("norm",), c)
        for k in ("wq", "wk", "wv", "wo"):
            out.append((p + (k, "w"), (c, c), "dense"))
            out.append((p + (k, "b"), (c,), "bias"))

    def mid(p, c):
        res(p + ("res1",), c, c)
        attn(p + ("attn_s",), c)
        attn(p + ("attn_t",), c)
        res(p + ("res2",), c, c)

    e = ("encoder",)
    proj(e + ("conv_in",), vae["in_channels"] * 8 ** levels, enc[0])
    for i in range(len(enc) - 1):
        p = e + ("levels", i, "resblocks")
        res(p + (0,), enc[i], enc[i + 1])
        for j in range(1, vae["num_layers"]):
            res(p + (j,), enc[i + 1], enc[i + 1])
        if i < min(downs, len(enc) - 2):
            c = enc[i + 1]
            q = e + ("levels", i, "downsample")
            conv(q + ("conv1",), 1, 3, 3, c, c)
            conv(q + ("conv2",), 3, 1, 1, c, c)
            conv(q + ("conv3",), 1, 1, 1, c, c)
    mid(e + ("mid",), enc[-1])
    norm(e + ("norm_out",), enc[-1])
    proj(e + ("conv_out",), enc[-1], vae["latent_channels"])

    d = ("decoder",)
    ch = list(reversed(dec))
    proj(d + ("conv_in",), vae["latent_channels"], ch[0])
    mid(d + ("mid",), ch[0])
    for i in range(len(ch) - 1):
        p = d + ("levels", i, "resblocks")
        res(p + (0,), ch[i], ch[i + 1])
        for j in range(1, vae["num_layers"] + 1):
            res(p + (j,), ch[i + 1], ch[i + 1])
        if i < len(ch) - 2 and (len(ch) - 2 - i) <= downs:
            c = ch[i + 1]
            q = d + ("levels", i, "upsample")
            conv(q + ("conv1",), 3, 1, 1, c, c)
            conv(q + ("conv2",), 1, 3, 3, c, c)
            conv(q + ("conv3",), 1, 1, 1, c, c)
    norm(d + ("norm_out",), ch[-1])
    conv(d + ("conv_out", "conv_s"), 1, 3, 3, ch[-1], vae["out_channels"] * 8 ** levels)
    conv(d + ("conv_out", "conv_t"), 3, 1, 1, vae["out_channels"] * 8 ** levels,
         vae["out_channels"] * 8 ** levels, kind="conv_out")
    stats = (vae["latent_channels"], vae["max_latent_frames"])
    out.append((("latents_mean",), stats, "lat_mean"))
    out.append((("latents_std",), stats, "lat_std"))
    return out


# -- Haar ---------------------------------------------------------------------

def _signs(device) -> torch.Tensor:
    """(8 subbands, 2, 2, 2) butterfly signs: subband s takes the difference
    along t, h, w where its bits 4, 2, 1 are set."""
    s = torch.empty(8, 2, 2, 2, device=device)
    for sb in range(8):
        for a in range(2):
            for b in range(2):
                for c in range(2):
                    neg = ((sb >> 2) & a) + ((sb >> 1) & 1 & b) + (sb & 1 & c)
                    s[sb, a, b, c] = -1.0 if neg % 2 else 1.0
    return s


def haar_analysis(x: torch.Tensor, levels: int) -> torch.Tensor:
    p = 2 ** levels
    x = torch.cat([x[:, :, :1].repeat(1, 1, p, 1, 1), x[:, :, 1:]], dim=2)
    sg = _signs(x.device)
    for _ in range(levels):
        b, c, t, h, w = x.shape
        cells = x.reshape(b, c, t // 2, 2, h // 2, 2, w // 2, 2)
        y = torch.einsum("sabc,nkxaybzc->nskxyz", sg, cells) / 8.0
        x = y.reshape(b, 8 * c, t // 2, h // 2, w // 2)
    return x


def haar_synthesis(x: torch.Tensor, levels: int) -> torch.Tensor:
    sg = _signs(x.device)
    for _ in range(levels):
        b, c8, t, h, w = x.shape
        c = c8 // 8
        y = torch.einsum("sabc,nskxyz->nkxaybzc", sg, x.reshape(b, 8, c, t, h, w))
        x = y.reshape(b, c, 2 * t, 2 * h, 2 * w)
    return x[:, :, 2 ** levels - 1:]


# -- layers -------------------------------------------------------------------

def _conv(x, p, stride=(1, 1, 1), pad_hw=True):
    w = p["w"].float()
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1].repeat(1, 1, kt - 1, 1, 1), x], dim=2)
    pad = (0, kh // 2, kw // 2) if pad_hw else (0, 0, 0)
    return F.conv3d(x, w, p["b"].float(), stride=stride, padding=pad)


def _proj(x, p):
    return _conv(_conv(x, p["conv_s"]), p["conv_t"], pad_hw=False)


def _gn(x, p, eps=1e-6):
    mu = x.mean(dim=(1, 3, 4), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(1, 3, 4), keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].float().view(1, -1, 1, 1, 1) + p["bias"].float().view(1, -1, 1, 1, 1)


def _silu(x):
    return x * torch.sigmoid(x)


def _res(x, p):
    h = _proj(_silu(_gn(x, p["norm1"])), p["conv1"])
    h = _proj(_silu(_gn(h, p["norm2"])), p["conv2"])
    skip = _conv(x, p["shortcut"], pad_hw=False) if "shortcut" in p else x
    return skip + h


def _dense(x, p):
    return x @ p["w"].float().t() + p["b"].float()


def _attend(q, k, v, causal: bool, block: int = 1024):
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    for s in range(0, q.shape[1], block):
        logits = (q[:, s:s + block] @ k.transpose(1, 2)) * scale
        if causal:
            lq, lk = logits.shape[1], logits.shape[2]
            keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(s)
            logits = logits.masked_fill(~keep, float("-inf"))
        out[:, s:s + block] = torch.softmax(logits, dim=-1) @ v
    return out


def _attn_spatial(x, p):
    b, c, t, h, w = x.shape
    y = _gn(x, p["norm"]).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    o = _attend(_dense(y, p["wq"]), _dense(y, p["wk"]), _dense(y, p["wv"]), causal=False)
    o = _dense(o, p["wo"])
    return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def _attn_temporal(x, p):
    b, c, t, h, w = x.shape
    y = _gn(x, p["norm"]).permute(0, 3, 4, 2, 1).reshape(b * h * w, t, c)
    o = _attend(_dense(y, p["wq"]), _dense(y, p["wk"]), _dense(y, p["wv"]), causal=True)
    o = _dense(o, p["wo"])
    return x + o.reshape(b, h, w, t, c).permute(0, 4, 3, 1, 2)


def _mid(x, p):
    return _res(_attn_temporal(_attn_spatial(_res(x, p["res1"]), p["attn_s"]), p["attn_t"]),
                p["res2"])


def _down(x, p):
    xp = F.pad(x, (0, 1, 0, 1))
    x = _conv(xp, p["conv1"], stride=(1, 2, 2), pad_hw=False) + F.avg_pool3d(xp, (1, 2, 2))
    x = (_conv(x, p["conv2"], stride=(2, 1, 1), pad_hw=False)
         + F.avg_pool3d(torch.cat([x[:, :, :1], x], dim=2), (2, 1, 1)))
    return _conv(x, p["conv3"], pad_hw=False)


def _up(x, p):
    x = x.repeat_interleave(2, dim=2)[:, :, 1:]
    x = _conv(x, p["conv1"], pad_hw=False) + x
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    x = _conv(x, p["conv2"]) + x
    return _conv(x, p["conv3"], pad_hw=False)


def encode(params: Dict, vae: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1] -> normalized latent (B, 16, T', H/8, W/8)."""
    e = params["encoder"]
    h = _proj(haar_analysis(x.float(), int(math.log2(vae["patch_size"]))), e["conv_in"])
    for level in e["levels"]:
        for rb in level["resblocks"]:
            h = _res(h, rb)
        if "downsample" in level:
            h = _down(h, level["downsample"])
    h = _mid(h, e["mid"])
    z = _proj(_silu(_gn(h, e["norm_out"])), e["conv_out"])
    t = z.shape[2]
    mean = params["latents_mean"].float()[:, :t][None, :, :, None, None]
    std = params["latents_std"].float()[:, :t][None, :, :, None, None]
    return (z - mean) / std * float(vae["scaling_factor"])


def decode(params: Dict, vae: Dict, z: torch.Tensor) -> torch.Tensor:
    """Normalized latent (B, 16, T', h, w) -> (B, 3, T, 8h, 8w)."""
    dd = params["decoder"]
    t = z.shape[2]
    mean = params["latents_mean"].float()[:, :t][None, :, :, None, None]
    std = params["latents_std"].float()[:, :t][None, :, :, None, None]
    h = _proj(z.float() / float(vae["scaling_factor"]) * std + mean, dd["conv_in"])
    h = _mid(h, dd["mid"])
    for level in dd["levels"]:
        for rb in level["resblocks"]:
            h = _res(h, rb)
        if "upsample" in level:
            h = _up(h, level["upsample"])
    h = _proj(_silu(_gn(h, dd["norm_out"])), dd["conv_out"])
    return haar_synthesis(h, int(math.log2(vae["patch_size"])))
