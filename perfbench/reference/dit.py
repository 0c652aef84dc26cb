"""The FADITV2_7B denoiser (Cosmos GeneralDIT as DiffusionRenderer
configures it), written out plainly in float32.

Per block: self-attention, cross-attention and an MLP, each behind
AdaLN-LoRA (shift, scale, gate from SiLU(t) -> W1 -> W2, plus the shared
LoRA vector of the timestep MLP), a LayerNorm without affine, and a gated
residual.  Self-attention has per-head RMSNorm on q and k and 3D rotary
embeddings (head dim split 44 / 42 / 42 over t / h / w, theta 10000 times
the NTK ratio of each axis, rotate-half).  The context is one token (a row
of the learned 16-entry table for the inverse renderer, zeros for the
forward one), so each query attends to one key with weight 1 and the
cross-attention is W_o W_v context, whatever q and k are.  Patches are 1 x
2 x 2 over [x, condition, padding mask ones], vectors ordered (C, pt, ph,
pw); the final layer's outputs are ordered (ph, pw, pt, C).

Weights arrive in (out, in) layout, in any dtype; each is read in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[Tuple, Tuple[int, ...], str]]


def param_shapes(net: Dict) -> Shapes:
    """(path, shape, kind) of every weight: kind 'normal' (N(0, 0.02)),
    'embed' (N(0, 1)) or 'scale' (1 + N(0, 0.1))."""
    d = int(net["model_channels"])
    r, ctx = int(net["adaln_lora_dim"]), int(net["crossattn_emb_channels"])
    hid = int(d * net["mlp_ratio"])
    dh = d // int(net["num_heads"])
    ps, pt = int(net["patch_spatial"]), int(net["patch_temporal"])
    cin = int(net["in_channels"]) + int(net["additional_concat_ch"]) + (
        1 if net["concat_padding_mask"] else 0)
    out: Shapes = []
    for i in range(int(net["num_blocks"])):
        for sub, extra in (("fa", [("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                                   ("wo", (d, d))]),
                           ("ca", [("wq", (d, d)), ("wk", (d, ctx)), ("wv", (d, ctx)),
                                   ("wo", (d, d))]),
                           ("mlp", [("w1", (hid, d)), ("w2", (d, hid))])):
            p = ("blocks", i, sub)
            out += [(p + ("adaln_w1",), (r, d), "normal"), (p + ("adaln_w2",), (3 * d, r), "normal")]
            out += [(p + (k,), s, "normal") for k, s in extra]
            if sub != "mlp":
                out += [(p + ("q_norm",), (dh,), "scale"), (p + ("k_norm",), (dh,), "scale")]
    out += [(("x_embedder", "weight"), (d, cin * ps * ps * pt), "normal"),
            (("t_embedder", "w1"), (d, d), "normal"),
            (("t_embedder", "w2"), (3 * d, d), "normal"),
            (("affline_norm", "weight"), (d,), "scale"),
            (("final", "adaln_w1"), (r, d), "normal"),
            (("final", "adaln_w2"), (2 * d, r), "normal"),
            (("final", "linear"), (ps * ps * pt * int(net["out_channels"]), d), "normal")]
    if net["use_context_embedding"]:
        out.append((("context_embedding", "weight"), (int(net["num_context_embeddings"]), ctx),
                    "embed"))
    return out


def _f(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def _lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ _f(w).t()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(w)


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _silu(x):
    return x * torch.sigmoid(x)


def _adaln(lin, t_emb, lora, p, n):
    h = lin(lin(_silu(t_emb), p["adaln_w1"]), p["adaln_w2"]) + lora[:, : n * t_emb.shape[1]]
    return h.chunk(n, dim=-1)


def _rope_tables(tp: int, hp: int, wp: int, dh: int, ratios, device):
    """cos, sin of shape (L, dh): per-axis angles pos * theta^(-2i/dim_axis)."""
    dim_hw = dh // 6 * 2
    dim_t = dh - 2 * dim_hw
    parts = []
    for n, dim, ratio, axis in ((tp, dim_t, ratios[2], 0), (hp, dim_hw, ratios[0], 1),
                                (wp, dim_hw, ratios[1], 2)):
        inv = (10000.0 * ratio) ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                                   device=device)[: dim // 2] / dim)
        ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None]
        shape = [tp, hp, wp, dim // 2]
        view = [1, 1, 1, dim // 2]
        view[axis] = n
        parts.append(ang.reshape(view).expand(shape))
    half = torch.cat(parts, dim=-1).reshape(tp * hp * wp, dh // 2)
    full = torch.cat([half, half], dim=-1)
    return torch.cos(full).float(), torch.sin(full).float()


def _rope(x, cos, sin):
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def _attention(q, k, v, block: int = 1024):
    """softmax(q k^T / sqrt(d)) v per head, in query blocks. (B, L, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)  # (B, H, D, L)
    vt = v.permute(0, 2, 1, 3)  # (B, H, L, D)
    for s in range(0, q.shape[1], block):
        qb = q[:, s:s + block].permute(0, 2, 1, 3)  # (B, H, l, D)
        w = torch.softmax((qb @ kt) * scale, dim=-1)
        out[:, s:s + block] = (w @ vt).permute(0, 2, 1, 3)
    return out


def _timestep(sigma: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=sigma.device) / half)
    ang = sigma.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).float()


def _block(lin, tok, bp, t_emb, lora, ctx, cos, sin, nh: int):
    b, ll, d = tok.shape
    dh = d // nh
    fa, ca, mlp = bp["fa"], bp["ca"], bp["mlp"]
    shift, scale, gate = _adaln(lin, t_emb, lora, fa, 3)
    xm = _ln(tok) * (1 + scale[:, None]) + shift[:, None]
    q = _rope(_rms(lin(xm, fa["wq"]).reshape(b, ll, nh, dh), fa["q_norm"]), cos, sin)
    k = _rope(_rms(lin(xm, fa["wk"]).reshape(b, ll, nh, dh), fa["k_norm"]), cos, sin)
    v = lin(xm, fa["wv"]).reshape(b, ll, nh, dh)
    tok = tok + gate[:, None] * lin(_attention(q, k, v).reshape(b, ll, d), fa["wo"])

    _, _, gate = _adaln(lin, t_emb, lora, ca, 3)
    tok = tok + gate[:, None] * lin(lin(ctx, ca["wv"]), ca["wo"])[:, None]

    shift, scale, gate = _adaln(lin, t_emb, lora, mlp, 3)
    xm = _ln(tok) * (1 + scale[:, None]) + shift[:, None]
    hmid = torch.nn.functional.gelu(lin(xm, mlp["w1"]), approximate="none")
    return tok + gate[:, None] * lin(hmid, mlp["w2"])


def forward(params: Dict, net: Dict, x: torch.Tensor, sigma: torch.Tensor,
            cond: torch.Tensor, context_index, *, block_runner=None,
            quantize=None) -> torch.Tensor:
    """F(x; sigma, cond): x (B, T, H, W, C) already c_in-scaled, sigma (B,),
    cond (B, T, H, W, C_cond), context_index (B,) or None.  Float32.
    block_runner(fn, *tensors) runs each block (activation checkpointing);
    quantize(t) rounds both operands of every matmul (the fp8 control)."""
    b, t, h, w, _ = x.shape
    d = int(net["model_channels"])
    nh = int(net["num_heads"])
    dh = d // nh
    ps, pt = int(net["patch_spatial"]), int(net["patch_temporal"])
    dev = x.device
    if quantize is None:
        lin = _lin
    else:
        def lin(a, wt):
            return quantize(a) @ quantize(_f(wt)).t()

    t_emb = _timestep(sigma.float(), d)
    lora = lin(_silu(lin(t_emb, params["t_embedder"]["w1"])), params["t_embedder"]["w2"])
    t_emb = _rms(t_emb, params["affline_norm"]["weight"])

    if net["use_context_embedding"]:
        table = _f(params["context_embedding"]["weight"])
        ctx = table[torch.as_tensor(context_index, device=dev).long().reshape(b)]
    else:
        ctx = torch.zeros(b, int(net["crossattn_emb_channels"]), device=dev)

    parts = [x.float(), cond.float()]
    if net["concat_padding_mask"]:
        parts.append(torch.ones(b, t, h, w, 1, device=dev))
    z = torch.cat(parts, dim=-1)
    c = z.shape[-1]
    tp, hp, wp = t // pt, h // ps, w // ps
    z = z.reshape(b, tp, pt, hp, ps, wp, ps, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    tok = lin(z.reshape(b, tp * hp * wp, c * pt * ps * ps), params["x_embedder"]["weight"])
    cos, sin = _rope_tables(tp, hp, wp, dh, (net["rope_h_extrapolation_ratio"],
                                             net["rope_w_extrapolation_ratio"],
                                             net["rope_t_extrapolation_ratio"]), dev)

    for bp in params["blocks"]:
        def fn(tok_, t_emb_, lora_, ctx_, bp=bp):
            return _block(lin, tok_, bp, t_emb_, lora_, ctx_, cos, sin, nh)

        tok = fn(tok, t_emb, lora, ctx) if block_runner is None else block_runner(
            fn, tok, t_emb, lora, ctx)

    fin = params["final"]
    shift, scale = _adaln(lin, t_emb, lora, fin, 2)
    out = lin(_ln(tok) * (1 + scale[:, None]) + shift[:, None], fin["linear"])
    co = int(net["out_channels"])
    out = out.reshape(b, tp, hp, wp, ps, ps, pt, co).permute(0, 1, 6, 2, 4, 3, 5, 7)
    return out.reshape(b, t, h, w, co)
