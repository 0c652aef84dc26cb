"""GeneralDIT, the 7B video diffusion transformer, in PyTorch.

Counterpart of diffusionrenderer_tpu/models/dit.py.  Parameters are a plain
nested dict of tensors in PyTorch's (out, in) weight layout; the 28 blocks
are a list walked by a Python loop (the JAX package stacks them for
`lax.scan`).  Kept from the JAX package:

* FA -> CA -> MLP block order, each sub-block AdaLN(shift, scale, gate) ->
  LayerNorm -> modulate -> body -> x + gate * out;
* the exact single-KV cross-attention collapse (the context is always one
  token: a context-table row, or zeros);
* erf GELU; rope cos/sin cast to the activation dtype;
* a learned context embedding for the inverse renderer, a zero context for
  the forward renderer;
* fp32 AdaLN, RMSNorm and LayerNorm statistics; matmuls in the weights'
  dtype with fp32 accumulation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import DiTConfig
from ..ops.attention import attention, cross_attention_single_kv
from ..ops.norms import adaln_modulation, layer_norm_no_affine, modulate, rms_norm
from ..ops.patch import patch_embed, unpatchify
from ..ops.rope import apply_rope, rope_3d_angles
from ..ops.timestep import timestep_embedding

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_dit_params(cfg: DiTConfig, *, device, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, scale: float = 0.02) -> Params:
    """Random-normal weights with the checkpoint's shapes, drawn on `device`
    from a seeded torch.Generator (so a full-size model is built where it
    runs, with no host copy).  device='meta' gives the shapes only."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    d, dh, r = cfg.model_channels, cfg.head_dim, cfg.adaln_lora_dim
    hid, ctx = cfg.hidden_dim, cfg.crossattn_emb_channels

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def adaln():
        return {"adaln_w1": w(r, d), "adaln_w2": w(3 * d, r)}

    blocks = []
    for _ in range(cfg.num_blocks):
        blocks.append({
            "fa": {**adaln(), "wq": w(d, d), "wk": w(d, d), "wv": w(d, d),
                   "wo": w(d, d), "q_norm": ones(dh), "k_norm": ones(dh)},
            "ca": {**adaln(), "wq": w(d, d), "wk": w(d, ctx), "wv": w(d, ctx),
                   "wo": w(d, d), "q_norm": ones(dh), "k_norm": ones(dh)},
            "mlp": {**adaln(), "w1": w(hid, d), "w2": w(d, hid)},
        })
    out_dim = cfg.patch_spatial ** 2 * cfg.patch_temporal * cfg.out_channels
    params: Params = {
        "x_embedder": {"weight": w(d, cfg.patch_dim)},
        "t_embedder": {"w1": w(d, d), "w2": w(3 * d, d)},
        "affline_norm": {"weight": ones(d)},
        "blocks": blocks,
        "final": {"adaln_w1": w(r, d), "adaln_w2": w(2 * d, r),
                  "linear": w(out_dim, d)},
    }
    if cfg.patch_embed_bias:
        params["x_embedder"]["bias"] = torch.zeros(d, device=dev, dtype=dtype)
    if cfg.use_context_embedding:
        params["context_embedding"] = {"weight": w(cfg.num_context_embeddings, ctx)}
    return params


def dit_param_count(cfg: DiTConfig) -> int:
    """Analytic parameter count (~7.16B for FADITV2_7B)."""
    d, r, hid, ctx = (cfg.model_channels, cfg.adaln_lora_dim, cfg.hidden_dim,
                      cfg.crossattn_emb_channels)
    dh = cfg.head_dim
    per_adaln = d * r + r * 3 * d
    fa = per_adaln + 4 * d * d + 2 * dh
    ca = per_adaln + 2 * d * d + 2 * ctx * d + 2 * dh
    mlp = per_adaln + 2 * d * hid
    stem = cfg.patch_dim * d + d * d + d * 3 * d + d
    final = d * r + r * 2 * d + d * (cfg.patch_spatial ** 2 * cfg.patch_temporal
                                     * cfg.out_channels)
    ctx_emb = cfg.num_context_embeddings * ctx if cfg.use_context_embedding else 0
    return cfg.num_blocks * (fa + ca + mlp) + stem + final + ctx_emb


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _adaln_chunks(emb, lora, bp, dtype, n_chunks=3):
    """(shift, scale, gate) of one sub-block, in the activation dtype."""
    mod = adaln_modulation(emb, bp["adaln_w1"], bp["adaln_w2"], lora)
    return [c.to(dtype) for c in mod.chunk(n_chunks, dim=-1)]


def _adaln(x, emb, lora, bp):
    """((shift, scale, gate), modulated x) of one sub-block."""
    chunks = _adaln_chunks(emb, lora, bp, x.dtype)
    return chunks, modulate(layer_norm_no_affine(x), chunks[0], chunks[1])


def _self_attention_block(x, emb, lora, bp, cos, sin, num_heads: int,
                          attn_backend: str) -> torch.Tensor:
    (_, _, gate), xm = _adaln(x, emb, lora, bp)
    b, l, d = xm.shape
    dh = d // num_heads
    q = F.linear(xm, bp["wq"]).reshape(b, l, num_heads, dh)
    k = F.linear(xm, bp["wk"]).reshape(b, l, num_heads, dh)
    v = F.linear(xm, bp["wv"]).reshape(b, l, num_heads, dh)
    # Per-head q/k RMSNorm, identity on v (the "RRI" scheme).
    q = apply_rope(rms_norm(q, bp["q_norm"]), cos, sin)
    k = apply_rope(rms_norm(k, bp["k_norm"]), cos, sin)
    o = attention(q, k, v, backend=attn_backend)
    o = F.linear(o.reshape(b, l, d), bp["wo"])
    return x + gate[:, None, :] * o


def _cross_attention_block(x, emb, lora, bp, context, num_heads: int) -> torch.Tensor:
    """Cross-attention over the one-token context: softmax over a single key
    is 1, so the output is W_o W_v context for every query (q, k and their
    norms drop out exactly, and so does the modulated x)."""
    gate = _adaln_chunks(emb, lora, bp, x.dtype)[2]
    v = cross_attention_single_kv(context, bp["wk"], bp["wv"], num_heads)
    o = F.linear(v.reshape(x.shape[0], 1, -1), bp["wo"])  # (B, 1, D)
    return x + gate[:, None, :] * o


def _mlp_block(x, emb, lora, bp) -> torch.Tensor:
    (_, _, gate), xm = _adaln(x, emb, lora, bp)
    h = F.gelu(F.linear(xm, bp["w1"]), approximate="none")  # erf form
    return x + gate[:, None, :] * F.linear(h, bp["w2"])


def block_apply(bp: Params, x, emb, lora, context, cos, sin, cfg: DiTConfig,
                attn_backend: str = "auto") -> torch.Tensor:
    """One FA -> CA -> MLP block."""
    x = _self_attention_block(x, emb, lora, bp["fa"], cos, sin, cfg.num_heads,
                              attn_backend)
    x = _cross_attention_block(x, emb, lora, bp["ca"], context, cfg.num_heads)
    return _mlp_block(x, emb, lora, bp["mlp"])


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def dit_forward(
    params: Params,
    x: torch.Tensor,
    sigma: torch.Tensor,
    latent_condition: torch.Tensor,
    context_index: Optional[torch.Tensor],
    cfg: DiTConfig,
    *,
    attn_backend: str = "auto",
) -> torch.Tensor:
    """One denoiser evaluation F(x; sigma, condition).

    x: (B, T, H, W, C_in) channels-last, already c_in-scaled; sigma: (B,)
    raw noise levels; latent_condition: (B, T, H, W, C_cond);
    context_index: (B,) G-buffer selector (used when the config has a
    context embedding).  Returns (B, T, H, W, C_out) in x's dtype."""
    b, t, h, w, _ = x.shape
    d = cfg.model_channels
    dtype = x.dtype

    # Main embedding: the raw sinusoid; the MLP output is the shared lora.
    t_emb, lora = timestep_embedding(sigma.to(dtype), params["t_embedder"]["w1"],
                                     params["t_embedder"]["w2"], d)
    affline_emb = rms_norm(t_emb, params["affline_norm"]["weight"])

    if cfg.use_context_embedding:
        table = params["context_embedding"]["weight"]
        idx = context_index.reshape(b).to(device=table.device, dtype=torch.long)
        context = table[idx][:, None, :].to(dtype)
    else:
        context = torch.zeros(b, 1, cfg.crossattn_emb_channels, dtype=dtype,
                              device=x.device)

    parts = [x, latent_condition.to(dtype)]
    if cfg.concat_padding_mask:
        parts.append(torch.ones(b, t, h, w, 1, dtype=dtype, device=x.device))
    xe = params["x_embedder"]
    patches = patch_embed(torch.cat(parts, dim=-1), xe["weight"], xe.get("bias"),
                          cfg.patch_spatial, cfg.patch_temporal)
    _, tp, hp, wp, _ = patches.shape
    tokens = patches.reshape(b, tp * hp * wp, d)

    angles = rope_3d_angles(
        tp, hp, wp, cfg.head_dim,
        h_ntk_factor=cfg.rope_h_extrapolation_ratio,
        w_ntk_factor=cfg.rope_w_extrapolation_ratio,
        t_ntk_factor=cfg.rope_t_extrapolation_ratio,
        device=x.device,
    )
    cos, sin = torch.cos(angles), torch.sin(angles)

    for bp in params["blocks"]:
        tokens = block_apply(bp, tokens, affline_emb, lora, context, cos, sin, cfg,
                             attn_backend)

    # Final layer: 2-chunk AdaLN on the first 2D slice of the shared lora.
    fin = params["final"]
    mod = adaln_modulation(affline_emb, fin["adaln_w1"], fin["adaln_w2"],
                           lora[:, : 2 * d])
    shift, scale = [c.to(dtype) for c in mod.chunk(2, dim=-1)]
    out = F.linear(modulate(layer_norm_no_affine(tokens), shift, scale), fin["linear"])
    return unpatchify(out, tp, hp, wp, cfg.patch_spatial, cfg.patch_temporal,
                      cfg.out_channels)
