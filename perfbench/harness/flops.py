"""Operation and byte counts of the DiT and of its attention calls, from a
configuration file's sizes (the yardstick: the program's own counts are
not read).  A one-token context's cross-attention collapses exactly to
W_o W_v context per row, so it adds no per-token product."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from . import peaks


def dit_dims(net: Dict) -> Dict[str, int]:
    d = int(net["model_channels"])
    ps, pt = int(net["patch_spatial"]), int(net["patch_temporal"])
    cin = int(net["in_channels"]) + int(net["additional_concat_ch"]) + (
        1 if net["concat_padding_mask"] else 0)
    return {"d": d, "hidden": int(d * net["mlp_ratio"]), "r": int(net["adaln_lora_dim"]),
            "ctx": int(net["crossattn_emb_channels"]), "blocks": int(net["num_blocks"]),
            "heads": int(net["num_heads"]), "head_dim": d // int(net["num_heads"]),
            "patch_dim": cin * ps * ps * pt, "out_dim": ps * ps * pt * int(net["out_channels"])}


def dit_tokens(net: Dict, latent_thw: Tuple[int, int, int]) -> int:
    t, h, w = latent_thw
    return (t // int(net["patch_temporal"])) * (h // int(net["patch_spatial"])) * (
        w // int(net["patch_spatial"]))


def dit_forward_flops(net: Dict, rows: int, tokens: int) -> float:
    """Model FLOPs of one DiT forward over `rows` rows of `tokens` tokens:
    every matmul and both attention products, at 2 FLOPs a multiply-add."""
    m = dit_dims(net)
    d, hid, r, ctx, nb = m["d"], m["hidden"], m["r"], m["ctx"], m["blocks"]
    per_token = (2 * m["patch_dim"] * d + 2 * d * m["out_dim"]
                 + nb * (8 * d * d + 4 * tokens * d + 4 * d * hid))
    adaln = 2 * d * r + 2 * r * 3 * d
    per_row = (2 * d * d + 2 * d * 3 * d                      # t_embedder
               + nb * (3 * adaln + 2 * d * ctx + 2 * d * d)   # AdaLN x3, CA collapse
               + 2 * d * r + 2 * r * 2 * d)                   # final AdaLN
    return float(rows) * (tokens * per_token + per_row)


def attention_flops(b: int, h: int, lq: int, lk: int, d: int) -> float:
    return 4.0 * b * h * lq * lk * d


def attention_bytes(b: int, h: int, lq: int, lk: int, d: int, elem: int = 2) -> float:
    """q, k and v read once and o written once."""
    return float(elem) * b * h * d * (2 * lq + 2 * lk)


def attention_least_seconds(b: int, h: int, lq: int, lk: int, d: int) -> float:
    """The least time the card could take for one bf16 attention call."""
    return max(attention_flops(b, h, lq, lk, d) / peaks.BF16_FLOPS,
               attention_bytes(b, h, lq, lk, d) / peaks.HBM_BYTES_PER_S)


def calls_least_seconds(calls: Iterable[Tuple[int, int, int, int, int, int]]) -> float:
    """Sum over (count, b, h, lq, lk, d) of count x the least time."""
    return sum(n * attention_least_seconds(b, h, lq, lk, d) for n, b, h, lq, lk, d in calls)


def render_attention_calls(net: Dict, vae: Dict, *, rows: int, latent_thw: Tuple[int, int, int],
                           steps: int, encodes: int, cfg_rows: int = 1
                           ) -> List[Tuple[int, int, int, int, int, int]]:
    """The attention kernel calls of one render: each step's DiT blocks at
    (rows x cfg_rows, L, heads, head_dim); each condition encode's and the
    decode's VAE mid-block spatial attention, one head of the deepest
    encoder width over the latent's H x W per latent frame."""
    m = dit_dims(net)
    l = dit_tokens(net, latent_thw)
    t, h, w = latent_thw
    c_mid = int(vae["encoder_block_out_channels"][-1])
    hw = h * w
    return [(steps * m["blocks"], rows * cfg_rows, m["heads"], l, l, m["head_dim"]),
            (encodes, t, 1, hw, hw, c_mid),
            (1, rows * t, 1, hw, hw, c_mid)]
