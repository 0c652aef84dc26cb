"""Attention ops: the plain reference path and the dispatcher to the flash
kernel (counterpart of diffusionrenderer_tpu/ops/attention.py).

Layout is (B, L, H, Dh) throughout; non-causal, no mask.  The backend
strings keep the JAX package's names: here 'pallas' and 'pallas_onlinemax'
name the hand-written CUDA flash kernel family (ops/flash_attention.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import HEAD_DIMS, flash_attention

BACKENDS = ("auto", "xla", "pallas", "pallas_onlinemax", "pallas_pv_int8")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with fp32 logits and softmax.

    q: (B, Lq, H, Dh); k, v: (B, Lk, H, Dh) -> (B, Lq, H, Dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              backend: str = "auto") -> torch.Tensor:
    """Dispatching attention entry point.

    'auto' takes the flash kernel for CUDA tensors with long enough
    sequences (_use_pallas) and the plain path otherwise; 'pallas' forces
    the bounded flash kernel (no-shift branch when the headroom rule holds,
    online softmax otherwise); 'pallas_onlinemax' forces the online-softmax
    branch; 'xla' is the plain path.  On CPU tensors the flash backends run
    the kernel's plain version."""
    if backend == "xla":
        return attention_xla(q, k, v)
    if backend == "pallas_pv_int8":
        raise NotImplementedError(
            "backend='pallas_pv_int8' (the int8 QK^T/PV flash kernel) is not "
            "ported yet: ROADMAP.md queue 2, item 5")
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend in ("pallas", "pallas_onlinemax") or _use_pallas(q, k):
        return flash_attention(q, k, v, bounded=backend != "pallas_onlinemax")
    return attention_xla(q, k, v)


def _use_pallas(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's routing rule, with "is a CUDA tensor" in place of
    "runs on a TPU": tiny key or query sets (the 1-token cross-attention)
    gain nothing from the kernel."""
    return (q.is_cuda and q.shape[1] >= 256 and k.shape[1] >= 256
            and q.shape[-1] in HEAD_DIMS)


def cross_attention_single_kv(context: torch.Tensor, wk_unused: Optional[torch.Tensor],
                              wv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Exact cross-attention over a single KV token: softmax over one key is
    identically 1, so the output is W_v context for every query.

    context: (B, 1, C_ctx); wv: (D, C_ctx).  Returns v: (B, 1, H, Dh)."""
    v = F.linear(context, wv)
    return v.reshape(context.shape[0], 1, num_heads, v.shape[-1] // num_heads)
