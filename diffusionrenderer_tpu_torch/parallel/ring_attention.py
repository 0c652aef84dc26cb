"""Ring attention: sequence-parallel exact attention over the mesh's seq
axis (counterpart of diffusionrenderer_tpu/parallel/ring_attention.py).

Each rank holds a token shard of q, k and v, computes the partial attention
of its queries against the KV shard it holds, and passes KV on around the
ring (one all_to_all_single hop to the next rank of its seq group, n - 1
times: gloo takes no point-to-point operation on CUDA tensors), merging the partial states with the online-softmax combine.  No
rank ever holds the full KV or any L x L block.  Exact, non-causal.

The inner block is the partial-stats flash kernel
(ops/flash_attention.flash_attention_partial: kernel 3 on CUDA tensors);
impl='xla' uses plain einsum pieces.  All softmax statistics live in the
log2 domain (the kernel pre-scales q by softmax_scale * log2 e), and the
merge uses exp2 to match.

It has no gradient: the backward of the partial-stats kernel's m and l is
not ported (ROADMAP.md queue 1 item 7), so a call under
autograd raises; the all-gather attention (flash_sp) trains.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.flash_attention import flash_attention_partial
from .collectives import shift
from .sharding import Mesh

_LOG2E = math.log2(math.e)
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _partial_attn_xla(q, k, v, scale2: float) -> State:
    """Unnormalized attention state of one KV block (plain pieces).

    q: (B, Lq, H, D); k, v: (B, Lk, H, D).  Returns fp32 (m, l, o): the row
    max (B, H, Lq) and normalizer (B, H, Lq) in the log2 domain, and the
    unnormalized output (B, Lq, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale2
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _partial_attn_flash(q, k, v) -> State:
    """The partial-stats flash block, un-normalized for merging (o = out * l)."""
    out, m, l = flash_attention_partial(q, k, v)
    return m, l, out.float() * l.permute(0, 2, 1)[..., None]


def _merge(state: State, update: State) -> State:
    """Online-softmax merge of two partial states (log2 domain)."""
    m_a, l_a, o_a = state
    m_b, l_b, o_b = update
    m = torch.maximum(m_a, m_b)
    a = torch.exp2(m_a - m)
    b = torch.exp2(m_b - m)
    l = l_a * a + l_b * b
    o = o_a * a.permute(0, 2, 1)[..., None] + o_b * b.permute(0, 2, 1)[..., None]
    return m, l, o


def _rotate(tensors, mesh: Mesh):
    """Send each tensor to the next rank of the seq ring and receive the
    previous rank's."""
    return [shift(t, mesh.seq_group) for t in tensors]


def ring_attention_local(q, k, v, mesh: Mesh, impl: str = "auto") -> torch.Tensor:
    """Per-rank body: q, k, v are this rank's (B, L_local, H, D) token
    shards; returns its (B, L_local, H, D) output.  impl: 'flash' (the
    partial-stats kernel's wrapper), 'xla' (plain pieces), or 'auto' (flash
    for CUDA tensors, xla otherwise).  Raises under autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring attention has no gradient yet (the backward of kernel 3's m and l: "
            "ROADMAP.md queue 1 item 7, ring attention's backward); train with "
            "attn_backend='flash_sp' or 'auto' (the all-gathered KV)")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl == "flash":
        partial_fn = _partial_attn_flash
    elif impl == "xla":
        scale2 = _LOG2E / math.sqrt(q.shape[-1])

        def partial_fn(qq, kk, vv):
            return _partial_attn_xla(qq, kk, vv, scale2)
    else:
        raise ValueError(f"unknown ring attention impl {impl!r}")

    state = partial_fn(q, k, v)
    for _ in range(mesh.seq - 1):
        k, v = _rotate((k, v), mesh)
        state = _merge(state, partial_fn(q, k, v))
    _, l, o = state
    return (o / l.permute(0, 2, 1)[..., None]).to(q.dtype)


def make_ring_attention(mesh: Mesh, impl: str = "auto"):
    """Ring attention over the mesh's seq axis: a callable taking this
    rank's (B, L/seq, H, D) shards of q, k, v (its batch rows, its tokens)
    and returning its shard of the output."""

    def ring(q, k, v):
        return ring_attention_local(q, k, v, mesh, impl=impl)

    return ring
