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

Both impls train.  impl='xla' is plain torch with `ShiftFunction` hops
under autograd, so autograd differentiates it as jax.grad differentiates
JAX's.  impl='flash' under autograd is `RingAttentionFunction`,
differentiated as a whole: its forward saves q, this rank's k and v, the
output and the merged (m, l); its backward passes each KV block around the
ring again, with a gradient accumulator that travels beside it, and takes
the block's share of (dq, dk, dv) from the plain chunked backward
(ops/flash_attention.flash_attention_backward_plain) on the global m, l
and output, whose P and D_i are the full softmax's.  dq sums over the hops
in fp32 on its rank; one more hop brings each block's dk and dv home.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.flash_attention import flash_attention_backward_plain, flash_attention_partial
from .collectives import ShiftFunction, shift
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
    previous rank's.  A tensor autograd records takes ShiftFunction (its
    gradient hops back); inside RingAttentionFunction autograd records
    nothing, so its hops are plain `shift`."""
    return [ShiftFunction.apply(t, mesh.seq_group, 1)
            if torch.is_grad_enabled() and t.requires_grad else shift(t, mesh.seq_group)
            for t in tensors]


def _ring(q, k, v, mesh: Mesh, partial_fn):
    """The ring's forward: (out in q's dtype, the merged fp32 (B, H, Lq) m
    and l over every rank's keys)."""
    state = partial_fn(q, k, v)
    for _ in range(mesh.seq - 1):
        k, v = _rotate((k, v), mesh)
        state = _merge(state, partial_fn(q, k, v))
    m, l, o = state
    return (o / l.permute(0, 2, 1)[..., None]).to(q.dtype), m, l


class RingAttentionFunction(torch.autograd.Function):
    """Ring attention on the partial-stats flash block with a gradient:
    kernel 3 at each hop of the forward on CUDA tensors (its plain version
    on CPU ones), and a backward ring of the plain chunked backward, which
    launches no kernel (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh):
        out, m, l = _ring(q, k, v, mesh, _partial_attn_flash)
        ctx.mesh = mesh
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        mesh = ctx.mesh
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for hop in range(mesh.seq):
            if hop:  # the block and its gradient so far move on together
                k, v, dk, dv = _rotate((k, v, dk, dv), mesh)
            gq, gk, gv = flash_attention_backward_plain(q, k, v, out, m, l, do,
                                                        grad_dtype=torch.float32)
            dq += gq
            dk += gk
            dv += gv
        # After seq - 1 hops each rank holds the block of the rank ahead.
        dk, dv = _rotate((dk, dv), mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention_local(q, k, v, mesh: Mesh, impl: str = "auto") -> torch.Tensor:
    """Per-rank body: q, k, v are this rank's (B, L_local, H, D) token
    shards; returns its (B, L_local, H, D) output.  impl: 'flash' (the
    partial-stats kernel's wrapper; RingAttentionFunction under autograd),
    'xla' (plain pieces, which autograd differentiates), or 'auto' (flash
    for CUDA tensors, xla otherwise)."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl == "flash":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return RingAttentionFunction.apply(q, k, v, mesh)
        return _ring(q, k, v, mesh, _partial_attn_flash)[0]
    if impl != "xla":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    scale2 = _LOG2E / math.sqrt(q.shape[-1])
    return _ring(q, k, v, mesh, lambda qq, kk, vv: _partial_attn_xla(qq, kk, vv, scale2))[0]


def make_ring_attention(mesh: Mesh, impl: str = "auto"):
    """Ring attention over the mesh's seq axis: a callable taking this
    rank's (B, L/seq, H, D) shards of q, k, v (its batch rows, its tokens)
    and returning its shard of the output."""

    def ring(q, k, v):
        return ring_attention_local(q, k, v, mesh, impl=impl)

    return ring
