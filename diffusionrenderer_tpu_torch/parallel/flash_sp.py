"""Sequence-parallel attention over the mesh's seq axis (counterpart of
diffusionrenderer_tpu/parallel/flash_sp.py).

Every rank holds its token shard of q and all-gathers K and V over seq
(dist.all_gather_into_tensor, tiled on the token axis), then runs the flash
kernel on its local (L/seq, L) tile.  Exact, non-causal; batch rows ride
data, heads ride tensor.  Under autograd the gather's backward
reduce-scatters dK and dV over seq, and the attention on the gathered KV is
ops/flash_attention.FlashAttentionFunction (kernel 3 forward on CUDA
tensors).  impl='ring' dispatches to parallel/ring_attention.py instead (KV
passed around the ring, nothing global ever materialized; under autograd
its own ring of gradients, RingAttentionFunction on CUDA tensors).
"""

from __future__ import annotations

from ..ops.attention import attention
from ..ops.flash_attention import flash_attention
from .collectives import all_gather_kv
from .ring_attention import ring_attention_local
from .sharding import Mesh


def make_sp_attention(mesh: Mesh, impl: str = "flash"):
    """A callable on this rank's (B, L/seq, H, Dh) q, k, v shards returning
    its output shard.  impl: 'flash' - all-gather KV over seq, then the
    flash kernel with its default bounded=False (the online softmax, as in
    JAX); 'ring' - ring attention."""
    if impl not in ("flash", "ring"):
        raise ValueError(f"unknown sequence-parallel attention impl {impl!r}")

    def local(q, k, v):
        if impl == "ring":
            return ring_attention_local(q, k, v, mesh)
        return flash_attention(q, all_gather_kv(k, mesh.seq_group), all_gather_kv(v, mesh.seq_group))

    return local


def make_gathered_attention(mesh: Mesh, backend: str):
    """All-gather KV over seq, then ops.attention(backend=...) on the local
    tile: what XLA's partitioned attention computes under the JAX package's
    mesh for the string backends ('xla', 'pallas', ...)."""

    def local(q, k, v):
        return attention(q, all_gather_kv(k, mesh.seq_group), all_gather_kv(v, mesh.seq_group),
                         backend=backend)

    return local
