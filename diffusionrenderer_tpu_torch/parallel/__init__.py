"""Multi-device execution on torch.distributed: the (data, seq) mesh, ring
attention and all-gather-KV sequence-parallel attention."""

from .flash_sp import make_gathered_attention, make_sp_attention
from .ring_attention import make_ring_attention, ring_attention_local
from .sharding import (
    Mesh,
    batch_slice,
    gather_batch,
    gather_tokens,
    initialize_distributed,
    make_mesh,
    mesh_shape,
    token_slice,
)
