"""Multi-device execution on torch.distributed: the (data, seq, tensor)
mesh and its parameter shardings, ring attention and all-gather-KV
sequence-parallel attention, GPipe over the blocks, and the collectives
with their gradients."""

from .flash_sp import make_gathered_attention, make_sp_attention
from .pipeline_parallel import (
    AXIS_PIPE,
    make_pp_executor,
    make_pp_mesh,
    pp_block_shardings,
)
from .ring_attention import make_ring_attention, ring_attention_local
from .sharding import (
    AXIS_DATA,
    AXIS_SEQ,
    AXIS_TENSOR,
    Mesh,
    Sharding,
    batch_sharding,
    batch_slice,
    dit_param_shardings,
    gather_batch,
    gather_tokens,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    mesh_shape,
    shard_params,
    token_sharding_constraint,
    token_slice,
    vae_param_shardings,
)
