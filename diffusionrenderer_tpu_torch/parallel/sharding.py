"""The (data, seq, tensor) mesh on torch.distributed (counterpart of
diffusionrenderer_tpu/parallel/sharding.py).

One process per device.  Rank r sits at mesh coordinates (d, s, t) with
r = (d * seq + s) * tensor + t, the order in which the JAX package reshapes
its device list.  Where JAX declares NamedShardings and lets XLA insert the
collectives, each rank here holds its own slice and the code that needs
another rank's data asks for it:

* data   - batch rows (the 5 inverse G-buffer passes batch here too); the
  pipeline slices rows with `batch_slice` and gathers the uint8 result with
  `gather_batch`;
* seq    - the token axis of the DiT's (B, L, D) activations; `token_slice`
  keeps a rank's L/seq tokens, `gather_tokens` joins them (attention's K
  and V, and the final layer's output before unpatchify);
* tensor - Megatron sharding of the block matmuls: not ported yet, a mesh
  with tensor > 1 raises NotImplementedError (ROADMAP.md queue 1, item 7).

Parameters stay replicated: every rank loads the whole model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

def mesh_shape(n: int, data: Optional[int] = None, seq: Optional[int] = None,
               tensor: Optional[int] = None) -> Tuple[int, int, int]:
    """The JAX package's factor rule: with any factor unset, tensor gets up
    to 2, seq up to 2, and the rest goes to data."""
    if data is None or seq is None or tensor is None:
        tensor = tensor or (2 if n % 2 == 0 else 1)
        rem = n // tensor
        seq = seq or (2 if rem % 2 == 0 else 1)
        data = data or rem // seq
    if data * seq * tensor != n:
        raise ValueError(f"mesh {data}x{seq}x{tensor} != {n} devices")
    return data, seq, tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, seq, tensor) mesh: the axis sizes, its
    coordinates, and the process groups along data and seq (the ranks that
    share its other coordinates).  seq_ranks lists the global ranks of its
    seq group in seq order (ring attention sends to the next one)."""

    data: int
    seq: int
    tensor: int
    rank: int
    coords: Tuple[int, int, int]
    data_group: Any
    seq_group: Any
    seq_ranks: Tuple[int, ...]


def initialize_distributed(device: DeviceLike = None, *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Join the default process group, once per process (a second call is a
    no-op).  NCCL for CUDA (the default device); gloo only when the caller
    asks for device='cpu'.  Without arguments the rendezvous comes from the
    environment torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    otherwise pass init_method (e.g. 'tcp://localhost:29500'), world_size and
    rank.  On CUDA each process takes the card LOCAL_RANK names (else its
    rank modulo the visible cards)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend: the mesh on CUDA "
                               "runs on NCCL (gloo only for device='cpu')")
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://", **kwargs)


def _group(ranks: List[int]):
    """A process group over ranks (WORLD when they are all of them).  Every
    rank must create every group, in the same order."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              seq: Optional[int] = None, tensor: Optional[int] = None) -> Mesh:
    """The (data, seq, tensor) mesh over all ranks of the default process
    group (initialize_distributed first); n_devices, if given, must be the
    world size.  Factors follow mesh_shape.  Every rank must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed()")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a {n}-device mesh needs {n} ranks; the process group has {world}")
    data, seq, tensor = mesh_shape(n, data, seq, tensor)
    if tensor > 1:
        raise NotImplementedError(
            f"tensor={tensor}: Megatron tensor parallelism is not ported yet "
            "(ROADMAP.md queue 1, item 7); use tensor=1")
    rank = dist.get_rank()
    di, si = divmod(rank, seq)
    seq_group = data_group = None
    for d in range(data):  # one seq group per data index
        g = _group([d * seq + s for s in range(seq)])
        if d == di:
            seq_group = g
    for s in range(seq):  # one data group per seq index
        g = _group([d * seq + s for d in range(data)])
        if s == si:
            data_group = g
    return Mesh(data, seq, tensor, rank, (di, si, 0), data_group, seq_group,
                tuple(di * seq + s for s in range(seq)))


# ---------------------------------------------------------------------------
# Slices and gathers (the port's stand-ins for token_sharding_constraint and
# batch_sharding: JAX states the layout, here each rank keeps its part).
# ---------------------------------------------------------------------------

def token_slice(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's L/seq tokens of x along dim (L must divide)."""
    n = x.shape[dim]
    if n % mesh.seq:
        raise ValueError(f"{n} tokens do not split over seq={mesh.seq}")
    part = n // mesh.seq
    return x.narrow(dim, mesh.coords[1] * part, part)


def gather_tokens(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The seq group's token slices of x joined along dim, in seq order
    (all_gather_into_tensor, tiled on the token axis; a copy over one rank).
    The result is contiguous."""
    x = x.contiguous()
    out = torch.empty((mesh.seq * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.seq_group)
    out = out.view(mesh.seq, *x.shape)  # rank-major
    return out.movedim(0, dim).flatten(dim, dim + 1).contiguous()


def batch_rows_split(rows: int, mesh: Mesh) -> bool:
    """Whether a batch of `rows` rows is sharded over data (it divides);
    otherwise every data index holds all rows."""
    return mesh.data > 1 and rows % mesh.data == 0


def batch_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's B/data leading rows of x when B divides data, else all
    of x (replicated, as the JAX package's batch sharding leaves it)."""
    if not batch_rows_split(x.shape[0], mesh):
        return x
    part = x.shape[0] // mesh.data
    return x.narrow(0, mesh.coords[0] * part, part)


def gather_batch(x: torch.Tensor, mesh: Mesh, rows: int) -> torch.Tensor:
    """The full `rows`-row batch from each rank's batch_slice of it."""
    if not batch_rows_split(rows, mesh):
        return x
    x = x.contiguous()
    out = torch.empty((mesh.data * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.data_group)
    return out
