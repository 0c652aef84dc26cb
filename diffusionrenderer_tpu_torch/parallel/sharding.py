"""The (data, seq, tensor) mesh on torch.distributed (counterpart of
diffusionrenderer_tpu/parallel/sharding.py).

One process per device.  make_mesh puts rank r at mesh coordinates
(d, s, t) with r = (d * seq + s) * tensor + t, the order in which the JAX
package reshapes its device list; make_hybrid_mesh places whole nodes on
the data axis.  Where JAX declares NamedShardings and lets XLA insert the
collectives, each rank here holds its own slice and the code that needs
another rank's data asks for it:

* data   - batch rows (the 5 inverse G-buffer passes batch here too): the
  pipeline slices rows with `batch_slice` and gathers the uint8 result with
  `gather_batch`;
* seq    - the token axis of the DiT's (B, L, D) activations: `token_slice`
  keeps a rank's L/seq tokens, `gather_tokens` joins them (attention's K
  and V, and the final layer's output before unpatchify);
* tensor - Megatron sharding of the block matmuls: `dit_param_shardings`
  says which slice of each weight a rank keeps (column-parallel q, k, v and
  MLP-in keep output rows, row-parallel out and MLP-out keep input
  columns), `shard_params` keeps it, and models/dit.py sums the
  row-parallel products over the tensor group.

A "sharding" here (`Sharding`) names the slice of a full tensor that a rank
keeps; the JAX names (`dit_param_shardings`, `vae_param_shardings`,
`shard_params`, `token_sharding_constraint`, `batch_sharding`) keep their
meaning in that sense.  The collectives and their gradients are in
parallel/collectives.py.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map
from .collectives import gather_replicated

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"


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
    coordinates, the global rank at every coordinate (`ranks`, nested
    (data, seq, tensor)), and the process groups of the ranks that share
    all its coordinates but one (data_group, seq_group, tensor_group) or
    its tensor coordinate (replica_group: the data x seq ranks holding the
    same parameter shard).  tensor_ranks lists the global ranks of its
    tensor group in axis order."""

    data: int
    seq: int
    tensor: int
    rank: int
    coords: Tuple[int, int, int]
    ranks: Tuple[Tuple[Tuple[int, ...], ...], ...]
    data_group: Any
    seq_group: Any
    tensor_group: Any
    replica_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_DATA: self.data, AXIS_SEQ: self.seq, AXIS_TENSOR: self.tensor}

    @property
    def tensor_ranks(self) -> Tuple[int, ...]:
        d, s, _ = self.coords
        return self.ranks[d][s]


def initialize_distributed(device: DeviceLike = None, *, backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Join the default process group, once per process (a second call is a
    no-op).  backend: 'nccl' (the default for CUDA, the default device) or
    'gloo' (the default for device='cpu'; on CUDA only when the caller asks
    for it: gloo stages CUDA tensors through the host, and several ranks
    may then share one card, which NCCL refuses).  Without arguments the
    rendezvous comes from the environment torchrun sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK); otherwise pass init_method (e.g.
    'tcp://localhost:29500'), world_size and rank.  On CUDA each process
    takes the card LOCAL_RANK names (else its rank modulo the visible
    cards)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown process-group backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on CUDA devices; device='cpu' takes gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend")
    if dev.type == "cuda":
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://", **kwargs)


def _group(ranks: Sequence[int]):
    """A process group over ranks (WORLD when they are all of them).  Every
    rank must create every group, in the same order."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(sorted(ranks))


def _mesh_from_grid(grid: np.ndarray) -> Mesh:
    """The Mesh of this rank over a (data, seq, tensor) array of global
    ranks.  Creates every group of the mesh on every rank, in one order."""
    data, seq, tensor = grid.shape
    rank = dist.get_rank()
    (d0,), (s0,), (t0,) = np.nonzero(grid == rank)
    mine = {}
    axes = {"seq": lambda d, s, t: grid[d, :, t], "data": lambda d, s, t: grid[:, s, t],
            "tensor": lambda d, s, t: grid[d, s, :]}
    for name, members in axes.items():
        seen = set()
        for d in range(data):
            for s in range(seq):
                for t in range(tensor):
                    key = tuple(int(r) for r in members(d, s, t))
                    if key in seen:
                        continue
                    if list(key) != sorted(key):
                        # A group numbers its ranks in global order; the
                        # gathers read that order as the axis order.
                        raise ValueError(f"the {name} group {list(key)} is not in rank order")
                    seen.add(key)
                    g = _group(key)
                    if rank in key:
                        mine[name] = g
    for t in range(tensor):
        g = _group([int(r) for r in grid[:, :, t].reshape(-1)])
        if t == t0:
            mine["replica"] = g
    ranks = tuple(tuple(tuple(int(r) for r in row) for row in plane) for plane in grid)
    return Mesh(data, seq, tensor, rank, (int(d0), int(s0), int(t0)), ranks, mine["data"],
                mine["seq"], mine["tensor"], mine["replica"])


def _world(n_devices: Optional[int]) -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call initialize_distributed()")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a {n}-device mesh needs {n} ranks; the process group has {world}")
    return world


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              seq: Optional[int] = None, tensor: Optional[int] = None) -> Mesh:
    """The (data, seq, tensor) mesh over all ranks of the default process
    group (initialize_distributed first); n_devices, if given, must be the
    world size.  Factors follow mesh_shape: with none given, 2 or 4 ranks
    give tensor = 2.  Every rank must call it."""
    n = _world(n_devices)
    shape = mesh_shape(n, data, seq, tensor)
    return _mesh_from_grid(np.arange(n).reshape(shape))


def _node_of_ranks() -> List[int]:
    """The node of every rank, numbered by first appearance: from
    LOCAL_WORLD_SIZE (ranks per node, as torchrun sets it) when set, else
    from the ranks' host names."""
    world = dist.get_world_size()
    lws = os.environ.get("LOCAL_WORLD_SIZE")
    if lws is not None:
        per = int(lws)
        if per < 1 or world % per:
            raise ValueError(f"LOCAL_WORLD_SIZE={per} does not divide the {world} ranks")
        return [r // per for r in range(world)]
    names: List[Any] = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    ids: Dict[str, int] = {}
    return [ids.setdefault(h, len(ids)) for h in names]


def make_hybrid_mesh(dcn_data: int, data: int = 1, seq: int = 1, tensor: int = 1) -> Mesh:
    """A (data, seq, tensor) mesh over several nodes: the data axis is
    dcn_data (across nodes) x data (within a node), and the seq and tensor
    groups (a gather per block, a sum per row-parallel matmul) never span a
    node; only data, which trains with one gradient sum per step and renders
    with none, crosses the slower link between nodes.

    Nodes are found from LOCAL_WORLD_SIZE or the ranks' host names.  With
    dcn_data nodes, node n's ranks (in rank order) fill data rows n * data
    to (n + 1) * data; ranks that all report one node stand in for nodes in
    contiguous groups of data * seq * tensor; any other node count is
    refused, since a contiguous layout would let seq or tensor span nodes."""
    per_node = data * seq * tensor
    world = _world(None)
    if world != dcn_data * per_node:
        raise ValueError(f"hybrid mesh {dcn_data}x({data}x{seq}x{tensor}) needs "
                         f"{dcn_data * per_node} devices, {world} visible")
    nodes = _node_of_ranks()
    count = len(set(nodes))
    if count == dcn_data:
        members = [[r for r in range(world) if nodes[r] == n] for n in range(count)]
        if any(len(m) != per_node for m in members):
            raise ValueError(f"make_hybrid_mesh needs {per_node} ranks on each node; the "
                             f"nodes hold {[len(m) for m in members]}")
        grid = np.concatenate([np.asarray(m).reshape(data, seq, tensor) for m in members])
    elif count > 1:
        raise ValueError(f"make_hybrid_mesh(dcn_data={dcn_data}) but the ranks span "
                         f"{count} nodes; pass dcn_data={count} so seq/tensor collectives "
                         "stay within a node")
    else:
        grid = np.arange(world).reshape(dcn_data * data, seq, tensor)
    return _mesh_from_grid(grid)


# ---------------------------------------------------------------------------
# Parameter shardings (JAX sharding.py:71-151, in the port's (out, in) layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """The slice of a full tensor a rank keeps: part `index` of `parts`
    equal parts along `dim`, or the whole tensor when dim is None."""

    dim: Optional[int] = None
    parts: int = 1
    index: int = 0

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dim is None or self.parts == 1:
            return t
        n = t.shape[self.dim]
        if n % self.parts:
            raise ValueError(f"axis {self.dim} of {n} does not split {self.parts} ways")
        part = n // self.parts
        return t.narrow(self.dim, self.index * part, part).clone(
            memory_format=torch.contiguous_format)


REPLICATED = Sharding()
COLUMN_PARALLEL = ("wq", "wk", "wv", "w1")
ROW_PARALLEL = ("wo", "w2")


def _leaf_shardings(name: str, leaf: Any, tp: int, t: int) -> Any:
    """The sharding of one block leaf (a dict of them for a quantized leaf)."""
    col, row = Sharding(0, tp, t), Sharding(1, tp, t)
    if name not in COLUMN_PARALLEL + ROW_PARALLEL:
        return REPLICATED
    if not isinstance(leaf, dict):
        return col if name in COLUMN_PARALLEL else row
    scale = leaf["sa"] if "sa" in leaf else leaf["s"]
    grouped = scale.dim() == 2
    k = leaf["q"].shape[1]
    if name in COLUMN_PARALLEL:
        # Output rows: the codes, and each output channel's scales.
        scale_sh = Sharding(1 if grouped else 0, tp, t)
        return {key: col if key == "q" else REPLICATED if key in ("di", "hs") else scale_sh
                for key in leaf}
    # Input columns: whole groups of K per rank; per-channel scales are
    # replicated; the input-space transforms go with their K.
    if grouped and (k // tp) % (k // scale.shape[0]):
        raise ValueError(f"a row-parallel weight of K={k} in groups of {k // scale.shape[0]} "
                         f"does not split into whole groups over tensor={tp}")
    if "hs" in leaf and (k // tp) % 128:
        raise ValueError(f"a Hadamard-rotated row-parallel weight needs K/tensor a multiple "
                         f"of the 128-row rotation block; K={k}, tensor={tp}")
    scale_sh = Sharding(0, tp, t) if grouped else REPLICATED
    return {key: row if key == "q" else Sharding(0, tp, t) if key in ("di", "hs") else scale_sh
            for key in leaf}


def dit_param_shardings(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A tree like params of the Sharding each leaf keeps on this rank:
    Megatron tensor parallelism, column-parallel q, k, v and MLP-in,
    row-parallel out and MLP-out, everything else (AdaLN, norms, embedders,
    the final layer) replicated.  Quantized leaves follow JAX: the codes
    like their weight; per-channel scales on N when column-parallel and
    replicated when row-parallel; per-group (G, N) scales on N, or on G
    (whole groups per rank); 'di' and 'hs' replicated when column-parallel
    and with K when row-parallel.  Raises for a layout that cannot split."""
    tp, t = mesh.tensor, mesh.coords[2]
    blocks = params["blocks"]
    if tp > 1 and blocks:
        first = blocks[0]
        d = _dense_shape(first["fa"]["wq"])[0]
        hid = _dense_shape(first["mlp"]["w1"])[0]
        dh = first["fa"]["q_norm"].shape[-1]
        if (d // dh) % tp:
            raise ValueError(f"{d // dh} heads do not split over tensor={tp}")
        if hid % tp:
            raise ValueError(f"MLP hidden width {hid} does not split over tensor={tp}")
    out = tree_map(lambda _: REPLICATED, {k: v for k, v in params.items() if k != "blocks"})
    out["blocks"] = [
        {sub: {name: _leaf_shardings(name, leaf, tp, t) if tp > 1 else tree_map(
            lambda _: REPLICATED, leaf) for name, leaf in sp.items()}
         for sub, sp in bp.items()} if bp is not None else None
        for bp in blocks]
    return out


def _dense_shape(w: Any) -> Tuple[int, ...]:
    return tuple((w["q"] if isinstance(w, dict) else w).shape)


def vae_param_shardings(params: Any, mesh: Mesh) -> Any:
    """The VAE's weights (about 100M) are replicated on every rank."""
    return tree_map(lambda _: REPLICATED, params)


def shard_params(params: Any, shardings: Any) -> Any:
    """params with each leaf cut to its sharding's slice (a contiguous copy,
    so the full tensor can be freed); `shardings` is a tree like params."""
    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(p, s) for p, s in zip(params, shardings))
    if params is None:
        return None
    return shardings(params)


# ---------------------------------------------------------------------------
# Slices and gathers of activations
# ---------------------------------------------------------------------------

def token_slice(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's L/seq tokens of x along dim (L must divide)."""
    n = x.shape[dim]
    if n % mesh.seq:
        raise ValueError(f"{n} tokens do not split over seq={mesh.seq}")
    part = n // mesh.seq
    return x.narrow(dim, mesh.coords[1] * part, part)


def gather_tokens(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The seq group's token slices of x joined along dim, in seq order (a
    contiguous copy over one rank).  Under autograd the backward keeps this
    rank's slice of the gradient (the joined result is used alike on every
    rank; collectives.gather_replicated)."""
    return gather_replicated(x, mesh.seq_group, dim)


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
    """The full `rows`-row batch from each rank's batch_slice of it (the
    backward, like gather_tokens', keeps this rank's rows)."""
    if not batch_rows_split(rows, mesh):
        return x
    return gather_replicated(x, mesh.data_group, 0)


@dataclasses.dataclass(frozen=True)
class TokenShardingConstraint:
    """(B, L, ...) activations -> this rank's batch rows (over data) and
    tokens (over seq).  As dit_forward's seq_sharding_constraint it runs
    the forward on the mesh with the global batch in and out."""

    mesh: Mesh

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return token_slice(batch_slice(x, self.mesh), self.mesh)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """(B, ...) tensors -> this rank's rows over data (batch_slice)."""

    mesh: Mesh

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return batch_slice(x, self.mesh)


def token_sharding_constraint(mesh: Mesh) -> TokenShardingConstraint:
    """The layout of (B, L, D) activations: batch over data, tokens over
    seq (pass it to dit_forward, edm_loss or make_train_step as
    seq_sharding_constraint)."""
    return TokenShardingConstraint(mesh)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """The layout of (B, T, H, W, C) videos: batch over data."""
    return BatchSharding(mesh)
