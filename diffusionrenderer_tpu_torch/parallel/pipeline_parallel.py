"""Pipeline parallelism over the DiT's blocks, the GPipe schedule
(counterpart of diffusionrenderer_tpu/parallel/pipeline_parallel.py).

A (data, pipe) mesh of torch.distributed ranks: rank r sits at (d, s) with
r = d * num_stages + s, JAX's reshape(data, num_stages).  Stage s holds the
contiguous blocks [s * nb / S, (s + 1) * nb / S) (`pp_block_shardings`
keeps them and drops the rest).  The executor runs JAX's schedule of
M + S - 1 ticks (M microbatches, S stages): at tick t stage s works on
microbatch t - s (the ticks outside 0..M-1 are the pipeline's bubble and
compute on don't-care data), the last stage records its finished
microbatch, and one rotation s -> s + 1 runs per tick, which every rank
joins, bubble ticks included.

What differs from JAX, and why:

* The rotation is collectives.ShiftFunction (all_to_all_single with one
  non-zero split; gloo takes no point-to-point operation on CUDA tensors),
  whose backward rotates the gradient the other way, so the executor
  trains as JAX's differentiable scan does.  Stage 0's next microbatch
  arrives by the same rotation: the last stage, whose own result goes to
  the output and is never read by stage 0, sends the next feed in its
  place (every rank holds the whole batch).  Each rank's autograd graph is
  then one chain through every rotation but the last, so the rotations'
  backwards run in the same order on every rank.
* The result: the last stage's microbatches are gathered over data and
  broadcast over pipe, and every rank returns the whole (B, L, D); the
  backward keeps the last stage's own rows of the (replicated) gradient.
  The inputs' gradients are summed over all ranks, and, with a data axis,
  each block parameter's over its data group, so gradients come out whole
  on every rank.
* remat=True wraps each stage's blocks in torch.utils.checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..utils.tree import leaves, tree_map
from .collectives import ShiftFunction, _all_gather, grad_all_reduce
from .sharding import _group, _world

AXIS_PIPE = "pipe"


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """This rank's view of a (data, pipe) mesh: the axis sizes, its
    coordinates (d, s), and the groups of the ranks that share its data
    index (pipe_group, stages in order) or its stage (data_group)."""

    data: int
    pipe: int
    rank: int
    coords: tuple
    data_group: Any
    pipe_group: Any


def make_pp_mesh(num_stages: int, data: int = 1) -> PipeMesh:
    """The (data, pipe) mesh over all ranks of the default process group
    (there must be data * num_stages).  Every rank must call it."""
    _world(data * num_stages)
    rank = dist.get_rank()
    d, s = divmod(rank, num_stages)
    pipe_group = data_group = None
    for i in range(data):
        g = _group([i * num_stages + j for j in range(num_stages)])
        if i == d:
            pipe_group = g
    for j in range(num_stages):
        g = _group([i * num_stages + j for i in range(data)])
        if j == s:
            data_group = g
    return PipeMesh(data, num_stages, rank, (d, s), data_group, pipe_group)


@dataclasses.dataclass(frozen=True)
class StageSharding:
    """The blocks a stage keeps: a list of nb blocks -> the same list with
    None in place of the other stages' blocks."""

    stage: int
    stages: int

    def __call__(self, blocks: Sequence[Any]) -> List[Any]:
        nb = len(blocks)
        if nb % self.stages:
            raise ValueError(f"{nb} blocks not divisible by {self.stages} stages")
        per = nb // self.stages
        lo = self.stage * per
        return [bp if lo <= i < lo + per else None for i, bp in enumerate(blocks)]


def pp_block_shardings(mesh: PipeMesh) -> StageSharding:
    """The stage-contiguous split of params['blocks'] over pipe:
    params['blocks'] = pp_block_shardings(mesh)(params['blocks'])."""
    return StageSharding(mesh.coords[1], mesh.pipe)


class _GradSumInputs(torch.autograd.Function):
    """Identity on several tensors; the backward sums each gradient over the
    group in one node, so every rank runs the sums at one point of its
    backward whatever order its own graph reaches the inputs in."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _PipeOutput(torch.autograd.Function):
    """The last stage's finished microbatches, gathered over data (when the
    rows ride it) and broadcast over pipe: the whole (B, L, D) on every
    rank.  ys: every tick's stage output on the last stage (the bubble's
    get a zero gradient), the last tick's elsewhere (a zero gradient too:
    it ties the rank's rotations to the loss)."""

    @staticmethod
    def forward(ctx, spec, *ys):
        mesh, m, rows, use_data, shape = spec
        ctx.spec = spec
        d, s = mesh.coords
        last = s == mesh.pipe - 1
        ref = ys[-1]
        out = torch.empty(shape, dtype=ref.dtype, device=ref.device)
        if last:
            local = torch.stack(ys[len(ys) - m:])  # (M, rows, L, D)
            if use_data:
                local = _all_gather(local, mesh.data_group, 1)  # (M, data * rows, L, D)
            out.copy_(local.reshape(shape))
        src = mesh.rank - s + mesh.pipe - 1  # the last stage of this data index
        if mesh.pipe > 1:
            dist.broadcast(out, src=src, group=mesh.pipe_group)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, m, rows, use_data, shape = ctx.spec
        d, s = mesh.coords
        n_ticks = m + mesh.pipe - 1
        if s != mesh.pipe - 1:
            return None, g.new_zeros((rows, *shape[1:]))
        g = g.reshape(m, -1, *shape[1:])
        if use_data:
            g = g.narrow(1, d * rows, rows)
        zeros = [torch.zeros_like(g[0]) for _ in range(n_ticks - m)]
        return (None, *zeros, *g.contiguous().unbind(0))


def make_pp_executor(mesh: PipeMesh, num_microbatches: int, *, axis: str = AXIS_PIPE,
                     data_axis: Optional[str] = "data", remat: bool = False):
    """A block executor for dit_forward(block_executor=...):

    executor(blocks, tokens, emb, lora, context, cos, sin, apply_block)
      blocks:  the nb blocks (other stages' may be None); nb % S == 0
      tokens:  (B, L, D), the whole batch on every rank; B % M == 0, and
               with data_axis the microbatch rows (B / M) divide data
      emb, lora, context: per-sample conditioning, leading axis B
      apply_block: models.dit.make_block_apply's function (stage-local
               attention: no sequence-parallel callable)

    Returns the whole (B, L, D) on every rank.  data_axis=None keeps every
    microbatch row on every data index (each computes them all)."""
    if axis != AXIS_PIPE:
        raise ValueError(f"the pipe axis of a make_pp_mesh mesh is {AXIS_PIPE!r}, not {axis!r}")
    S, M = mesh.pipe, num_microbatches
    use_data = data_axis is not None and mesh.data > 1
    d, s = mesh.coords
    last = s == S - 1

    def executor(blocks, tokens, emb, lora, context, cos, sin, apply_block):
        nb = len(blocks)
        if nb % S != 0:
            raise ValueError(f"{nb} blocks not divisible by {S} stages")
        b, l, dim = tokens.shape
        if b % M != 0:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        mb = b // M
        if use_data and mb % mesh.data:
            raise ValueError(f"microbatch of {mb} rows not divisible by data={mesh.data}")
        rows = mb // mesh.data if use_data else mb
        off = d * rows if use_data else 0
        per = nb // S
        mine = blocks[s * per:(s + 1) * per]
        if any(bp is None for bp in mine):
            raise ValueError(f"stage {s} does not hold its blocks {s * per}..{(s + 1) * per - 1}")
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(mine) + [tokens, emb, lora, context])
        if grad:
            if use_data:
                mine = tree_map(lambda t: grad_all_reduce(t, mesh.data_group)
                                if t.requires_grad else t, mine)
            tokens, emb, lora, context = _GradSumInputs.apply(
                dist.group.WORLD, tokens, emb, lora, context)

        def rows_of(x, i):
            i = min(max(i, 0), M - 1)  # bubble ticks read a clamped microbatch
            return x.narrow(0, i * mb + off, rows)

        def stage_fn(x, e, lo, c):
            for bp in mine:
                x = apply_block(bp, x, e, lo, c, cos, sin)
            return x

        run = stage_fn
        if remat and grad:
            def run(x, e, lo, c):
                return checkpoint(stage_fn, x, e, lo, c, use_reentrant=False)

        x_in = rows_of(tokens, 0) if s == 0 else tokens.new_zeros((rows, l, dim))
        ys = []
        for t in range(M + S - 1):
            i = t - s  # the microbatch this stage works on
            y = run(x_in, rows_of(emb, i), rows_of(lora, i), rows_of(context, i))
            ys.append(y)
            # The last stage's result stays here; it sends stage 0's next feed.
            send = rows_of(tokens, t + 1) if last else y
            x_in = ShiftFunction.apply(send, mesh.pipe_group, 1)
        spec = (mesh, M, rows, use_data, (b, l, dim))
        return _PipeOutput.apply(spec, *(ys if last else ys[-1:]))

    return executor
