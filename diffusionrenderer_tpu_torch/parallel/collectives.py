"""Collectives of the sharded forward, with the gradients its backward needs.

Where the JAX package lets XLA insert and transpose its collectives, each
one here is a torch.autograd.Function with a stated backward (Megatron's
conjugate pairs and their sequence-parallel counterparts):

* `grad_all_reduce` - identity forward, all-reduce of the gradient: a value
  every rank of the group holds whole, entering work the group splits (a
  column-parallel layer's input, a parameter that the ranks apply to their
  own tokens or rows).  After it the value's gradient is whole on every rank;
* `all_reduce_sum` - all-reduce forward, identity backward: the partial
  products of a row-parallel layer;
* `all_gather_kv` - all-gather forward, reduce-scatter backward: K and V
  gathered over seq, which every rank's queries read;
* `gather_replicated` - all-gather forward, this rank's slice of the
  gradient backward: a result that every rank then uses whole, in the same
  way (the DiT output before the loss).  The gradient arriving there is the
  same on every rank, so a reduce-scatter would count it once per rank;
* `shift` - one hop around a group's ring, as all_to_all_single with one
  non-zero split each way (gloo takes no point-to-point operation on CUDA
  tensors; NCCL takes this form too).  `ShiftFunction` is the same hop with
  the gradient sent back the other way.

Every function is the identity (or a copy) over a group of one rank.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def group_size(group: Any) -> int:
    return dist.get_world_size(group)


def _grad_needed(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's x joined along dim, in group-rank order (contiguous)."""
    n = group_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view(n, *x.shape).movedim(0, dim).flatten(dim, dim + 1).contiguous()


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of each rank's g, this rank's part along dim."""
    n = group_size(group)
    parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
    return out


def _own_slice(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    part = g.shape[dim] // n
    return g.narrow(dim, dist.get_rank(group) * part, part).contiguous()


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


def grad_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; under autograd its gradient is summed over the group."""
    if group_size(group) == 1 or not _grad_needed(x):
        return x
    return _GradAllReduce.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's x; under autograd the gradient passes through
    unchanged.  Outside autograd x (a fresh partial product) is summed in
    place."""
    if group_size(group) == 1:
        return x
    if _grad_needed(x):
        return _AllReduceSum.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the group's x (a new tensor; no gradient)."""
    if group_size(group) == 1:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_kv(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's slices of x joined along dim; the backward reduce-scatters
    the gradient (every rank's queries read every slice)."""
    if group_size(group) == 1:
        return x.contiguous()
    if _grad_needed(x):
        return _AllGatherKV.apply(x, group, dim)
    return _all_gather(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's slices of x joined along dim; the backward keeps this
    rank's slice of the (replicated) gradient."""
    if group_size(group) == 1:
        return x.contiguous()
    if _grad_needed(x):
        return _GatherReplicated.apply(x, group, dim)
    return _all_gather(x, group, dim)


def shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """x sent to the group rank `step` places ahead; returns the x of the
    rank `step` places behind.  One all_to_all_single: every rank of the
    group must call it."""
    n = group_size(group)
    if n == 1 or step % n == 0:
        return x.contiguous()
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    send, recv = [0] * n, [0] * n
    send[(i + step) % n] = x.shape[0]
    recv[(i - step) % n] = x.shape[0]
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


class ShiftFunction(torch.autograd.Function):
    """`shift` with a gradient: the backward shifts the gradient back."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        y = shift(x, group, step)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.step), None, None
