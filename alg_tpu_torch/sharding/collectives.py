"""Differentiable collectives over one process group of a mesh.

GSPMD inserts these from the weight layouts in ``alg_tpu``; the port writes
them out. Each takes ``group`` (None for a one-rank line, where it is the
identity) and records the transposed collective for the backward:

* :func:`copy_to` / :func:`reduce_from`: Megatron's pair around a
  column-parallel linear (identity forward, all-reduce backward) and after a
  row-parallel one (all-reduce forward, identity backward). Without the
  first, the gradients of the replicated norms and modulation linears that
  feed a column-parallel linear would be partial on each rank.
* :func:`all_reduce`: all-reduce both ways, for a statistic every rank
  reads (Wan's q/k RMS over a tp-sharded width).
* :func:`split` / :func:`gather`: this rank's chunk of a replicated tensor
  (backward: all-gather) and the all-gather of the chunks back into a
  replicated tensor (backward: this rank's chunk).
* :func:`gather_summed`: the all-gather of chunks that each rank reads in
  full but only for its own rows (sequence-parallel keys and values):
  backward all-reduces, then keeps this rank's chunk.
* :func:`all_to_all`: trades a split of ``split_dim`` for a split of
  ``cat_dim`` (Ulysses); backward the inverse exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(_size(group), dim=dim)[_rank(group)].contiguous()


def _exchange(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    inp = torch.stack(x.chunk(_size(group), dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=cat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(_all_reduce(g, ctx.group), ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _exchange(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _exchange(g, cat_dim, split_dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduce.apply(x, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Split.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim, group)


def gather_summed(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherSummed.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, split_dim, cat_dim, group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce with no autograd record (gradients, statistics)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def gather_objects(obj, group) -> list:
    """Every rank's ``obj`` in the group's rank order (``[obj]`` alone)."""
    if group is None:
        return [obj]
    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
