"""Collectives with the gradients a sharded layout needs.

The reference never writes these: GSPMD derives every collective and its
transpose from ``PartitionSpec``s. The port writes them as
``torch.autograd.Function``s over ``torch.distributed`` groups, under one
convention: a tensor REPLICATED over a group carries the FULL gradient on
every rank of it, a tensor SHARDED over a group carries the gradient of its
own shard, and a PARTIAL tensor (each rank holds a summand) carries the full
gradient of the sum. Each collective's backward follows from that:

================================  =====================  ======================
function                          forward                backward
================================  =====================  ======================
`gather_split_bwd` (re-layout)    all-gather along dim   this rank's slice
`split_gather_bwd` (re-layout)    this rank's slice      all-gather along dim
`gather_rs_bwd` (Megatron-SP in)  all-gather along dim   reduce-scatter (sum)
`rs_gather_bwd` (Megatron-SP out) reduce-scatter (sum)   all-gather along dim
`reduce_fwd` (Megatron g)         all-reduce (sum)       identity
`reduce_bwd` (Megatron f)         identity               all-reduce (sum)
`seq_to_heads` (Ulysses in)       all-to-all seq->heads  all-to-all heads->seq
`heads_to_seq` (Ulysses out)      all-to-all heads->seq  all-to-all seq->heads
================================  =====================  ======================

An all-gather whose consumer is replicated over the group (a re-layout)
takes the slice in its backward; one whose consumer makes partial gradients
(a column-parallel matmul, a ZeRO-3 weight) reduce-scatters instead. Mixing
the two up scales the gradient by the group size and leaves the loss as it
was, which is why the tests compare gradients.

Every function runs its collective even on a one-rank group (a copy), so a
world of one drives the same code. Dims are sharded in equal contiguous
chunks, chunk ``i`` on the group's rank ``i``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


# torch renamed the tensor-in/tensor-out collectives (the old names warn
# once deprecated); take whichever this torch has
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim`, in group-rank order."""
    n = _size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    _all_gather_single(out, xt, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum `x` over the group and keep this rank's chunk along `dim`."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError("reduce-scatter of dim %d (size %d) over %d ranks" % (dim, x.shape[dim], n))
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    _reduce_scatter_single(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Out-of-place all-reduce (`x` is left as it was)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of `x` along `dim`."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError("split of dim %d (size %d) over %d ranks" % (dim, x.shape[dim], n))
    return x.chunk(n, dim)[dist.get_group_rank(group, dist.get_rank())].contiguous()


def all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int, group) -> torch.Tensor:
    """Cut `x` into the group's size of chunks along `scatter_dim`, send
    chunk i to group rank i, and concatenate the chunks received along
    `gather_dim`, in group-rank order."""
    n = _size(group)
    if x.shape[scatter_dim] % n:
        raise ValueError("all-to-all of dim %d (size %d) over %d ranks"
                         % (scatter_dim, x.shape[scatter_dim], n))
    inp = torch.stack(x.chunk(n, scatter_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=gather_dim)


class _GatherSplitBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.dim, ctx.group), None, None


class _SplitGatherBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherRsBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _RsGatherBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scatter_dim, gather_dim, group):
        ctx.dims, ctx.group = (scatter_dim, gather_dim), group
        return all_to_all(x, scatter_dim, gather_dim, group)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return all_to_all(g, gather_dim, scatter_dim, ctx.group), None, None, None


def seq_to_heads(x, group):
    """Ulysses before attention: (B, S/n, H, D) sequence shards -> (B, S,
    H/n, D) head shards over the group's n ranks (the reference's head-spec
    constraint, which XLA lowers to this all-to-all)."""
    return _AllToAll.apply(x, 2, 1, group)


def heads_to_seq(x, group):
    """Ulysses after attention: (B, S, H/n, D) -> (B, S/n, H, D)."""
    return _AllToAll.apply(x, 1, 2, group)


def gather_split_bwd(x, dim: int, group):
    return _GatherSplitBwd.apply(x, dim, group)


def split_gather_bwd(x, dim: int, group):
    return _SplitGatherBwd.apply(x, dim, group)


def gather_rs_bwd(x, dim: int, group):
    return _GatherRsBwd.apply(x, dim, group)


def rs_gather_bwd(x, dim: int, group):
    return _RsGatherBwd.apply(x, dim, group)


def reduce_fwd(x, group):
    return _ReduceFwd.apply(x, group)


def reduce_bwd(x, group):
    return _ReduceBwd.apply(x, group)
