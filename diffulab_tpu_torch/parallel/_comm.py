"""Differentiable collectives over a process group, the port's counterparts of
the reference's ``shard_map`` collectives and their transposes.

Every rank runs the same program (SPMD, as under ``shard_map``), so every
rank builds the same autograd graph and runs the same collectives in its
backward, in the same order. A ``group`` of None is a group of one: each op
is then the identity.

Which backward a collective takes depends on what runs after it:

- :func:`copy_to` (identity forward, all-reduce backward): a replicated value
  entering rank-specific work (the input of a column-parallel linear, a
  replicated weight used on each rank's own tokens);
- :func:`reduce_from` (all-reduce forward, identity backward): rank-specific
  partial sums whose total the ranks then use alike (a row-parallel
  linear's output, the pipeline's broadcast of the last stage);
- :func:`all_reduce_varying` (all-reduce forward and backward): a total each
  rank then uses in its own way (the RMS of a head-sharded row);
- :func:`split` / :func:`gather`: take this rank's chunk of a replicated
  tensor (backward: all-gather) / all-gather the chunks into a replicated
  tensor (backward: take this rank's chunk);
- :func:`ring_shift` (``lax.ppermute`` around the ring; backward: the
  opposite shift) and :func:`all_to_all` (chunk i to rank i; its own inverse).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not divisible by the group's {n} ranks")
    return x.chunk(n, dim=dim)[_rank(group)].contiguous()


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


class _AllReduceVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Send ``x`` to the rank ``offset`` places on, receive from ``offset`` places back."""
    n, r = _size(group), _rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + offset) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - offset) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_varying(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllReduceVarying.apply(x, group)


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if _size(group) == 1 else _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if _size(group) == 1 else _Gather.apply(x, group, dim)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's ``x`` goes to rank r + 1 (mod n); returns rank r - 1's."""
    return x if _size(group) == 1 else _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...]: chunk i goes to rank i; returns [n, ...], chunk i from rank i."""
    return x if _size(group) == 1 else _AllToAll.apply(x, group)


def shift_raw(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """:func:`ring_shift` outside autograd (ring attention's backward)."""
    return x if _size(group) == 1 else _shift(x, group, offset)
