"""The collectives of the model-sharding layouts, as autograd Functions
(``sod_tpu`` leaves them to GSPMD and to ``lax.ppermute``'s transpose).

Each takes the process group of one mesh axis (``mesh.get_group("model")``,
``"pipe"`` or ``"seq"``):

* ``copy_to_group`` and ``reduce_from_group``, Megatron's "f" and "g".  "f"
  is the identity forward and an all-reduce of the gradient backward; it
  stands before a column-parallel linear, whose input every rank of the
  group holds whole.  "g" all-reduces the partial sums of a row-parallel
  linear forward and passes the gradient through backward.  So a term
  computed alike on every rank of the group after "g" reaches the weights
  before "f" once, summed over the ranks' shards.
* ``ppermute(x, group, perm)``: ``lax.ppermute`` over ``batch_isend_irecv``.
  ``perm`` lists ``(source, destination)`` pairs of group ranks; a rank that
  no pair sends to gets zeros.  Its backward is the same exchange with every
  pair reversed: the gradient goes the opposite way round the ring or pipe.
* ``gather_along(x, dim, group)``: every rank's equal slices of ``x``
  concatenated along ``dim`` in rank order; the gradient of the whole,
  computed alike on every rank, hands each rank its own slice.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from sod_tpu_torch.parallel.mesh import all_gather_into


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": ``x`` forward, the gradient all-reduced over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g": ``x`` all-reduced over ``group`` forward, the gradient
    passed through."""
    return _ReduceFromGroup.apply(x, group)


def exchange(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The exchange of ``ppermute`` without autograd: ``x`` sent along every
    pair whose source is this rank, the tensor received from the pair whose
    destination it is (zeros if none)."""
    me = dist.get_rank(group)
    ops, out = [], None
    for src, dst in perm:
        if src == me and dst != me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            if src == me:
                out = x.clone()
            else:
                out = torch.empty_like(x, memory_format=torch.contiguous_format)
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                                      group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.zeros_like(x) if out is None else out


def _reversed(perm):
    return [(dst, src) for src, dst in perm]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return exchange(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group, _reversed(ctx.perm)), None, None


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``group``, differentiable (see the module)."""
    return _PPermute.apply(x, group, [tuple(p) for p in perm])


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.me, ctx.size = dim, me, x.shape[dim]
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
        all_gather_into(out, moved, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.size, ctx.size), None, None


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's slice of ``x`` along ``dim``, in rank order (see the module)."""
    return _GatherAlong.apply(x, dim, group)


def all_gather_flat(tensors: List[torch.Tensor], group) -> List[List[torch.Tensor]]:
    """Every rank's ``tensors`` (equal shapes on every rank), in one
    all-gather: ``out[r][i]`` is rank r's i-th tensor."""
    n = dist.get_world_size(group)
    if not tensors:
        return [[] for _ in range(n)]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    whole = flat.new_empty(n * flat.numel())
    all_gather_into(whole, flat, group=group)
    whole = whole.view(n, -1)
    out = []
    for r in range(n):
        o, mine = 0, []
        for t in tensors:
            mine.append(whole[r, o:o + t.numel()].view(t.shape))
            o += t.numel()
        out.append(mine)
    return out

