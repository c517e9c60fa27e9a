"""Collectives of the training mesh (``parallel/mesh.py`` ``TrainMesh``)
with their gradients, written out as ``torch.autograd.Function``s (the
backward rules of ``torch.distributed.nn.functional`` have changed between
releases).

Each takes its group explicitly. A group of None (an axis of one rank)
makes it the identity, gradient included. ``dist.all_reduce`` works in
place, so every reduction runs on a copy.

* ``all_reduce_sum``: forward the sum over the group, backward the sum over
  the group of the incoming gradient -- SyncBatchNorm's rule: every rank's
  loss depends on every rank's statistics.
* ``copy_to_mp`` / ``reduce_from_mp``: the Megatron pair around a head
  sharded over mp. The first is the identity forward and sums the gradient
  over mp; the second sums forward and passes the gradient through.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is summed likewise."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_mp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToMP.apply(x, group)


def reduce_from_mp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed through."""
    return x if group is None else _ReduceFromMP.apply(x, group)


def sum_grads(leaves: Sequence[torch.Tensor], group: Group) -> None:
    """Every leaf's gradient summed over ``group``, in the leaves' order, by
    one all-reduce of a flat buffer; each ``.grad`` becomes its slice of
    the buffer (a leaf without a gradient adds zeros)."""
    if group is None:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in leaves])
    dist.all_reduce(flat, group=group)
    start = 0
    for p in leaves:
        p.grad = flat[start:start + p.numel()].view_as(p)
        start += p.numel()


def check_equal_shards(group: Group, n: int, device) -> None:
    """Raise unless every rank of ``group`` holds ``n`` rows: one all-reduce
    (the largest of n and of -n) and a read on the host."""
    if group is None:
        return
    t = torch.tensor([n, -n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = t.tolist()
    if hi != n or -lo != n:
        raise ValueError(f"the dp ranks hold {-lo} to {hi} rows: every rank "
                         f"must hold the same shard ({n} here)")
