"""The collectives of the sharded train step, as autograd functions.

In the JAX package XLA inserts these from the sharding annotations; here
they are explicit, over a given process group:

- :func:`copy_to_group`: identity forward, sum over the group backward. It
  feeds the tensor-parallel head, whose input every rank of the group holds
  and whose gradient is the sum of the ranks' column blocks' gradients.
- :func:`gather_from_group`: concatenate the ranks' last-dimension slices
  forward; backward keeps this rank's slice of the gradient. Every rank of
  the group computes the same loss from the same gathered tensor, so the
  gradient of its slice is that slice of the gradient. (A summing backward,
  as ``torch.distributed.nn.functional.all_gather``'s, would multiply it by
  the group's size.)
- :func:`all_reduce_sum`: sum over the group forward and backward, for the
  synchronised batch norm's sums: every rank's loss depends on every rank's
  rows through them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sum(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


def copy_to_group(x, group):
    """``x`` forward; its gradient summed over ``group`` backward."""
    return _CopyToGroup.apply(x, group)


def gather_from_group(x, group):
    """The ranks' ``x`` concatenated on the last dimension, in rank order;
    backward keeps this rank's slice of the gradient."""
    return _GatherFromGroup.apply(x, group)


def all_reduce_sum(x, group):
    """``x`` summed over ``group``, forward and backward."""
    return _AllReduceSum.apply(x, group)
