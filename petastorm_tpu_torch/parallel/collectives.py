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
- :func:`reduce_from_group`: sum over the group forward, identity backward,
  for the sequence model's time pool: every rank of the ``seq`` group then
  holds the same pooled features and computes the same loss, so the
  gradient of its partial sum is the gradient of the pool.
- :func:`ring_shift`: rank ``i`` of the group receives rank ``i - 1``'s
  tensor (``jax.lax.ppermute`` with ``i -> i + 1``), by
  ``batch_isend_irecv``; backward shifts the gradient the other way. Ring
  attention rotates its key/value shards with it.
- :func:`all_to_all`: the ``tiled`` ``jax.lax.all_to_all``: split one axis
  in group-size pieces, send piece ``j`` to rank ``j``, concatenate the
  received pieces along another axis in rank order, by
  ``all_to_all_single``; backward is the inverse exchange. Ulysses
  attention redistributes sequence shards into head shards with it.

``torch.distributed``'s point-to-point and all-to-all calls have no
autograd, where JAX differentiates through ``ppermute`` and ``all_to_all``
itself: these functions give them one. A group of one rank (``None``)
makes each of them the identity, with nothing sent. Gloo passes a CUDA
tensor's device pointer to its transport as if it were host memory for
point-to-point and all-to-all, so on a gloo group a CUDA tensor is copied
through the host and back (the four gloo ranks that share one card in
``chip_smoke.py``); NCCL takes the tensors where they are, and never goes
through the host.
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


def _group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def copy_to_group(x, group):
    """``x`` forward; its gradient summed over ``group`` backward. The
    identity on a group of one."""
    if _group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def gather_from_group(x, group):
    """The ranks' ``x`` concatenated on the last dimension, in rank order;
    backward keeps this rank's slice of the gradient. The identity on a
    group of one."""
    if _group_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group)


def all_reduce_sum(x, group):
    """``x`` summed over ``group``, forward and backward. The identity on a
    group of one."""
    if _group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def _through_host(tensors, group):
    """Whether a collective on ``group`` must stage ``tensors`` in host
    memory: CUDA tensors on a gloo group (see the module docstring)."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == dist.Backend.GLOO)


def _shift(x, group, step):
    """Rank ``i`` of ``group`` receives rank ``i - step``'s ``x``."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    staged = _through_host([x], group)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (rank + step) % size), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank - step) % size), group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return recv.to(x.device) if staged else recv


def _exchange(x, group, split_axis, concat_axis):
    """The tiled all-to-all of ``x`` over ``group`` (``all_to_all``)."""
    size = dist.get_world_size(group)
    if x.shape[split_axis] % size:
        raise ValueError('all_to_all splits axis {} of shape {} in {} pieces: it does not '
                         'divide'.format(split_axis, tuple(x.shape), size))
    staged = _through_host([x], group)
    send = torch.stack(x.chunk(size, dim=split_axis))
    send = send.cpu() if staged else send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device) if staged else recv
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return _exchange(grad, ctx.group, concat_axis, split_axis), None, None, None


def reduce_from_group(x, group):
    """``x`` summed over ``group`` forward; the gradient passed through."""
    if _group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def ring_shift(x, group):
    """Rank ``i``'s result is rank ``i - 1``'s ``x`` (mod the group size);
    differentiable. The identity on a group of one."""
    if _group_size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def all_to_all(x, group, split_axis, concat_axis):
    """The tiled all-to-all over ``group``: ``x`` split along
    ``split_axis`` in group-size pieces, piece ``j`` sent to rank ``j``, the
    received pieces concatenated along ``concat_axis`` in rank order;
    differentiable. The identity on a group of one."""
    if _group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)
