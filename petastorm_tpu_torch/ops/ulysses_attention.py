"""Ulysses all-to-all sequence parallelism: the second context-parallel
attention (twin of ``petastorm_tpu/ops/ulysses_attention.py``).

Where ring attention keeps each rank on its own sequence shard and rotates
the key/value shards around the ring, Ulysses redistributes once: an
all-to-all turns the sequence-sharded layout [B, H, T/n, D] into a
head-sharded one [B, H/n, T, D], each rank runs exact attention for its
heads over the full sequence, and a second all-to-all restores the sequence
sharding (DeepSpeed-Ulysses, arXiv:2309.14509). It needs ``num_heads``
divisible by the ``seq`` group's size and holds full-length k/v for its
heads (O(T) memory per rank); ring attention holds O(T/n).

The local attention reuses ring attention's online-softmax block update,
scanning k/v in chunks of ``kv_chunk`` so the [T, T] score matrix never
materialises. Plain torch ops, as the JAX package's are plain ``jnp``; the
exchanges are :func:`~petastorm_tpu_torch.parallel.collectives.all_to_all`
(``all_to_all_single``, differentiable).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from petastorm_tpu_torch.ops.ring_attention import (_accumulators, _block_update, _finish,
                                                    _global_apply, _seq_group)
from petastorm_tpu_torch.parallel.collectives import all_to_all


def _chunked_full_attention(q, k, v, causal, kv_chunk):
    """Exact attention of q [B,H,T,D] over full-length k/v [B,H,T,D],
    scanning k/v in chunks of ``kv_chunk`` with the shared online-softmax
    update."""
    t = q.shape[2]
    scale = 1.0 / (q.shape[3] ** 0.5)
    q32 = q.float()
    m, l, acc = _accumulators(q32)
    q_pos = torch.arange(t, device=q.device)
    for c in range(t // kv_chunk):
        blk = slice(c * kv_chunk, (c + 1) * kv_chunk)
        mask = None
        if causal:
            k_pos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _block_update(q32, k[:, :, blk], v[:, :, blk], mask, m, l, acc, scale)
    return _finish(acc, l, q.dtype)


def ulysses_attention(q, k, v, group=None, causal=False, kv_chunk=None, axis_name='seq'):
    """Exact attention over a sequence sharded on ``group`` (the ranks of
    the mesh's ``seq`` axis named ``axis_name``, ``None`` for one rank) by
    head redistribution.

    q/k/v: this rank's [B, H, T_local, D] shards, laid out contiguously
    (shard ``i`` holds positions ``[i*T_local, (i+1)*T_local)``). Needs
    ``H`` divisible by the group's size. Returns this rank's output shard
    in q's dtype. ``kv_chunk`` bounds the score block's width in the local
    attention (default ``T_local``) and must divide the full length.
    """
    n = 1 if group is None else dist.get_world_size(group)
    h, t_local = q.shape[1], q.shape[2]
    if h % n:
        # checked here, so every entry point fails with this message rather
        # than with the exchange's own
        raise ValueError('ulysses attention needs num_heads ({}) divisible by the {!r} axis '
                         'size ({}); use ring attention otherwise'.format(h, axis_name, n))
    # split the head axis n ways, concatenate the received pieces along the
    # sequence: [B, H/n, T, D] with the full sequence in rank order
    q_full, k_full, v_full = (all_to_all(x, group, 1, 2) for x in (q, k, v))
    t = t_local * n
    chunk = t_local if kv_chunk is None else int(kv_chunk)
    if chunk < 1 or t % chunk:
        raise ValueError('kv_chunk ({}) must be a positive divisor of the full sequence '
                         'length ({})'.format(kv_chunk, t))
    out = _chunked_full_attention(q_full, k_full, v_full, causal, chunk)
    # the inverse: split the sequence, concatenate the heads back
    return all_to_all(out, group, 2, 1)


def make_sharded_ulysses_attention(mesh, seq_axis='seq', batch_axis=None, causal=False,
                                   kv_chunk=None):
    """``(q, k, v) -> out`` on this rank's [B_local, H, T_local, D] shards,
    the sequence sharded over ``mesh``'s ``seq_axis``: a drop-in for
    :func:`~petastorm_tpu_torch.ops.ring_attention.make_sharded_ring_attention`."""
    group = _seq_group(mesh, seq_axis)

    def sharded(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal, kv_chunk=kv_chunk,
                                 axis_name=seq_axis)

    return sharded


def make_ulysses_attention(mesh, seq_axis='seq', batch_axis=None, causal=False, kv_chunk=None):
    """``(q, k, v) -> out`` computing exact attention with the sequence axis
    sharded over ``mesh[seq_axis]`` by all-to-all head redistribution.
    Inputs and outputs are global [B, H, T, D] tensors that every rank of
    the mesh holds; the head count must be divisible by the ``seq_axis``
    size. A collective: every rank calls it."""
    from petastorm_tpu_torch.parallel.mesh import axis_size

    apply = _global_apply(mesh, seq_axis, batch_axis,
                          make_sharded_ulysses_attention(mesh, seq_axis, batch_axis, causal,
                                                         kv_chunk))

    def checked(q, k, v):
        if q.shape[1] % axis_size(mesh, seq_axis):
            raise ValueError(
                'ulysses attention needs num_heads ({}) divisible by the {} axis '
                'size ({}); use ring attention otherwise'.format(
                    q.shape[1], seq_axis, axis_size(mesh, seq_axis)))
        return apply(q, k, v)

    return checked
