"""Ring attention: context-parallel attention over a mesh's ``seq`` group.

Twin of ``petastorm_tpu/ops/ring_attention.py``. Each rank holds ``T / n``
positions of q, k and v; the key/value shards travel once around the ring of
the ``seq`` group (:func:`~petastorm_tpu_torch.parallel.collectives.ring_shift`,
``batch_isend_irecv``), and each rank folds every block into an online
softmax (running max, normaliser and numerator in float32). Memory per rank
is O(T/n) and the result is exact full attention.

The JAX package writes this as plain ``jnp`` einsums that XLA compiles, with
no Pallas kernel; here it is plain torch ops with the same float32
accumulation and the same ``-1e30`` masking (``scaled_dot_product_attention``
would mask and accumulate otherwise). Under ``jax.shard_map`` the JAX op
sees local shards; here every rank runs :func:`ring_attention` on its own
shard, and the mesh's groups play the mapped axes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.collectives import ring_shift

_NEG_INF = -1e30


def _block_update(q, k_blk, v_blk, mask, m, l, acc, scale):
    """One online-softmax accumulation step.

    q: [B,H,Tq,D] float32; k_blk/v_blk: [B,H,Tk,D]; mask: [Tq,Tk] bool
    (True = keep) or None (keep all); m/l: [B,H,Tq] running max /
    normaliser; acc: [B,H,Tq,D] running numerator.
    """
    s = torch.matmul(q, k_blk.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=s.dtype, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new.unsqueeze(-1))
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction.unsqueeze(-1) + torch.matmul(p, v_blk.float())
    return m_new, l_new, acc_new


def _accumulators(q32):
    """The running max, normaliser and numerator for float32 ``q32``."""
    b, h, t, _ = q32.shape
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q32.device)
    return m, torch.zeros_like(m), torch.zeros_like(q32)


def _finish(acc, l, dtype):
    # a fully masked row (never with the contiguous causal layout) has l = 0:
    # the floor keeps it from 0/0
    return (acc / torch.clamp(l, min=1e-30).unsqueeze(-1)).to(dtype)


def ring_attention(q, k, v, group=None, causal=False):
    """Exact attention over a sequence sharded on ``group`` (the ranks of
    the mesh's ``seq`` axis, ``None`` for one rank).

    q: [B, H, Tq_local, D], k/v: [B, H, Tk_local, D], this rank's shards.
    Returns this rank's output shard [B, H, Tq_local, D] in q's dtype.

    ``causal`` masks with GLOBAL positions (query index >= key index). Shard
    ``i`` holds positions ``[i*T_local, (i+1)*T_local)``, which is how a
    sequence sharding stages time-major batches. At ring step ``t`` rank
    ``i`` holds the k/v shard of rank ``(i - t) mod n``. The shards move
    ``n - 1`` times (the JAX op's last rotation brings them home unused);
    with one rank nothing is sent.
    """
    n = 1 if group is None else dist.get_world_size(group)
    my_idx = 0 if group is None else dist.get_rank(group)
    tq, d = q.shape[2], q.shape[3]
    tk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    q32 = q.float()
    m, l, acc = _accumulators(q32)
    q_pos = my_idx * tq + torch.arange(tq, device=q.device)
    # k and v travel together: one send and one receive per step
    kv = torch.stack([k, v])
    for t in range(n):
        blk_idx = (my_idx - t) % n
        mask = None
        if causal:
            k_pos = blk_idx * tk + torch.arange(tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _block_update(q32, kv[0], kv[1], mask, m, l, acc, scale)
        if t < n - 1:
            kv = ring_shift(kv, group)
    return _finish(acc, l, q.dtype)


def shard_global(x, mesh, seq_axis='seq', batch_axis=None):
    """This rank's shard of a global [B, H, T, D] tensor: its
    ``batch_axis`` coordinate's rows (all rows without one) and its
    ``seq_axis`` coordinate's slice of T."""
    from petastorm_tpu_torch.parallel.mesh import axis_size

    if batch_axis is not None:
        rows = x.shape[0] // axis_size(mesh, batch_axis)
        start = mesh.get_local_rank(batch_axis) * rows
        x = x[start:start + rows]
    steps = x.shape[2] // axis_size(mesh, seq_axis)
    start = mesh.get_local_rank(seq_axis) * steps
    return x[:, :, start:start + steps]


def gather_global(x, mesh, seq_axis='seq', batch_axis=None):
    """The global [B, H, T, D] tensor from every rank's shard (the inverse
    of :func:`shard_global`); a collective over the mesh's groups."""
    from petastorm_tpu_torch.parallel.mesh import axis_group

    for axis, dim in ((seq_axis, 2), (batch_axis, 0)):
        group = None if axis is None else axis_group(mesh, axis)
        if group is not None:
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=dim)
    return x


def _seq_group(mesh, seq_axis):
    from petastorm_tpu_torch.parallel.mesh import axis_group, axis_size

    axis_size(mesh, seq_axis)  # raises for a mesh without the axis
    return axis_group(mesh, seq_axis)


def make_sharded_ring_attention(mesh, seq_axis='seq', batch_axis=None, causal=False):
    """``(q, k, v) -> out`` on this rank's [B_local, H, T_local, D] shards,
    the sequence sharded over ``mesh``'s ``seq_axis``: the attention a
    transformer built on the mesh calls (the JAX function's shard_map'd op;
    ``batch_axis`` only names how the batch was split)."""
    group = _seq_group(mesh, seq_axis)

    def sharded(q, k, v):
        return ring_attention(q, k, v, group, causal=causal)

    return sharded


def _global_apply(mesh, seq_axis, batch_axis, sharded):
    """``(q, k, v) -> out`` on global [B, H, T, D] tensors that every rank
    holds: this rank's shard of each through ``sharded``, then the shards
    gathered back into the global output on every rank."""
    def apply(q, k, v):
        out = sharded(*(shard_global(x, mesh, seq_axis, batch_axis) for x in (q, k, v)))
        return gather_global(out, mesh, seq_axis, batch_axis)

    return apply


def make_ring_attention(mesh, seq_axis='seq', batch_axis=None, causal=False):
    """``(q, k, v) -> out`` computing exact attention with the sequence axis
    sharded over ``mesh[seq_axis]`` (and the batch over ``batch_axis``).
    Inputs and outputs are global [B, H, T, D] tensors that every rank of
    the mesh holds: each rank computes its shard, and the output is
    gathered. A collective: every rank calls it."""
    return _global_apply(mesh, seq_axis, batch_axis,
                         make_sharded_ring_attention(mesh, seq_axis, batch_axis, causal))
