"""Sequence transformer over NGram windows: twin of
``petastorm_tpu/models/transformer.py``.

A compact pre-norm transformer whose attention is pluggable: plain softmax
attention on one rank, or either context-parallel strategy when the
sequence axis is sharded over a mesh's ``seq`` group: exact blockwise ring
attention (:mod:`petastorm_tpu_torch.ops.ring_attention`) or Ulysses
all-to-all (:mod:`petastorm_tpu_torch.ops.ulysses_attention`). Pick with
``make_sequence_transformer(context_parallelism='ring'|'ulysses')``.

End to end: ``make_reader(output='columnar', ngram=...)`` ->
``TorchDataLoader`` -> ``stack_ngram_time_axis`` -> [B, T, F] batches
staged onto ``data_sharding(mesh, seq_axis='seq')`` (each rank's
[B/data, T/seq, F] slice) -> this model in the train step of
:mod:`petastorm_tpu_torch.models.train`.

Under JAX's SPMD the model sees global arrays and XLA inserts the
collectives; here a model built on a mesh runs on each rank's slice, and
the collectives are explicit: the attention's, the positional embedding
sliced at the rank's ``seq`` coordinate, and the time pool summed over the
``seq`` group (:func:`~petastorm_tpu_torch.parallel.collectives.reduce_from_group`).
Every parameter before the pool then has a partial gradient on each rank
(:meth:`SequenceTransformer.sequence_parameters`), which the train step sums
over the ``seq`` group; the head after the pool is replicated.

The flax layers map one to one: ``Dense`` is ``nn.Linear`` (its kernel
``[in, out]`` is the transpose of the weight), ``LayerNorm`` has epsilon
1e-6, and ``nn.gelu`` is the tanh approximation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel.collectives import reduce_from_group

#: flax ``nn.LayerNorm``'s default epsilon
LAYER_NORM_EPS = 1e-6


def plain_attention(q, k, v):
    """Full softmax attention for unsharded runs, on [B, H, T, D]; q is
    scaled before the product, as the JAX function does."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(logits, dim=-1), v)


class SelfAttention(nn.Module):
    """The attention sub-block (pre-norm qkv -> heads -> ``attention_fn``
    -> output projection), shared with the expert-parallel block so the
    attention path cannot drift between them. Returns ``x + attn_out``."""

    def __init__(self, d_model, num_heads, attention_fn=None, dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError('d_model ({}) must be divisible by num_heads ({})'.format(
                d_model, num_heads))
        self.d_model, self.num_heads = d_model, num_heads
        self.attention_fn = attention_fn or plain_attention
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, dtype=dtype)
        self.qkv = nn.Linear(d_model, 3 * d_model, dtype=dtype)
        self.attn_out = nn.Linear(d_model, d_model, dtype=dtype)

    def forward(self, x):  # x: [B, T, d_model]
        b, t, _ = x.shape
        head_dim = self.d_model // self.num_heads
        q, k, v = self.qkv(self.norm(x)).split(self.d_model, dim=-1)

        def heads(y):  # [B, T, d_model] -> [B, H, T, head_dim]
            return y.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        out = self.attention_fn(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(b, t, self.d_model)
        return x + self.attn_out(out)


class TransformerBlock(nn.Module):
    """Pre-norm block: attention and MLP with residuals. ``attention_fn`` is
    any ``(q, k, v) -> out`` on [B, H, T, D]: plain, ring or Ulysses."""

    def __init__(self, d_model, num_heads, mlp_ratio=4, attention_fn=None, dtype=torch.float32):
        super().__init__()
        self.attn = SelfAttention(d_model, num_heads, attention_fn, dtype)
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, dtype=dtype)
        self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model, dtype=dtype)
        self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model, dtype=dtype)

    def forward(self, x):
        x = self.attn(x)
        h = F.gelu(self.mlp_up(self.norm(x)), approximate='tanh')
        return x + self.mlp_down(h)


class SequenceTransformer(nn.Module):
    """[B, T, F] continuous features (NGram window stacks) -> [B, num_classes].

    ``seq_len`` is the window length T: the learned positional embedding
    ``pos_embed`` is ``(1, T, d_model)`` (flax sizes it from the first
    input). The head is float32 and reads the mean over time.

    With a ``seq_group`` (the mesh's ``seq`` ranks, set by
    :func:`make_sequence_transformer`) the input is this rank's time slice
    ``[B, T/n, F]``: the rank adds its slice of ``pos_embed`` and the time
    mean is the group's sum over T.
    """

    def __init__(self, num_classes, seq_len, feature_dim, d_model=64, num_heads=4, num_layers=2,
                 mlp_ratio=4, attention_fn=None, dtype=torch.float32, seq_group=None):
        super().__init__()
        self.dtype, self.seq_len, self.seq_group = dtype, seq_len, seq_group
        self.embed = nn.Linear(feature_dim, d_model, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, d_model))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList([
            TransformerBlock(d_model, num_heads, mlp_ratio, attention_fn=attention_fn, dtype=dtype)
            for _ in range(num_layers)])
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, dtype=dtype)
        self.head = nn.Linear(d_model, num_classes, dtype=torch.float32)

    def sequence_parameters(self):
        """The parameters before the time pool: on a rank of a ``seq`` group
        their gradient covers this rank's time slice only, and the group's
        sum is the full gradient. The head's is whole on every rank."""
        return [p for name, p in self.named_parameters() if not name.startswith('head.')]

    def forward(self, x):  # x: [B, T_local, F]
        x = self.embed(x.to(self.dtype))
        t_local = x.shape[1]
        n = 1 if self.seq_group is None else dist.get_world_size(self.seq_group)
        if t_local * n != self.seq_len:
            raise ValueError('the model was built for windows of {} steps; got {} steps on each '
                             'of {} seq ranks'.format(self.seq_len, t_local, n))
        pos = self.pos_embed
        if n > 1:
            start = dist.get_rank(self.seq_group) * t_local
            pos = pos[:, start:start + t_local]
        x = x + pos.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        if n > 1:
            pooled = reduce_from_group(x.sum(dim=1), self.seq_group) / self.seq_len
        else:
            pooled = x.mean(dim=1)
        return self.head(pooled.float())


def make_sequence_transformer(num_classes, seq_len, feature_dim, mesh=None, seq_axis='seq',
                              batch_axis='data', d_model=64, num_heads=4, num_layers=2,
                              dtype=torch.float32, context_parallelism='ring'):
    """Build the model; with ``mesh`` the attention runs context-parallel over
    ``mesh[seq_axis]``, else plain full attention. It drops into
    :func:`~petastorm_tpu_torch.models.train.create_train_state` and the
    train steps unchanged (``shard_train_state`` adds DDP over the
    ``batch_axis`` group).

    ``seq_len`` and ``feature_dim`` are the global window length T and the
    feature width F (flax reads both from the init input).

    ``context_parallelism`` picks the sharded strategy:
      * ``'ring'``: blockwise ring attention (O(T/n) memory per rank, k/v
        shards rotate around the ``seq`` group);
      * ``'ulysses'``: all-to-all head redistribution (two exchanges, full-T
        k/v per rank for H/n heads; needs ``num_heads`` divisible by the
        ``seq_axis`` size).
    Both compute exact attention; they are interchangeable and tested equal.

    On a mesh every batch fed to the model is a rank's slice: B divided by
    the ``batch_axis`` size, T by the ``seq_axis`` size."""
    attention_fn = None
    seq_group = None
    if mesh is not None:
        from petastorm_tpu_torch.parallel.mesh import axis_group, axis_size

        seq_size = axis_size(mesh, seq_axis)
        if seq_len % seq_size:
            raise ValueError('seq_len ({}) must be divisible by the {} axis size ({})'.format(
                seq_len, seq_axis, seq_size))
        if context_parallelism == 'ring':
            from petastorm_tpu_torch.ops.ring_attention import make_sharded_ring_attention
            attention_fn = make_sharded_ring_attention(mesh, seq_axis=seq_axis,
                                                       batch_axis=batch_axis)
        elif context_parallelism == 'ulysses':
            if num_heads % seq_size:
                raise ValueError(
                    "context_parallelism='ulysses' needs num_heads ({}) divisible by "
                    'the {} axis size ({}); use ring'.format(num_heads, seq_axis, seq_size))
            from petastorm_tpu_torch.ops.ulysses_attention import make_sharded_ulysses_attention
            attention_fn = make_sharded_ulysses_attention(mesh, seq_axis=seq_axis,
                                                          batch_axis=batch_axis)
        else:
            raise ValueError("context_parallelism must be 'ring' or 'ulysses', "
                             'got {!r}'.format(context_parallelism))
        seq_group = axis_group(mesh, seq_axis)
    return SequenceTransformer(num_classes=num_classes, seq_len=seq_len, feature_dim=feature_dim,
                               d_model=d_model, num_heads=num_heads, num_layers=num_layers,
                               attention_fn=attention_fn, dtype=dtype, seq_group=seq_group)
