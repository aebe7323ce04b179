"""Mixture-of-experts layer with expert parallelism: twin of
``petastorm_tpu/models/moe.py``.

A GShard/Switch dense-dispatch MoE (top-1 routing, GShard arXiv:2006.16668,
Switch Transformer arXiv:2101.03961):

- gate: ``softmax(Linear_E(token))`` in float32; expert = argmax, ``gate_p``
  its probability;
- capacity ``C = ceil(tokens / E * capacity_factor)``; each expert takes its
  tokens in FIFO order and DROPS those past ``C`` (their output is 0: the
  caller's residual carries them);
- the ``[N, E, C]`` dispatch scatters tokens to expert slots, the combine
  (dispatch x ``gate_p``) gathers the experts' outputs back; the per-expert
  FFN (tanh GELU) runs in ``dtype``;
- the load-balancing aux loss ``E * sum_e f_e * P_e`` (Switch eq. 4): add
  ``aux_weight`` of it to the objective (:func:`moe_loss`).

Under JAX's SPMD the layer sees the global batch and XLA inserts the
collectives from the expert weights' ``P('expert')`` sharding. Here a layer
built on a ``('data', 'expert')`` mesh runs on each rank's rows and the
collectives are explicit:

- Routing is the global batch's. ``N`` and ``C`` count every data rank's
  tokens, and each expert's FIFO slots continue where the lower data ranks'
  tokens left off: the data group's per-expert counts
  (:func:`~petastorm_tpu_torch.parallel.collectives.gather_from_group`) give
  the offsets and the fractions ``f_e``. The mean probabilities ``P_e`` are
  summed over the data group with
  :func:`~petastorm_tpu_torch.parallel.collectives.all_reduce_sum`: every
  data rank's loss holds the global aux loss, and DDP's average over the
  data group then leaves its gradient counted once.
- Experts shard over the ``expert`` group: rank ``r`` of ``n`` holds experts
  ``[r E/n, (r+1) E/n)`` of ``w1 [E, D, H]``, ``b1``, ``w2``, ``b2`` (as
  ``P('expert')`` places them), and every rank of the group holds the same
  tokens. Each rank runs its experts on the tokens routed to them; the
  combine sums the ranks' outputs
  (:func:`~petastorm_tpu_torch.parallel.collectives.reduce_from_group`).
  The tokens and ``gate_p`` enter that partial computation through
  :func:`~petastorm_tpu_torch.parallel.collectives.copy_to_group`, so their
  gradients are summed over the group: every parameter outside the experts
  then gets the whole gradient on every rank of the group, and the aux
  loss, which every rank computes whole, is counted once.

The flax parameters map one to one: ``gate`` is a Dense (``nn.Linear``,
kernel transposed); ``w1``, ``b1``, ``w2``, ``b2`` are einsum parameters,
carried as they are.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.transformer import LAYER_NORM_EPS, SelfAttention
from petastorm_tpu_torch.parallel.collectives import (all_reduce_sum, copy_to_group,
                                                      gather_from_group, reduce_from_group)

#: the parameters of :class:`MoEMlp` whose leading dimension is the expert
EXPERT_PARAMS = ('w1', 'b1', 'w2', 'b2')

#: the standard deviation of a unit normal truncated at +-2 (flax's
#: ``variance_scaling`` divides by it)
_TRUNCATED_STD = .87962566103423978


def expert_capacity(num_tokens, num_experts, capacity_factor):
    """C = ceil(tokens/experts * capacity_factor), clamped to [1, tokens]
    (the Switch formula: the ceiling comes after the slack multiply)."""
    capacity = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(1, min(num_tokens, capacity))


def _lecun_normal(shape, fan_in):
    """flax's ``lecun_normal`` draw: a truncated normal of variance
    ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std)


class MoEMlp(nn.Module):
    """Drop-in MLP replacement: ``[B, T, D] -> ([B, T, D], aux_loss)``.

    :param d_model: D, the token width (flax reads it from the input).
    :param num_experts: E; with ``mesh``, divisible by the ``expert`` axis
        size.
    :param d_hidden: the per-expert FFN's hidden width.
    :param capacity_factor: slack over the perfectly balanced load.
    :param mesh: a ``DeviceMesh`` with an ``expert`` axis (and optionally a
        ``data`` axis) for expert parallelism; the input is then this
        rank's rows.
    :param dtype: the FFN's compute type; routing stays float32.

    The expert weights are drawn for all E experts on every rank, from the
    same generator state, and the rank keeps its own: one seed gives one
    model on any mesh. A ``state_dict`` of all E experts (the converter's,
    ``gather_state``'s) loads this rank's slice.
    """

    def __init__(self, d_model, num_experts, d_hidden, capacity_factor=1.25, mesh=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_experts, self.capacity_factor, self.dtype = num_experts, capacity_factor, dtype
        self.expert_group = self.data_group = None
        rank, size = 0, 1
        if mesh is not None:
            from petastorm_tpu_torch.parallel.mesh import axis_group, axis_size

            size = axis_size(mesh, 'expert')
            if num_experts % size:
                raise ValueError('num_experts ({}) must be divisible by the \'expert\' axis size '
                                 '({})'.format(num_experts, size))
            rank = mesh.get_local_rank('expert')
            self.expert_group = axis_group(mesh, 'expert')
            self.data_group = axis_group(mesh, 'data')
        local = num_experts // size
        #: this rank's experts
        self.experts = slice(rank * local, (rank + 1) * local)
        self.gate = nn.Linear(d_model, num_experts, dtype=torch.float32)
        # flax's lecun_normal counts the leading expert dimension in fan_in
        w1 = _lecun_normal((num_experts, d_model, d_hidden), num_experts * d_model)
        w2 = _lecun_normal((num_experts, d_hidden, d_model), num_experts * d_hidden)
        self.w1 = nn.Parameter(w1[self.experts].clone())
        self.b1 = nn.Parameter(torch.zeros(local, d_hidden))
        self.w2 = nn.Parameter(w2[self.experts].clone())
        self.b2 = nn.Parameter(torch.zeros(local, d_model))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # all E experts (a full state) load this rank's slice
        for name in EXPERT_PARAMS:
            value = state_dict.get(prefix + name)
            if (value is not None and value.shape[0] == self.num_experts
                    and getattr(self, name).shape[0] != self.num_experts):
                state_dict[prefix + name] = value[self.experts]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _route(self, tokens):
        """Top-1 routing of this rank's float32 ``tokens [n, D]`` within the
        global batch: ``(probs [n, E], onehot [n, E], position [n, E],
        capacity, counts [E])``. ``position`` is each token's global FIFO
        slot in its expert; ``counts`` the global batch's tokens per expert."""
        e, n_local = self.num_experts, tokens.shape[0]
        data = 1 if self.data_group is None else dist.get_world_size(self.data_group)
        capacity = expert_capacity(n_local * data, e, self.capacity_factor)
        probs = torch.softmax(self.gate(tokens), dim=-1)
        experts = torch.arange(e, device=tokens.device)
        # by comparison, not F.one_hot: no host read (graph capture)
        onehot = (probs.argmax(dim=-1)[:, None] == experts).float()
        local_counts = gather_from_group(onehot.sum(dim=0), self.data_group).reshape(data, e)
        rank = 0 if self.data_group is None else dist.get_rank(self.data_group)
        # the lower data ranks' tokens fill each expert's first slots
        position = (torch.cumsum(onehot, dim=0) - 1 + local_counts[:rank].sum(dim=0)) * onehot
        return probs, onehot, position, capacity, local_counts.sum(dim=0)

    def forward(self, x):  # x: [B_local, T, D]
        b, t, d = x.shape
        n = b * t
        tokens = x.reshape(n, d).float()
        probs, onehot, position, capacity, counts = self._route(tokens)
        global_n = counts.sum()
        # Switch load-balancing aux loss: E * sum_e f_e * P_e, global means
        frac_tokens = counts / global_n
        mean_probs = all_reduce_sum(probs.sum(dim=0), self.data_group) / global_n
        aux_loss = self.num_experts * torch.sum(frac_tokens * mean_probs)

        gate_p = (probs * onehot).sum(dim=-1)
        keep = onehot * (position < capacity)
        # this rank's experts only; a position >= C matches no slot (zero row)
        slots = torch.arange(capacity, device=x.device, dtype=position.dtype)
        dispatch = keep[:, self.experts, None] * (position[:, self.experts, None] == slots)
        tokens = copy_to_group(tokens, self.expert_group)
        gate_p = copy_to_group(gate_p, self.expert_group)
        combine = dispatch * gate_p[:, None, None]

        # routing and dispatch in float32, the expert FFN in self.dtype
        dtype = self.dtype
        xin = torch.einsum('nec,nd->ecd', dispatch, tokens).to(dtype)
        h = torch.einsum('ecd,edh->ech', xin, self.w1.to(dtype)) + self.b1[:, None, :].to(dtype)
        h = F.gelu(h, approximate='tanh')
        out = torch.einsum('ech,ehd->ecd', h, self.w2.to(dtype)) + self.b2[:, None, :].to(dtype)
        y = reduce_from_group(torch.einsum('nec,ecd->nd', combine, out.float()),
                              self.expert_group)
        return y.reshape(b, t, d).to(x.dtype), aux_loss


class MoESequenceTransformer(nn.Module):
    """The sequence transformer with MoE MLPs: ``[B, T, F]`` NGram window
    stacks -> ``([B, num_classes], aux_total)``, the summed load-balancing
    aux loss (add ``aux_weight`` of it to the objective, :func:`moe_loss`).

    ``seq_len`` and ``feature_dim`` are T and F (flax reads both from the
    init input). The modules carry flax's names: ``embed``, ``pos_embed``,
    per layer ``attn{i}`` (the shared
    :class:`~petastorm_tpu_torch.models.transformer.SelfAttention`),
    ``norm{i}`` (flax's ``LayerNorm_{i}``) and ``moe{i}``, then ``norm``
    (flax's ``LayerNorm_{num_layers}``) and the float32 ``head`` on the
    time mean. With ``mesh`` every MoE layer shards its experts over the
    ``expert`` axis and routes the global batch of the ``data`` axis.
    """

    def __init__(self, num_classes, num_experts, seq_len, feature_dim, d_model=64, num_heads=4,
                 num_layers=2, capacity_factor=1.25, mesh=None, attention_fn=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.seq_len, self.num_layers = dtype, seq_len, num_layers
        self.expert_group = None
        if mesh is not None:
            from petastorm_tpu_torch.parallel.mesh import axis_group
            self.expert_group = axis_group(mesh, 'expert')
        self.embed = nn.Linear(feature_dim, d_model, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, d_model))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(num_layers):
            self.add_module('attn{}'.format(i),
                            SelfAttention(d_model, num_heads, attention_fn, dtype))
            self.add_module('norm{}'.format(i),
                            nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, dtype=dtype))
            self.add_module('moe{}'.format(i),
                            MoEMlp(d_model, num_experts, 4 * d_model, capacity_factor, mesh,
                                   dtype))
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, dtype=dtype)
        self.head = nn.Linear(d_model, num_classes, dtype=torch.float32)

    def moe_layers(self):
        """The :class:`MoEMlp` of each layer, in order."""
        return [getattr(self, 'moe{}'.format(i)) for i in range(self.num_layers)]

    def forward(self, x):  # x: [B_local, T, F]
        x = self.embed(x.to(self.dtype))
        if x.shape[1] != self.seq_len:
            raise ValueError('the model was built for windows of {} steps; got {}'.format(
                self.seq_len, x.shape[1]))
        x = x + self.pos_embed.to(self.dtype)
        aux_total = 0.0
        for i, moe in enumerate(self.moe_layers()):
            x = getattr(self, 'attn{}'.format(i))(x)
            moe_out, aux = moe(getattr(self, 'norm{}'.format(i))(x))
            x = x + moe_out  # dropped tokens ride the residual
            aux_total = aux_total + aux
        x = self.norm(x)
        return self.head(x.mean(dim=1).float()), aux_total

    def objective(self, output, labels):
        """The train and eval steps' metrics for ``output = self(x)``: the
        loss :func:`moe_loss`, the accuracy and the aux loss."""
        logits, aux = output
        return {'loss': moe_loss(logits, aux, labels),
                'accuracy': (logits.detach().argmax(-1) == labels).float().mean(),
                'aux': aux}

    @torch.no_grad()
    def routing_stats(self, x):
        """Per MoE layer, for the global batch whose rows ``x`` are this
        rank's: each expert's load (tokens routed to it), the capacity and
        the fraction of tokens dropped past it. Reads the host: call it
        outside a captured step."""
        inputs = []
        hooks = [moe.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
                 for moe in self.moe_layers()]
        try:
            self(x)
        finally:
            for hook in hooks:
                hook.remove()
        stats = []
        for moe, h in zip(self.moe_layers(), inputs):
            _, _, _, capacity, counts = moe._route(h.reshape(-1, h.shape[-1]).float())
            kept = counts.clamp(max=capacity).sum()
            stats.append({'expert_load': [int(c) for c in counts.tolist()],
                          'capacity': capacity,
                          'dropped_fraction': float(1 - kept / counts.sum())})
        return stats


def moe_loss(logits, aux, labels, aux_weight=0.01):
    """The MoE objective: mean softmax cross entropy (float32, integer
    labels) plus ``aux_weight`` x the aux loss."""
    return F.cross_entropy(logits.float(), labels.long()) + aux_weight * aux
