"""Training and evaluation steps: twin of ``petastorm_tpu/models/train.py``.

The JAX step is a pure jitted function of an immutable ``TrainState``; here
the step updates the model and optimizer IN PLACE (no second copy of the
parameters) and returns the same state object. ``torch.optim.SGD(lr,
momentum=0.9, dampening=0, nesterov=False)`` is ``optax.sgd(lr,
momentum=0.9)``: both keep ``t = g + 0.9 t`` and step by ``-lr * t``.
Metrics stay tensors on the device, so a step does not wait for the card.

The JAX step is one compiled XLA program. :func:`make_train_step` gives the
eager step by default (the one the CPU parity tests hold against JAX) and,
with ``graphed=True``, the whole step (the preprocess's crop, flip and
normalize, forward, loss, backward, SGD update) captured in one ``torch.cuda.CUDAGraph`` and replayed
with a single launch.

Sharding (:func:`shard_train_state`) follows the JAX package's rule: the
batch shards over the mesh's ``data`` axis, the classifier head's output
dimension over ``model``, everything else replicates. Where XLA inserts
the collectives from the annotations, here they are explicit: batch norm
takes its statistics over the data group, the head is column-parallel
(:mod:`petastorm_tpu_torch.parallel.collectives`), and
``DistributedDataParallel`` averages the gradients over the data group. So
the sharded step computes what one process stepping the global batch
computes: global batch statistics, global mean loss and metrics, the
preprocess draws (flip mask, crop offsets) of the global batch.

On a ``('data', 'seq')`` mesh the sequence model
(:mod:`petastorm_tpu_torch.models.transformer`) runs on each rank's time
slice. Every parameter before its time pool then gets a partial gradient
on each rank of the ``seq`` group, which XLA's SPMD sums and the step here
sums over the group (one all-reduce after the backward); the head after
the pool is replicated over the group and keeps its gradient. DDP then
averages both over the data group, as for the ResNet.

On a ``('data', 'expert')`` mesh the MoE model
(:mod:`petastorm_tpu_torch.models.moe`) holds this rank's experts, and its
layers sum the partial gradients over the expert group themselves: every
parameter's gradient is whole when the backward ends, and DDP averages
them over the data group, the experts' included (the ranks of one data
group hold the same experts).

A model with an ``objective(output, labels)`` method is stepped and
evaluated on it: it returns the metrics, whose ``'loss'`` the step
differentiates (the MoE model's adds its aux loss,
:func:`~petastorm_tpu_torch.models.moe.moe_loss`); any other model on
:func:`classification_objective`.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models.resnet import BatchNorm
from petastorm_tpu_torch.ops.augment import flip_mask
from petastorm_tpu_torch.ops.kernels import batchnorm as batchnorm_kernel
from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel
from petastorm_tpu_torch.parallel.collectives import copy_to_group, gather_from_group
from petastorm_tpu_torch.parallel.mesh import axis_group, data_sharding

#: eager steps the graphed step runs on a side stream before it captures:
#: the first creates SGD's momentum buffers and compiles the Triton kernels,
#: the second runs with everything allocated, as every replay will
GRAPH_WARMUP_STEPS = 2

#: the same under DistributedDataParallel: PyTorch's CUDA graph notes ask
#: for 11 eager DDP iterations before capture
DDP_GRAPH_WARMUP_STEPS = 11

#: kernel modules whose ``launches`` counters a replay advances: a replay
#: launches the captured kernels without passing through their wrappers
_COUNTED_KERNELS = (normalize_kernel, batchnorm_kernel)


class TrainState(object):
    """The model, its optimizer and the step counter; after
    :func:`shard_train_state`, also the mesh, this rank's
    :class:`~petastorm_tpu_torch.parallel.DataSharding` of the batch, the
    data group and the seq group (each ``None`` when it has one rank)."""

    def __init__(self, model, optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.mesh = None
        self.sharding = None
        self.data_group = None
        self.seq_group = None

    @property
    def module(self):
        """The model without its ``DistributedDataParallel`` wrapper."""
        return self.model.module if isinstance(self.model, DistributedDataParallel) else self.model


def create_train_state(model, device=None, learning_rate=0.1):
    """Move ``model`` to ``device`` (``None`` = CUDA; conv weights in
    ``channels_last``) and pair it with SGD(``learning_rate``, momentum 0.9)."""
    model.to(device=resolve_device(device), memory_format=torch.channels_last)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9,
                                             dampening=0, nesterov=False))


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy with integer labels, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def classification_objective(logits, labels):
    """The metrics of a model without an ``objective`` method: the loss
    (:func:`cross_entropy_loss`) and the accuracy."""
    return {'loss': cross_entropy_loss(logits, labels),
            'accuracy': (logits.detach().argmax(-1) == labels).float().mean()}


def _objective(state):
    return getattr(state.module, 'objective', classification_objective)


def _step_seed(preprocess_seed, step):
    """Per-step preprocess seed from ``(preprocess_seed, step)``: the role of
    ``jax.random.fold_in`` (the bits differ, the reproducibility does not)."""
    return int(np.random.SeedSequence([int(preprocess_seed), int(step)]).generate_state(1)[0])


def step_flip_mask(preprocess_seed, step, batch, device):
    """The flip mask of step ``step``: :func:`~petastorm_tpu_torch.ops.augment.flip_mask`
    drawn from a ``torch.Generator`` on ``device`` seeded from
    ``(preprocess_seed, step)``, the draw ``random_flip`` makes with it."""
    generator = torch.Generator(device=device)
    generator.manual_seed(_step_seed(preprocess_seed, step))
    return flip_mask(batch, generator)


def step_draws(preprocess_fn, preprocess_seed, step, batch, height, width, device):
    """The draws step ``step`` hands ``preprocess_fn``: its ``draw(batch,
    height, width, generator)`` from a ``torch.Generator`` on ``device``
    seeded from ``(preprocess_seed, step)``, as a tuple of ``(batch, ...)``
    tensors; for a preprocess without ``draw``, ``(step_flip_mask(...),)``."""
    draw = getattr(preprocess_fn, 'draw', None)
    if draw is None:
        return (step_flip_mask(preprocess_seed, step, batch, device),)
    generator = torch.Generator(device=device)
    generator.manual_seed(_step_seed(preprocess_seed, step))
    return tuple(draw(batch, height, width, generator))


def _draws(state, preprocess_fn, preprocess_seed, images):
    """This rank's rows of the global batch's draws (:func:`step_draws`):
    they are drawn for ``batch x data size`` rows on every rank, and each
    takes its data coordinate's, so the sharded step flips and crops what
    one process stepping the global batch does. ``()`` for a step with no
    preprocess (the JAX step's plain form draws nothing)."""
    if preprocess_fn is None:
        return ()
    batch, sharding = images.shape[0], state.sharding
    # a flip-only preprocess needs the batch alone (its inputs may be 2-D)
    height, width = images.shape[1:3] if hasattr(preprocess_fn, 'draw') else (None, None)
    if sharding is None or sharding.size == 1:
        return step_draws(preprocess_fn, preprocess_seed, state.step, batch, height, width,
                          images.device)
    start = sharding.index * batch
    return tuple(d[start:start + batch] for d in step_draws(
        preprocess_fn, preprocess_seed, state.step, batch * sharding.size, height, width,
        images.device))


def _global_means(state, metrics):
    """The metrics of the global batch: the data group's mean of the local
    means (equal local batches), detached."""
    if state.data_group is None:
        return metrics
    names = list(metrics)
    values = torch.stack([metrics[name] for name in names])
    dist.all_reduce(values, group=state.data_group)
    values /= dist.get_world_size(state.data_group)
    return dict(zip(names, values))


def _spec_for_path(name, mesh_axis_names):
    """The default tensor-parallel rule, the JAX package's: the classifier
    head's output dimension (flax ``head/kernel`` ``P(None, 'model')`` and
    ``head/bias`` ``P('model')``, dimension 0 of torch's ``head.weight`` and
    ``head.bias``) shards on ``model``; the MoE layers' expert weights
    (``moe{i}.w1``, ``b1``, ``w2``, ``b2``) shard their expert dimension on
    ``expert``, as ``moe.py``'s ``P('expert')``; everything else replicates.
    Returns one DTensor placement per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    if re.search(r'(^|\.)moe\d+\.(w1|b1|w2|b2)$', name):
        sharded_on = 'expert'
    elif re.search(r'(^|\.)head\.(weight|bias)$', name):
        sharded_on = 'model'
    else:
        sharded_on = None
    return tuple(Shard(0) if axis == sharded_on else Replicate() for axis in mesh_axis_names)


def state_shardings(state, mesh):
    """``{name: placements}`` for every parameter and buffer of the model
    under ``mesh`` (:func:`_spec_for_path`)."""
    return OrderedDict((name, _spec_for_path(name, mesh.mesh_dim_names))
                       for name in state.module.state_dict())


class ColumnParallelHead(nn.Module):
    """A ``nn.Linear`` head with its output rows split over ``group``: this
    rank keeps its block of rows of the weight and bias; the input enters
    through :func:`copy_to_group` and the logits leave through
    :func:`gather_from_group`, so every rank of the group gets the full
    logits."""

    def __init__(self, head, group):
        super().__init__()
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if head.out_features % size:
            raise ValueError('the head has {} outputs, which the model axis of size {} does not '
                             'divide'.format(head.out_features, size))
        width = head.out_features // size
        self.rows = slice(rank * width, (rank + 1) * width)
        self.group = group
        self.weight = nn.Parameter(head.weight.detach()[self.rows].clone())
        self.bias = nn.Parameter(head.bias.detach()[self.rows].clone())

    def forward(self, x):
        return gather_from_group(F.linear(copy_to_group(x, self.group), self.weight, self.bias),
                                 self.group)


def shard_train_state(state, mesh):
    """Shard ``state`` onto ``mesh``, in place, and return it: every
    :class:`~petastorm_tpu_torch.models.resnet.BatchNorm` synchronises over
    the ``data`` group; with a ``model`` axis of more than one rank the
    ``head`` becomes a :class:`ColumnParallelHead`; with a ``seq`` axis of
    more than one rank the step sums the gradients of the model's
    ``sequence_parameters()`` over the seq group (the model must be built on
    the mesh, ``make_sequence_transformer(mesh=mesh)``); with an ``expert``
    axis of more than one rank the model must be an MoE model built on the
    mesh (``MoESequenceTransformer(mesh=mesh)``: each rank holds its
    experts); with a ``data``
    axis of more than one rank the model is wrapped in
    ``DistributedDataParallel`` over the data group (built on a side stream
    on a card, buffers not broadcast: the synchronised statistics are
    equal). SGD is rebuilt over the sharded parameters with its
    hyperparameters and momentum; the step counter stays."""
    if state.mesh is not None:
        raise ValueError('the train state is already sharded')
    sharding = data_sharding(mesh)
    data_group, model_group = axis_group(mesh, 'data'), axis_group(mesh, 'model')
    seq_group, expert_group = axis_group(mesh, 'seq'), axis_group(mesh, 'expert')
    model = state.module
    if seq_group is not None and getattr(model, 'seq_group', None) is not seq_group:
        raise ValueError('the mesh has a seq axis of {} ranks, and the model was not built on it: '
                         'build it with make_sequence_transformer(mesh=mesh)'.format(
                             dist.get_world_size(seq_group)))
    if expert_group is not None and getattr(model, 'expert_group', None) is not expert_group:
        raise ValueError('the mesh has an expert axis of {} ranks, and the model was not built on '
                         'it: build it with MoESequenceTransformer(mesh=mesh)'.format(
                             dist.get_world_size(expert_group)))
    momentum = {name: state.optimizer.state.get(p, {}).get('momentum_buffer')
                for name, p in model.named_parameters()}
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.sync_group = data_group
    head = getattr(model, 'head', None)
    if model_group is not None and isinstance(head, nn.Linear):
        model.head = ColumnParallelHead(head, model_group)
        momentum = {name: (buf[model.head.rows] if buf is not None and name.startswith('head.')
                           else buf) for name, buf in momentum.items()}
    wrapped = model
    if data_group is not None:
        device = sharding.device
        if device.type == 'cuda':
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                wrapped = DistributedDataParallel(model, device_ids=[device],
                                                  process_group=data_group,
                                                  broadcast_buffers=False)
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            wrapped = DistributedDataParallel(model, process_group=data_group,
                                              broadcast_buffers=False)
    hyper = {k: v for k, v in state.optimizer.param_groups[0].items() if k != 'params'}
    optimizer = type(state.optimizer)(wrapped.parameters(), **hyper)
    for name, p in model.named_parameters():
        if momentum.get(name) is not None:
            optimizer.state[p]['momentum_buffer'] = momentum[name].clone()
    state.model, state.optimizer = wrapped, optimizer
    state.mesh, state.sharding, state.data_group = mesh, sharding, data_group
    state.seq_group = seq_group
    return state


def gather_rows(local, group):
    """The ranks' ``local`` tensors concatenated on dimension 0, in group
    rank order, as numpy: a collective of ``group``."""
    local = local.detach().contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).cpu().numpy()


def gather_state(state):
    """The model's full parameters and statistics as ``{name: numpy}`` (the
    ``state_dict`` names). On a sharded state every tensor that
    :func:`state_shardings` shards on an axis of more than one rank is
    gathered over that axis's group: the column-parallel head over the
    model group, the MoE layers' experts over the expert group (expert
    coordinate ``r`` holds experts ``[r E/n, (r+1) E/n)``). A collective,
    called on every rank of those groups."""
    tensors = state.module.state_dict()
    out = OrderedDict((name, t.detach().to('cpu', copy=True).numpy())
                      for name, t in tensors.items())
    if state.mesh is None:
        return out
    for name, placements in state_shardings(state, state.mesh).items():
        for axis, placement in zip(state.mesh.mesh_dim_names, placements):
            group = axis_group(state.mesh, axis) if placement.is_shard() else None
            if group is not None:
                out[name] = gather_rows(tensors[name], group)
    return out


def _sum_sequence_grads(state):
    """Sum the gradients of the model's parameters before its time pool over
    the seq group, in one all-reduce: each rank's covers its time slice."""
    grads = [p.grad for p in state.module.sequence_parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=state.seq_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _forward_backward(state, preprocess_fn, images, labels, draws):
    """Preprocess, forward, loss and backward, with the gradients written
    into (or, where they exist, added to) ``.grad`` and, on a seq group,
    summed over it. Returns this rank's metrics, the model's objective's
    (:func:`classification_objective` for a model without one), detached."""
    model = state.model
    model.train()
    if preprocess_fn is not None:
        images = preprocess_fn(images, *draws)
    metrics = _objective(state)(model(images), labels)
    metrics['loss'].backward()
    if state.seq_group is not None:
        _sum_sequence_grads(state)
    return {name: value.detach() for name, value in metrics.items()}


def make_train_step(preprocess_fn=None, preprocess_seed=0, graphed=False):
    """``(state, images, labels) -> (state, metrics)``.

    ``preprocess_fn(images, *draws) -> images`` runs INSIDE the step on
    the device (normalize/flip/crop of :mod:`petastorm_tpu_torch.ops`), so
    the host ships compact uint8 batches. ``draws`` are the step's random
    draws (:func:`step_draws`), made before the step runs from a generator
    seeded from ``(preprocess_seed, state.step)``: augmentation varies per
    step, is reproducible, and the same in the eager and the graphed step.
    A preprocess with a ``draw(batch, height, width, generator)`` method
    (:class:`~petastorm_tpu_torch.ops.augment.RandomCropFlip`) gets what it
    draws; any other gets the ``(B,)`` boolean flip mask of
    :func:`step_flip_mask` as its one draw. With no ``preprocess_fn`` the
    step is the JAX step's plain form (the sequence model's): forward, loss,
    backward, SGD, and nothing is drawn.

    ``graphed=True`` returns a :class:`GraphedTrainStep` (CUDA only): the
    step captured in one CUDA graph after :data:`GRAPH_WARMUP_STEPS` eager
    steps. It is meant for one ``state`` and one batch shape."""
    if graphed:
        return GraphedTrainStep(preprocess_fn, preprocess_seed)

    def train_step(state, images, labels):
        draws = _draws(state, preprocess_fn, preprocess_seed, images)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = _forward_backward(state, preprocess_fn, images, labels, draws)
        state.optimizer.step()
        state.step += 1
        return state, _global_means(state, metrics)

    return train_step


class GraphedTrainStep(object):
    """The train step as one CUDA graph replay.

    The first :data:`GRAPH_WARMUP_STEPS` calls run the eager step on a side
    stream. The next call copies its batch and draws into static input
    buffers, captures the preprocess (crop, flip, normalize), forward, loss,
    backward and the SGD update in one ``torch.cuda.CUDAGraph``, and replays
    it; every later call copies its batch and draws into the buffers and
    replays. So every call is one real training step, and a batch may
    arrive in any tensors (``stage_batch`` allocates new ones per batch).

    - The draws (flip mask, crop offsets) are made outside the graph (a
      generator reseed cannot be captured) and each is copied into a static
      buffer of its own that the captured apply reads as a device tensor; a
      step with no preprocess has none. The graph is captured for one input
      shape, and with it one output shape of the crop.
    - SGD creates its momentum buffers at the first step, so capture comes
      after the warm-up.
    - The gradients are set to ``None`` just before capture: the captured
      backward then writes them instead of adding to them, so they are never
      zeroed or freed again (``zero_grad(set_to_none=True)`` would free
      memory the graph owns).
    - The captured metrics (loss, accuracy, an MoE model's aux loss) are
      overwritten by the next replay; the metrics returned are copies taken
      on the device right after the replay.
    - A replay launches the captured kernels without their Python wrappers,
      so each replay adds to each kernel module's ``launches`` what the
      capture recorded (the capture itself launches nothing).
    - A call that replays is a ``train_step`` stage (the host's dispatch:
      draws, static copies, replay, metric copies) with the replay's launch
      as a nested ``train_step_replay``; the warm-up and capture calls are
      neither.
    - On a sharded state the graph captures the step's collectives, which
      only NCCL allows: a state sharded over another backend is refused.
      Under ``DistributedDataParallel`` the warm-up is
      :data:`DDP_GRAPH_WARMUP_STEPS` and ``TORCH_NCCL_ASYNC_ERROR_HANDLING``
      must be ``0`` (:func:`~petastorm_tpu_torch.parallel.make_mesh` sets it
      when it creates the group). At a data size of 1 there is no DDP, and
      the graph captures what it captures unsharded.
    """

    def __init__(self, preprocess_fn=None, preprocess_seed=0):
        if not torch.cuda.is_available():
            raise RuntimeError('make_train_step(graphed=True) captures a CUDA graph, and CUDA is '
                               'not available; use the eager step (graphed=False) on the CPU')
        self._preprocess_fn = preprocess_fn
        self._preprocess_seed = preprocess_seed
        self._calls = 0
        self._graph = None
        self._static = None        # images, labels, draws, metrics
        self._captured_launches = None
        self._side = None

    def _check_inputs(self, images, labels):
        if not images.is_cuda:
            raise RuntimeError(
                'the graphed train step runs on CUDA only (got images on {}); use '
                'make_train_step(graphed=False) on the CPU'.format(images.device))
        if self._static is not None:
            static_images, static_labels = self._static[:2]
            if (images.shape != static_images.shape or images.dtype != static_images.dtype
                    or labels.shape != static_labels.shape):
                raise ValueError('the graphed step was captured for images {} {} and labels {}; '
                                 'got {} {} and {}'.format(
                                     tuple(static_images.shape), static_images.dtype,
                                     tuple(static_labels.shape), tuple(images.shape),
                                     images.dtype, tuple(labels.shape)))

    @staticmethod
    def _check_state(state):
        if state.mesh is None:
            return GRAPH_WARMUP_STEPS
        backend = dist.get_backend()
        if backend != 'nccl':
            raise RuntimeError(
                'make_train_step(graphed=True) captures the sharded step\'s collectives in a '
                'CUDA graph, which needs NCCL; the process group runs on {!r}: use the eager '
                'step (graphed=False)'.format(backend))
        if not isinstance(state.model, DistributedDataParallel):
            return GRAPH_WARMUP_STEPS
        if os.environ.get('TORCH_NCCL_ASYNC_ERROR_HANDLING') != '0':
            raise RuntimeError('a graphed step under DistributedDataParallel needs '
                               'TORCH_NCCL_ASYNC_ERROR_HANDLING=0 set before the process group '
                               'is created')
        return DDP_GRAPH_WARMUP_STEPS

    def __call__(self, state, images, labels):
        self._check_inputs(images, labels)
        warmup = self._check_state(state)
        if self._graph is not None:
            # the host's part of a replayed step; the eager and capture
            # calls of set-up stay out of both stages
            with obs.stage('train_step', cat='model'):
                draws = _draws(state, self._preprocess_fn, self._preprocess_seed, images)
                static_images, static_labels, static_draws, _ = self._static
                static_images.copy_(images)
                static_labels.copy_(labels)
                for static, draw in zip(static_draws, draws):
                    static.copy_(draw)
                with obs.stage('train_step_replay', cat='model'):
                    self._graph.replay()
                metrics = self._replayed()
        else:
            draws = _draws(state, self._preprocess_fn, self._preprocess_seed, images)
            if self._calls < warmup:
                metrics = self._eager_on_side_stream(state, images, labels, draws)
            else:
                self._capture(state, images, labels, draws)  # fills the static inputs
                self._graph.replay()
                metrics = self._replayed()
        self._calls += 1
        state.step += 1
        return state, metrics

    def _replayed(self):
        """After a replay: the captured launches counted, and copies of the
        captured metrics, which the next replay overwrites."""
        for module, count in zip(_COUNTED_KERNELS, self._captured_launches):
            module.launches += count
        return {name: value.clone() for name, value in self._static[3].items()}

    def _eager_on_side_stream(self, state, images, labels, draws):
        """One eager step on the side stream the warm-up runs on."""
        if self._side is None:
            self._side = torch.cuda.Stream(images.device)
        current = torch.cuda.current_stream(images.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            state.optimizer.zero_grad(set_to_none=True)
            metrics = _forward_backward(state, self._preprocess_fn, images, labels, draws)
            state.optimizer.step()
            metrics = _global_means(state, metrics)
        current.wait_stream(self._side)
        for t in (images, labels) + draws:
            t.record_stream(self._side)
        return metrics

    def _capture(self, state, images, labels, draws):
        static_images = torch.empty_like(images)
        static_labels = torch.empty_like(labels)
        static_images.copy_(images)
        static_labels.copy_(labels)
        static_draws = tuple(torch.empty_like(draw) for draw in draws)
        for static, draw in zip(static_draws, draws):
            static.copy_(draw)
        state.optimizer.zero_grad(set_to_none=True)
        before = [module.launches for module in _COUNTED_KERNELS]
        graph = torch.cuda.CUDAGraph()
        # thread_local: the infeed's thread keeps staging batches (pinned
        # copies, allocations on its own stream) while this thread captures
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            metrics = _forward_backward(state, self._preprocess_fn, static_images,
                                        static_labels, static_draws)
            state.optimizer.step()
            metrics = _global_means(state, metrics)
        self._captured_launches = []
        for module, count in zip(_COUNTED_KERNELS, before):
            self._captured_launches.append(module.launches - count)
            module.launches = count
        self._static = (static_images, static_labels, static_draws, metrics)
        self._graph = graph


def make_eval_step():
    """``(state, images, labels) -> metrics`` with the running statistics;
    on a sharded state the metrics are the global batch's."""

    def eval_step(state, images, labels):
        model = state.model
        model.eval()
        with torch.no_grad():
            return _global_means(state, _objective(state)(model(images), labels))

    return eval_step
