"""Training and evaluation steps: twin of ``petastorm_tpu/models/train.py``.

The JAX step is a pure jitted function of an immutable ``TrainState``; here
the step updates the model and optimizer IN PLACE (no second copy of the
parameters) and returns the same state object. ``torch.optim.SGD(lr,
momentum=0.9, dampening=0, nesterov=False)`` is ``optax.sgd(lr,
momentum=0.9)``: both keep ``t = g + 0.9 t`` and step by ``-lr * t``.
Metrics stay tensors on the device, so a step does not wait for the card.

The JAX step is one compiled XLA program. :func:`make_train_step` gives the
eager step by default (the one the CPU parity tests hold against JAX) and,
with ``graphed=True``, the whole step (flip, normalize, forward, loss,
backward, SGD update) captured in one ``torch.cuda.CUDAGraph`` and replayed
with a single launch. Tensor parallelism, DDP and the mesh wait for a later
slice (single card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.ops.augment import flip_mask
from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel

#: eager steps the graphed step runs on a side stream before it captures:
#: the first creates SGD's momentum buffers and compiles the Triton kernel,
#: the second runs with everything allocated, as every replay will
GRAPH_WARMUP_STEPS = 2

#: kernel modules whose ``launches`` counters a replay advances: a replay
#: launches the captured kernels without passing through their wrappers
_COUNTED_KERNELS = (normalize_kernel,)


class TrainState(object):
    """The model, its optimizer and the step counter."""

    def __init__(self, model, optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0


def create_train_state(model, device=None, learning_rate=0.1):
    """Move ``model`` to ``device`` (``None`` = CUDA; conv weights in
    ``channels_last``) and pair it with SGD(``learning_rate``, momentum 0.9)."""
    model.to(device=resolve_device(device), memory_format=torch.channels_last)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9,
                                             dampening=0, nesterov=False))


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy with integer labels, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


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


def _forward_backward(state, preprocess_fn, images, labels, mask):
    """Preprocess, forward, loss and backward, with the gradients written
    into (or, where they exist, added to) ``.grad``."""
    model = state.model
    model.train()
    if preprocess_fn is not None:
        images = preprocess_fn(images, mask)
    logits = model(images)
    loss = cross_entropy_loss(logits, labels)
    loss.backward()
    accuracy = (logits.detach().argmax(-1) == labels).float().mean()
    return loss.detach(), accuracy


def make_train_step(preprocess_fn=None, preprocess_seed=0, graphed=False):
    """``(state, images, labels) -> (state, metrics)``.

    ``preprocess_fn(images, flip_mask) -> images`` runs INSIDE the step on
    the device (normalize/flip of :mod:`petastorm_tpu_torch.ops`), so the
    host ships compact uint8 batches. ``flip_mask`` is the ``(B,)`` boolean
    mask of :func:`step_flip_mask` for ``(preprocess_seed, state.step)``,
    drawn before the step runs: augmentation varies per step, is
    reproducible, and the same in the eager and the graphed step.

    ``graphed=True`` returns a :class:`GraphedTrainStep` (CUDA only): the
    step captured in one CUDA graph after :data:`GRAPH_WARMUP_STEPS` eager
    steps. It is meant for one ``state`` and one batch shape."""
    if graphed:
        return GraphedTrainStep(preprocess_fn, preprocess_seed)

    def train_step(state, images, labels):
        mask = step_flip_mask(preprocess_seed, state.step, images.shape[0], images.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, accuracy = _forward_backward(state, preprocess_fn, images, labels, mask)
        state.optimizer.step()
        state.step += 1
        return state, {'loss': loss, 'accuracy': accuracy}

    return train_step


class GraphedTrainStep(object):
    """The train step as one CUDA graph replay.

    The first :data:`GRAPH_WARMUP_STEPS` calls run the eager step on a side
    stream. The next call copies its batch and flip mask into static input
    buffers, captures flip, normalize, forward, loss, backward and the SGD
    update in one ``torch.cuda.CUDAGraph``, and replays it; every later call
    copies its batch into the buffers and replays. So every call is one real
    training step, and a batch may arrive in any tensors (``stage_batch``
    allocates new ones per batch).

    - The flip mask is drawn outside the graph (a generator reseed cannot be
      captured) and copied into a static buffer that the captured flip reads.
    - SGD creates its momentum buffers at the first step, so capture comes
      after the warm-up.
    - The gradients are set to ``None`` just before capture: the captured
      backward then writes them instead of adding to them, so they are never
      zeroed or freed again (``zero_grad(set_to_none=True)`` would free
      memory the graph owns).
    - The captured loss and accuracy are overwritten by the next replay; the
      metrics returned are copies taken on the device right after the replay.
    - A replay launches the captured kernels without their Python wrappers,
      so each replay adds to each kernel module's ``launches`` what the
      capture recorded (the capture itself launches nothing).
    """

    def __init__(self, preprocess_fn=None, preprocess_seed=0):
        if not torch.cuda.is_available():
            raise RuntimeError('make_train_step(graphed=True) captures a CUDA graph, and CUDA is '
                               'not available; use the eager step (graphed=False) on the CPU')
        self._preprocess_fn = preprocess_fn
        self._preprocess_seed = preprocess_seed
        self._calls = 0
        self._graph = None
        self._static = None        # images, labels, mask, loss, accuracy
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

    def __call__(self, state, images, labels):
        self._check_inputs(images, labels)
        mask = step_flip_mask(self._preprocess_seed, state.step, images.shape[0], images.device)
        if self._graph is None and self._calls < GRAPH_WARMUP_STEPS:
            metrics = self._eager_on_side_stream(state, images, labels, mask)
        else:
            if self._graph is None:
                self._capture(state, images, labels, mask)
            static_images, static_labels, static_mask, loss, accuracy = self._static
            static_images.copy_(images)
            static_labels.copy_(labels)
            static_mask.copy_(mask)
            self._graph.replay()
            for module, count in zip(_COUNTED_KERNELS, self._captured_launches):
                module.launches += count
            metrics = {'loss': loss.clone(), 'accuracy': accuracy.clone()}
        self._calls += 1
        state.step += 1
        return state, metrics

    def _eager_on_side_stream(self, state, images, labels, mask):
        """One eager step on the side stream the warm-up runs on."""
        if self._side is None:
            self._side = torch.cuda.Stream(images.device)
        current = torch.cuda.current_stream(images.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            state.optimizer.zero_grad(set_to_none=True)
            loss, accuracy = _forward_backward(state, self._preprocess_fn, images, labels, mask)
            state.optimizer.step()
        current.wait_stream(self._side)
        for t in (images, labels, mask):
            t.record_stream(self._side)
        return {'loss': loss, 'accuracy': accuracy}

    def _capture(self, state, images, labels, mask):
        static_images = torch.empty_like(images)
        static_labels = torch.empty_like(labels)
        static_mask = torch.empty_like(mask)
        static_images.copy_(images)
        static_labels.copy_(labels)
        static_mask.copy_(mask)
        state.optimizer.zero_grad(set_to_none=True)
        before = [module.launches for module in _COUNTED_KERNELS]
        graph = torch.cuda.CUDAGraph()
        # thread_local: the infeed's thread keeps staging batches (pinned
        # copies, allocations on its own stream) while this thread captures
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            loss, accuracy = _forward_backward(state, self._preprocess_fn, static_images,
                                               static_labels, static_mask)
            state.optimizer.step()
        self._captured_launches = []
        for module, count in zip(_COUNTED_KERNELS, before):
            self._captured_launches.append(module.launches - count)
            module.launches = count
        self._static = (static_images, static_labels, static_mask, loss, accuracy)
        self._graph = graph


def make_eval_step():
    """``(state, images, labels) -> metrics`` with the running statistics."""

    def eval_step(state, images, labels):
        model = state.model
        model.eval()
        with torch.no_grad():
            logits = model(images)
            return {'loss': cross_entropy_loss(logits, labels),
                    'accuracy': (logits.argmax(-1) == labels).float().mean()}

    return eval_step
