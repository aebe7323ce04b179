"""Training and evaluation steps: twin of ``petastorm_tpu/models/train.py``.

The JAX step is a pure jitted function of an immutable ``TrainState``; here
the step updates the model and optimizer IN PLACE (no second copy of the
parameters) and returns the same state object. ``torch.optim.SGD(lr,
momentum=0.9, dampening=0, nesterov=False)`` is ``optax.sgd(lr,
momentum=0.9)``: both keep ``t = g + 0.9 t`` and step by ``-lr * t``.
Metrics stay tensors on the device, so a step does not wait for the card.
Tensor parallelism, DDP and the mesh wait for a later slice (single card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device


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


def make_train_step(preprocess_fn=None, preprocess_seed=0):
    """``(state, images, labels) -> (state, metrics)``.

    ``preprocess_fn(images, generator) -> images`` runs INSIDE the step on the
    device (normalize/flip of :mod:`petastorm_tpu_torch.ops`), so the host
    ships compact uint8 batches. ``generator`` is a ``torch.Generator`` on the
    images' device seeded from ``(preprocess_seed, state.step)``: augmentation
    varies per step and is reproducible."""

    def train_step(state, images, labels):
        model = state.model
        model.train()
        if preprocess_fn is not None:
            generator = torch.Generator(device=images.device)
            generator.manual_seed(_step_seed(preprocess_seed, state.step))
            images = preprocess_fn(images, generator)
        logits = model(images)
        loss = cross_entropy_loss(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        accuracy = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {'loss': loss.detach(), 'accuracy': accuracy}

    return train_step


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
