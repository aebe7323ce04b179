"""Model kind ``resnet50``: the port's ResNet-50 (v1.5) trained on uint8
NHWC images by SGD with momentum, through the port's graphed step with the
flip and the normalize kernel inside, against the plain float32 reference
in :mod:`benchmark.reference.resnet`. ``benchmark/harness.py`` lists what a
model kind gives.

FLOPs count the model's convolutions and its head: 2 per multiply-add, and
3 times the forward for forward and backward (the backward computes the
input's and the weights' gradients, each as costly as the forward). Batch
norm, ReLU, pooling and the loss are left out, as MFU conventionally does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import faults, weights
from benchmark.reference import resnet as ref

#: the batch fields the checks compare, in the order the store's
#: ``expected`` gives them
FIELDS = ('image', 'label')

#: a kernel each step launches once: the step boundaries in a trace
STEP_MARKER = 'normalize_kernel'

#: the plain reference, ``benchmark/reference/resnet.py``
REFERENCE = 'resnet'

#: the precision the control computes in: the configuration states bf16
CONTROL = 'fp8'


def make_weights(config, seed, device):
    """``{name: float32 tensor}`` for every parameter of ``config``'s model:
    convolutions and the head drawn at LeCun scale (the program's own
    initialisation, flax's default), batch-norm scales at one (a block's
    last at zero), biases at zero."""
    specs = ref.leaves(config)
    drawn = [(n, s, math.sqrt(1.0 / ref.fan_in(s))) for n, s, kind in specs
             if kind in ('conv', 'head_w')]
    out = weights.truncated_normal(drawn, seed, device)
    for name, shape, kind in specs:
        if kind == 'scale':
            out[name] = torch.ones(shape, device=device)
        elif kind in ('scale0', 'bias', 'head_b'):
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in specs}


class Preprocess(object):
    """The step's on-device preprocess, the port's ImageNet example's: the
    step's flip, then the uint8 -> bf16 normalize kernel."""

    def __init__(self, config):
        self.mean, self.std = config['mean'], config['std']

    def __call__(self, images, flip_mask):
        from petastorm_tpu_torch.ops import normalize_images
        from petastorm_tpu_torch.ops.augment import flip_with_mask

        return normalize_images(flip_with_mask(images, flip_mask), np.float32(self.mean),
                                np.float32(self.std), out_dtype=torch.bfloat16)


def train_state(config, device):
    """The port's model on ``device`` with its SGD state."""
    from petastorm_tpu_torch import models
    from petastorm_tpu_torch.models.train import create_train_state

    dtype = getattr(torch, config['compute_dtype'])
    with torch.device(device):
        model = getattr(models, config['model'])(num_classes=config['num_classes'],
                                                 num_filters=config['num_filters'],
                                                 dtype=dtype)
    return create_train_state(model, device=device, learning_rate=config['learning_rate'])


def train_step(config, preprocess_seed, graphed):
    """The port's step, with the flip and the normalize inside."""
    from petastorm_tpu_torch.models.train import make_train_step

    return make_train_step(preprocess_fn=Preprocess(config), preprocess_seed=preprocess_seed,
                           graphed=graphed)


def feed(batch):
    """The step's inputs from a staged batch."""
    return batch['image'], batch['label']


def optimizer_state(state, params):
    """SGD's momentum buffer of each leaf (after one step, the first
    gradient); zeros where the optimizer keeps none."""
    opt = state.optimizer
    out = {}
    for n, p in params.items():
        buf = opt.state.get(p, {}).get('momentum_buffer')
        out[n] = buf if buf is not None else p.detach() * 0
    return out


def gradient(config, before, after):
    """A step's gradient from the momentum before and after it, which is
    what the momentum gained: ``t1 - m t0``; the first step's is its
    momentum (``before`` None)."""
    if before is None:
        return after
    return {n: after[n] - config['momentum'] * before[n] for n in after}


def data_numbers(staged, expected):
    """The staged batches against the reference's rows: ``staged`` and
    ``expected`` are ``[(images uint8 NHWC, labels)]`` of the batches
    checked."""
    pixel = 0
    labels = 0
    for (images, lab), (ref_images, ref_lab) in zip(staged, expected):
        pixel = max(pixel, int(np.abs(images.astype(np.int16) - ref_images.astype(np.int16)).max()))
        labels += int((lab != ref_lab).sum())
    return {'pixel_max_err': pixel, 'label_mismatches': labels}


def _out(size, stride):
    return -(-size // stride)


def macs(config, image_size):
    """Multiply-adds of one forward pass of ``config``'s ResNet (bottleneck
    blocks, stride on the 3x3) on one ``image_size`` square image."""
    filters, c_in = config['num_filters'], config['in_channels']
    side = _out(image_size, 2)
    total = side * side * 7 * 7 * c_in * filters
    side = _out(side, 2)  # the stem's max-pool
    features = filters
    for i, blocks in enumerate(config['stage_sizes']):
        width = filters * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out = _out(side, stride)
            total += side * side * features * width          # conv1, 1x1
            total += out * out * 9 * width * width            # conv2, 3x3, strided
            total += out * out * width * 4 * width            # conv3, 1x1
            if j == 0:
                total += out * out * features * 4 * width     # projection, 1x1, strided
            side, features = out, 4 * width
    return total + features * config['num_classes']


def step_flops(config):
    """FLOPs of one training step of ``config`` at its batch and size."""
    return 2 * 3 * config['batch_size'] * macs(config, config['image_size'])


def _frozen_step():
    return faults.patched(torch.optim.SGD, 'step', lambda self, closure=None: None)


def _half_batch():
    from petastorm_tpu_torch.models import train

    objective = train.classification_objective

    def half(logits, labels):
        keep = logits.shape[0] // 2
        return objective(logits[:keep], labels[:keep])

    return faults.patched(train, 'classification_objective', half)


def _add_to_first(amount, modulus):
    def change(values):
        flat = values.reshape(-1)
        flat[0] = (int(flat[0]) + amount) % modulus

    return change


#: the faults of this kind (:mod:`benchmark.faults` adds the ones every
#: kind can have): SGD's update does nothing; the loss is the mean over the
#: first half of the batch; one pixel, or one label, of every batch is
#: changed on the host just before the infeed stages it
FAULTS = {
    'frozen_step': _frozen_step,
    'half_batch': _half_batch,
    'altered_pixel': lambda: faults.altered('image', _add_to_first(128, 256)),
    'altered_label': lambda: faults.altered('label', _add_to_first(1, 1000)),
}
