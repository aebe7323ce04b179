"""Train a small convnet on an MNIST dataset: twin of
``examples/mnist/jax_example.py``.

The reader decodes on host worker threads, a ``TransformSpec`` normalizes
the images on the workers, :class:`TorchDataLoader` collates fixed-size
batches and stages them on the card, and the port's train step
(``graphed=True``: one CUDA graph replay a step) trains ``MnistCNN``.
``--cur-shard``/``--shard-count`` read one share-nothing shard.

    python -m petastorm_tpu_torch.examples.mnist.torch_example \\
        --dataset-url file:///tmp/mnist_dataset
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from petastorm_tpu_torch import TransformSpec, make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import MnistCNN
from petastorm_tpu_torch.models.train import create_train_state, make_eval_step, make_train_step
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import UnischemaField


def _transform_row(row):
    # the reference's MNIST mean and std
    image = (row['image'].astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return {'image': image, 'digit': row['digit']}


TRANSFORM = TransformSpec(
    _transform_row,
    edit_fields=[UnischemaField('image', np.float32, (28, 28), None, False)],
    removed_fields=['idx'])


def new_mnist_state(seed=0, lr=0.05, device=None):
    """A fresh ``MnistCNN`` from ``seed`` (flax's init) with SGD(``lr``,
    momentum 0.9) on ``device``."""
    torch.manual_seed(seed)
    return create_train_state(MnistCNN(), device=device, learning_rate=lr)


def train_and_test(dataset_url, batch_size=32, epochs=1, lr=0.05, seed=0, cur_shard=None,
                   shard_count=None, device=None, graphed=True):
    """Train for ``epochs`` epochs, testing after each. Returns the state,
    every step's loss and the last epoch's test accuracy."""
    device = resolve_device(device)
    state = new_mnist_state(seed, lr, device)
    train_step, eval_step = make_train_step(graphed=graphed), make_eval_step()
    losses, accuracy = [], None
    for epoch in range(epochs):
        epoch_losses = []
        with make_reader(dataset_url + '/train', num_epochs=1, seed=seed,
                         transform_spec=TRANSFORM, cur_shard=cur_shard,
                         shard_count=shard_count) as reader:
            loader = TorchDataLoader(reader, batch_size, shuffling_queue_capacity=256, seed=seed,
                                     to_device=device)
            for step, batch in enumerate(loader):
                state, metrics = train_step(state, batch['image'], batch['digit'])
                epoch_losses.append(metrics['loss'])
                if step % 20 == 0:
                    print('epoch {} step {}: loss={:.4f}'.format(epoch, step,
                                                                 float(metrics['loss'])))
        losses.extend(torch.stack(epoch_losses).tolist() if epoch_losses else [])
        correct = total = 0
        with make_reader(dataset_url + '/test', num_epochs=1,
                         transform_spec=TRANSFORM) as reader:
            loader = TorchDataLoader(reader, batch_size, drop_last=False, to_device=device)
            for batch in loader:
                n = int(batch['digit'].shape[0])
                metrics = eval_step(state, batch['image'], batch['digit'])
                correct += int(round(float(metrics['accuracy']) * n))
                total += n
        accuracy = correct / max(total, 1)
        print('epoch {}: test accuracy {}/{} = {:.3f}'.format(epoch, correct, total, accuracy))
    return state, losses, accuracy


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_dataset')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--lr', type=float, default=0.05)
    parser.add_argument('--cur-shard', type=int, default=None)
    parser.add_argument('--shard-count', type=int, default=None)
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    parser.add_argument('--eager', action='store_true', help='the eager step, not the graphed one')
    args = parser.parse_args()
    train_and_test(args.dataset_url, args.batch_size, args.epochs, args.lr,
                   cur_shard=args.cur_shard, shard_count=args.shard_count, device=args.device,
                   graphed=not args.eager)


if __name__ == '__main__':
    main()
