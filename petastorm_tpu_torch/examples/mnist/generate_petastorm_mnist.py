"""Materialize MNIST (or a synthetic stand-in) as a dataset: twin of
``examples/mnist/generate_petastorm_mnist.py``.

Without ``--mnist-data`` it writes deterministic synthetic digits (a bright
blob per class on noise) from the same numpy seeds as the JAX generator, so
both write the same rows; with it, the raw MNIST IDX files of that
directory. Train and test go to ``<output-url>/train`` and ``/test``.

    python -m petastorm_tpu_torch.examples.mnist.generate_petastorm_mnist \\
        --output-url file:///tmp/mnist_dataset --train-rows 60000 --test-rows 10000
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct

import numpy as np

from petastorm_tpu_torch.etl import write_petastorm_dataset
from petastorm_tpu_torch.examples.mnist.schema import MnistSchema


def _synthetic_mnist(n, seed=0):
    """Deterministic digit-like images: a bright blob per class on noise."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        digit = int(rng.integers(0, 10))
        img = rng.integers(0, 32, (28, 28), dtype=np.uint8)
        r, c = 4 + 2 * (digit // 5), 4 + 2 * (digit % 5)
        img[r:r + 8, c:c + 8] = 200 + digit * 5
        yield digit, img


def _idx_opener(path):
    return gzip.open if path.endswith('.gz') else open


def _read_idx_images(path):
    with _idx_opener(path)(path, 'rb') as f:
        magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
        if magic != 2051:
            raise ValueError('not an IDX image file: {}'.format(path))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    with _idx_opener(path)(path, 'rb') as f:
        magic, _ = struct.unpack('>II', f.read(8))
        if magic != 2049:
            raise ValueError('not an IDX label file: {}'.format(path))
        return np.frombuffer(f.read(), dtype=np.uint8)


def _real_mnist(data_dir, group):
    prefix = 'train' if group == 'train' else 't10k'
    for ext in ('', '.gz'):
        ip = os.path.join(data_dir, '{}-images-idx3-ubyte{}'.format(prefix, ext))
        lp = os.path.join(data_dir, '{}-labels-idx1-ubyte{}'.format(prefix, ext))
        if os.path.exists(ip) and os.path.exists(lp):
            images, labels = _read_idx_images(ip), _read_idx_labels(lp)
            return ((int(digit), img) for digit, img in zip(labels, images))
    raise FileNotFoundError('MNIST IDX files for {!r} not found in {}'.format(group, data_dir))


def mnist_data_to_petastorm_dataset(output_url, mnist_data=None, train_rows=1000, test_rows=100,
                                    rows_per_row_group=200):
    """Write the train and test groups; ``mnist_data`` (a directory of IDX
    files) writes every row of real MNIST, else ``train_rows`` and
    ``test_rows`` synthetic digits (seeds 0 and 1)."""
    for group, n in (('train', train_rows), ('test', test_rows)):
        group_url = output_url.rstrip('/') + '/' + group
        source = (_real_mnist(mnist_data, group) if mnist_data
                  else _synthetic_mnist(n, seed=0 if group == 'train' else 1))
        rows = ({'idx': idx, 'digit': digit, 'image': image}
                for idx, (digit, image) in enumerate(source))
        write_petastorm_dataset(group_url, MnistSchema, rows,
                                rows_per_row_group=rows_per_row_group)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--output-url', default='file:///tmp/mnist_dataset')
    parser.add_argument('--mnist-data', default=None,
                        help='directory of raw MNIST IDX files; default: synthetic digits')
    parser.add_argument('--train-rows', type=int, default=1000)
    parser.add_argument('--test-rows', type=int, default=100)
    args = parser.parse_args()
    mnist_data_to_petastorm_dataset(args.output_url, args.mnist_data, args.train_rows,
                                    args.test_rows)


if __name__ == '__main__':
    main()
