"""Read a plain Parquet store through the reference's ``petastorm.pytorch``
API with ``make_batch_reader``: twin of
``examples/hello_world/external_dataset/pytorch_hello_world.py``. The
reader is batched, so each sample is a batch of rows.

    python -m petastorm_tpu_torch.examples.hello_world.external_dataset.pytorch_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_batch_reader
from petastorm_tpu_torch.torch_utils import DataLoader


def pytorch_hello_world(dataset_url='file:///tmp/external_dataset'):
    """The first sample (host tensors); prints its ids."""
    with DataLoader(make_batch_reader(dataset_url)) as train_loader:
        sample = next(iter(train_loader))
    print('id batch: {}'.format(sample['id']))
    return sample


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/external_dataset')
    args = parser.parse_args()
    pytorch_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
