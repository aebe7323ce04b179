"""Read a HelloWorld dataset through the reference's ``petastorm.pytorch``
API: twin of ``examples/hello_world/petastorm_dataset/pytorch_hello_world.py``.

    python -m petastorm_tpu_torch.examples.hello_world.petastorm_dataset.pytorch_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.torch_utils import DataLoader


def pytorch_hello_world(dataset_url='file:///tmp/hello_world_dataset'):
    """The first sample (a batch of one row, host tensors); prints its id."""
    with DataLoader(make_reader(dataset_url)) as train_loader:
        sample = next(iter(train_loader))
    print(sample['id'])
    return sample


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/hello_world_dataset')
    args = parser.parse_args()
    pytorch_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
