"""Read a HelloWorld dataset into batches of tensors on the card: twin of
``examples/hello_world/petastorm_dataset/jax_hello_world.py``.

    python -m petastorm_tpu_torch.examples.hello_world.petastorm_dataset.torch_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.torch import TorchDataLoader


def torch_hello_world(dataset_url='file:///tmp/hello_world_dataset', device=None):
    """Batches of 4 rows (the last one short) of ``id`` and ``image1``
    staged on ``device`` (``None``: the card); prints and returns them."""
    device = resolve_device(device)
    with make_reader(dataset_url, schema_fields=['id', 'image1']) as reader:
        batches = list(TorchDataLoader(reader, batch_size=4, drop_last=False, to_device=device))
    for batch in batches:
        print('id batch:', batch['id'], 'image1:', tuple(batch['image1'].shape),
              'on', batch['image1'].device)
    return batches


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/hello_world_dataset')
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    args = parser.parse_args()
    torch_hello_world(args.dataset_url, args.device)


if __name__ == '__main__':
    main()
