"""Feed a plain Parquet store into fixed-size batches of tensors on the
card: twin of ``examples/hello_world/external_dataset/jax_hello_world.py``.
The loader re-chunks the row-group blocks into batches of 16.

    python -m petastorm_tpu_torch.examples.hello_world.external_dataset.torch_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_batch_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.torch import TorchDataLoader


def torch_hello_world(dataset_url='file:///tmp/external_dataset', device=None):
    """Batches of 16 rows (a short tail dropped) staged on ``device``
    (``None``: the card); prints and returns them."""
    device = resolve_device(device)
    with make_batch_reader(dataset_url) as reader:
        batches = list(TorchDataLoader(reader, batch_size=16, to_device=device))
    for batch in batches:
        print('id:', tuple(batch['id'].shape), batch['id'].dtype,
              'value2 mean:', float(batch['value2'].mean()))
    return batches


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/external_dataset')
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    args = parser.parse_args()
    torch_hello_world(args.dataset_url, args.device)


if __name__ == '__main__':
    main()
