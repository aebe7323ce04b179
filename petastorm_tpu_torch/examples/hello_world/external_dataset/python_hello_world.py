"""Read a plain Parquet store with ``make_batch_reader``: twin of
``examples/hello_world/external_dataset/python_hello_world.py``. Each item
is a namedtuple of column arrays spanning one row group.

    python -m petastorm_tpu_torch.examples.hello_world.external_dataset.python_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_batch_reader


def python_hello_world(dataset_url='file:///tmp/external_dataset'):
    """Print each row group's size and first ids; return the row groups."""
    blocks = []
    with make_batch_reader(dataset_url) as reader:
        for schema_view in reader:
            print('batch of {} rows; ids: {}'.format(len(schema_view.id), schema_view.id[:10]))
            blocks.append(schema_view)
    return blocks


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/external_dataset')
    args = parser.parse_args()
    python_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
