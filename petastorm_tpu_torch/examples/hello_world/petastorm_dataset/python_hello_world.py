"""Read a HelloWorld dataset row by row: twin of
``examples/hello_world/petastorm_dataset/python_hello_world.py``.

    python -m petastorm_tpu_torch.examples.hello_world.petastorm_dataset.python_hello_world
"""

from __future__ import annotations

import argparse

from petastorm_tpu_torch import make_reader


def python_hello_world(dataset_url='file:///tmp/hello_world_dataset'):
    """Print each row's id and image shape; return the rows."""
    rows = []
    with make_reader(dataset_url) as reader:
        for sample in reader:
            print(sample.id)
            print(sample.image1.shape)
            rows.append(sample)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/hello_world_dataset')
    args = parser.parse_args()
    python_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
