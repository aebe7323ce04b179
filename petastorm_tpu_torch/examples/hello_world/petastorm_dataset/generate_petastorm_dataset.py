"""Generate a small HelloWorld dataset: twin of
``examples/hello_world/petastorm_dataset/generate_petastorm_dataset.py``
(the same rows from the same numpy seeds).

    python -m petastorm_tpu_torch.examples.hello_world.petastorm_dataset.generate_petastorm_dataset
"""

from __future__ import annotations

import argparse

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl import write_petastorm_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(), False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def row_generator(x):
    """The dataset's row ``x``."""
    rng = np.random.default_rng(x)
    return {'id': x,
            'image1': rng.integers(0, 255, dtype=np.uint8, size=(128, 256, 3)),
            'array_4d': rng.integers(0, 255, dtype=np.uint8, size=(4, 128, 30, 3))}


def generate_petastorm_dataset(output_url='file:///tmp/hello_world_dataset', rows_count=10):
    write_petastorm_dataset(output_url, HelloWorldSchema,
                            (row_generator(i) for i in range(rows_count)), row_group_size_mb=256)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--output-url', default='file:///tmp/hello_world_dataset')
    parser.add_argument('--rows-count', type=int, default=10)
    args = parser.parse_args()
    generate_petastorm_dataset(args.output_url, args.rows_count)


if __name__ == '__main__':
    main()
