"""Generate a plain Parquet store with no petastorm metadata: twin of
``examples/hello_world/external_dataset/generate_external_dataset.py``
(pyarrow writes the same table from the same numpy seed).

    python -m petastorm_tpu_torch.examples.hello_world.external_dataset.generate_external_dataset
"""

from __future__ import annotations

import argparse
from urllib.parse import urlparse

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq


def generate_external_dataset(output_url='file:///tmp/external_dataset', rows_count=100):
    path = urlparse(output_url).path
    rng = np.random.default_rng(0)
    table = pa.table({
        'id': pa.array(np.arange(rows_count, dtype=np.int64)),
        'value1': pa.array(rng.integers(0, 255, rows_count, dtype=np.int64)),
        'value2': pa.array(rng.random(rows_count)),
    })
    pq.write_to_dataset(table, path, existing_data_behavior='overwrite_or_ignore')


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--output-url', default='file:///tmp/external_dataset')
    parser.add_argument('--rows-count', type=int, default=100)
    args = parser.parse_args()
    generate_external_dataset(args.output_url, args.rows_count)


if __name__ == '__main__':
    main()
