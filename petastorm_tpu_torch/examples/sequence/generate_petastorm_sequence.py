"""Materialize a synthetic timestamped telemetry dataset for the sequence
example: twin of ``examples/sequence/generate_petastorm_sequence.py`` (the
same numpy draws in the same order, so both write the same rows).

    python -m petastorm_tpu_torch.examples.sequence.generate_petastorm_sequence \\
        --output-url file:///tmp/sequence_dataset
"""

from __future__ import annotations

import argparse

import numpy as np

from petastorm_tpu_torch.etl import write_petastorm_dataset
from petastorm_tpu_torch.examples.sequence.schema import make_telemetry_schema


def generate_sequence_dataset(output_url, rows=4096, feature_dim=64, rows_per_row_group=256,
                              seed=0):
    """AR(1) feature drift plus per-row noise (windows carry real temporal
    structure), ``sensor_id = i % 8``. Returns the schema."""
    schema = make_telemetry_schema(feature_dim)
    rng = np.random.default_rng(seed)

    def rows_iter():
        state = rng.standard_normal(feature_dim).astype(np.float32)
        for i in range(rows):
            state = 0.9 * state + 0.1 * rng.standard_normal(feature_dim).astype(np.float32)
            yield {'timestamp': i,
                   'features': state + 0.05 * rng.standard_normal(feature_dim).astype(np.float32),
                   'sensor_id': int(i % 8)}

    write_petastorm_dataset(output_url, schema, rows_iter(), rows_per_row_group=rows_per_row_group)
    return schema


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--output-url', default='file:///tmp/sequence_dataset')
    parser.add_argument('--rows', type=int, default=4096)
    parser.add_argument('--feature-dim', type=int, default=64)
    args = parser.parse_args()
    generate_sequence_dataset(args.output_url, args.rows, args.feature_dim)


if __name__ == '__main__':
    main()
