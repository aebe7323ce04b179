"""How well a stream is shuffled: the rank correlation of its ids against
their sorted order.

Twin of ``petastorm_tpu/test_util/shuffling_analysis.py``. A well-shuffled
stream's correlation with the sequential order is near 0, and its
distribution over repeated runs stays close to 0.
"""

from __future__ import annotations

import numpy as np


def rank_correlation(ids):
    """Spearman rank correlation of the stream against the order 0..N-1:
    1.0 unshuffled, about 0 decorrelated, -1.0 exactly reversed."""
    ids = np.asarray(ids, dtype=np.float64)
    n = len(ids)
    if n < 2:
        return 1.0
    position = np.arange(n, dtype=np.float64)
    ranks = np.argsort(np.argsort(ids)).astype(np.float64)
    return float(np.corrcoef(position, ranks)[0, 1])


def compute_correlation_distribution(reader_factory, num_runs=5, id_field='id'):
    """The absolute rank correlation of the ``id_field`` stream of each of
    ``num_runs`` readers ``reader_factory()`` opens, as an array."""
    correlations = []
    for _ in range(num_runs):
        with reader_factory() as reader:
            ids = [getattr(row, id_field) for row in reader]
        correlations.append(abs(rank_correlation(ids)))
    return np.asarray(correlations)
