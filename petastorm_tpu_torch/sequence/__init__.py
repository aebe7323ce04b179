"""Sequence data plane: variable-length (token) workloads.

Twin of the ported part of ``petastorm_tpu/sequence/``:

* :mod:`collate`: ragged/padded collation (``pad_to`` multiples, bucket
  boundaries, ``max_length`` truncation), per-batch length vectors and
  padding-waste accounting (``padding_waste_fraction``). Wired into
  :class:`~petastorm_tpu_torch.torch.loader.TorchDataLoader` through
  ``collate_spec=``.
* :mod:`bucket`: bucket-by-length batching, the loader buffer behind
  ``bucket_boundaries=``: rows leave in same-bucket runs of ``batch_size``.
  Deterministic, seedable and checkpoint-compatible.
* :mod:`packing`: greedy first-fit-decreasing packing into fixed
  ``tokens_per_batch`` slots with ``segment_ids``/``positions``
  (``packing_efficiency``).
* :mod:`mixture`: :class:`MixtureReader`, live per-source weights
  (``set_weights()``, :class:`MixtureSchedule` at epoch boundaries) and
  per-source rows, tokens and exhaustion in ``diagnostics`` and the stall
  report.
* :mod:`tail`: tail-following ingest of a store a concurrent writer is
  still appending to (``DatasetWriter(append=True).publish()``): an epoch
  per published ``_snapshots/`` marker, every row delivered once, a bounded
  poll cadence, the ``dataset_grew`` counter.
"""

from __future__ import annotations

from petastorm_tpu_torch.sequence.bucket import BucketBatchBuffer
from petastorm_tpu_torch.sequence.collate import (CollateSpec, PadSpec, collate_ragged_rows,
                                                  padded_length, padding_waste_fraction)
from petastorm_tpu_torch.sequence.mixture import MixtureReader, MixtureSchedule
from petastorm_tpu_torch.sequence.packing import (PackedSequenceLoader, first_fit_decreasing,
                                                  pack_rows)
from petastorm_tpu_torch.sequence.tail import (TailFollowingReader, latest_snapshot,
                                               list_snapshots, publish_snapshot)

__all__ = [
    'BucketBatchBuffer', 'CollateSpec', 'MixtureReader', 'MixtureSchedule',
    'PackedSequenceLoader', 'PadSpec', 'TailFollowingReader', 'collate_ragged_rows',
    'first_fit_decreasing', 'latest_snapshot', 'list_snapshots', 'pack_rows',
    'padded_length', 'padding_waste_fraction', 'publish_snapshot',
]
