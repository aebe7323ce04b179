"""Bucket-by-length batching buffer for the loader's row path (twin of
``petastorm_tpu/sequence/bucket.py``: same buckets, same seeded order).

Padding waste is quadratic in length dispersion: one 900-token row in a batch
of 12-token rows pads everything to 900. The fix is classic bucketing — rows
are routed to length buckets, and the buffer only releases rows in
SAME-BUCKET runs of ``batch_size``, so each padded batch mixes only
near-equal lengths. The loader composes this with
:class:`~petastorm_tpu_torch.sequence.collate.CollateSpec` bucket boundaries, so the
padded length of each batch is its bucket boundary.

The class implements the exact client-side buffer interface
:class:`~petastorm_tpu_torch.torch.loader.TorchDataLoader` already speaks
(``add_many``/``can_retrieve``/``retrieve``/``finish``/``clear``/``size``)
plus the checkpoint surface (``_items`` row snapshot, ``rng_state``), so
loader ``state_dict()``/resume works through bucketed batching unchanged:
checkpointed rows are re-injected with ``add_many`` and re-bucket
deterministically.

Determinism: bucket assignment is a pure function of row length; release
order is FIFO per bucket; the only randomness is the optional seeded
WITHIN-bucket shuffle at release time (never an unseeded global RNG: the
stream must be reproducible under a fixed seed).
"""

from __future__ import annotations

from bisect import bisect_left
from collections import deque

import numpy as np


class BucketBatchBuffer(object):
    """
    :param boundaries: sorted length boundaries; a row of length L lands in
        the first bucket whose boundary >= L (longer rows share one overflow
        bucket).
    :param batch_size: run length released per full bucket — align with the
        loader's ``batch_size`` so every emitted batch is single-bucket.
    :param length_of: field name (or callable row -> int) giving a row's
        sequence length.
    :param seed: seeds the within-bucket shuffle applied as each full run is
        released; ``None`` keeps strict FIFO order (still deterministic).
    """

    def __init__(self, boundaries, batch_size, length_of, seed=None):
        self._boundaries = tuple(sorted(int(b) for b in boundaries))
        if not self._boundaries:
            raise ValueError('boundaries must be non-empty')
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self._batch_size = batch_size
        if callable(length_of):
            self._length_of = length_of
        else:
            name = length_of

            def _field_length(row, _name=name):
                value = row[_name] if isinstance(row, dict) else getattr(row, _name)
                return len(value)
            self._length_of = _field_length
        # one overflow bucket past the last boundary keeps long rows batched
        # together instead of erroring (their collate pads beyond the ladder)
        self._buckets = [deque() for _ in range(len(self._boundaries) + 1)]
        self._ready = deque()
        self._size = 0
        self._finished = False
        self._rng = np.random.default_rng(seed) if seed is not None else None

    # -- buffer interface (TorchDataLoader row path) ------------------------

    @property
    def size(self):
        return self._size

    def add_many(self, rows):
        for row in rows:
            idx = bisect_left(self._boundaries, self._length_of(row))
            bucket = self._buckets[idx]
            bucket.append(row)
            self._size += 1
            if len(bucket) >= self._batch_size:
                self._release(bucket, self._batch_size)

    def can_add(self):
        return not self._finished

    def can_retrieve(self):
        if self._ready:
            return True
        if self._finished:
            # leftovers flush in boundary order; batches formed across a
            # bucket seam pad to the larger bucket — correct, just less tight
            for bucket in self._buckets:
                if bucket:
                    self._release(bucket, len(bucket))
                    return True
        return False

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Bucket buffer has no retrievable rows')
        self._size -= 1
        return self._ready.popleft()

    def finish(self):
        self._finished = True

    def clear(self):
        for bucket in self._buckets:
            bucket.clear()
        self._ready.clear()
        self._size = 0
        self._finished = False

    def _release(self, bucket, count):
        run = [bucket.popleft() for _ in range(count)]
        if self._rng is not None and count > 1:
            order = self._rng.permutation(count)
            run = [run[i] for i in order]
        self._ready.extend(run)

    # -- checkpoint surface -------------------------------------------------

    @property
    def _items(self):
        """Every buffered row (released runs first, then buckets in boundary
        order) — the loader's ``state_dict()`` snapshots this, and resume
        re-buckets the rows via ``add_many``."""
        rows = list(self._ready)
        for bucket in self._buckets:
            rows.extend(bucket)
        return rows

    @property
    def rng_state(self):
        return self._rng.bit_generator.state if self._rng is not None else None

    @rng_state.setter
    def rng_state(self, state):
        if state is not None:
            if self._rng is None:
                self._rng = np.random.default_rng(0)
            self._rng.bit_generator.state = state

    def __repr__(self):
        return 'BucketBatchBuffer(boundaries={}, size={}, ready={})'.format(
            self._boundaries, self._size, len(self._ready))
