"""Client-side row shuffling buffers (twin of ``petastorm_tpu/shuffling_buffer.py``).

The RNG draws are the JAX package's (``np.random.default_rng(seed)``, one
``integers(0, size)`` per retrieve), so a seed gives the same row order in
both packages. A loader checkpoint keeps the random buffer's RNG state
(``rng_state``) beside its rows.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def default_min_after(capacity, min_after_retrieve=None):
    """The decorrelation floor shared by the row and columnar buffers."""
    return min_after_retrieve if min_after_retrieve is not None else max(1, capacity // 2)


def make_shuffling_buffer_factory(capacity, min_after_retrieve=None, seed=None, batch_size=1):
    """``capacity <= 0`` -> FIFO passthrough, else a seeded random buffer of
    rows (the columnar path uses :class:`ShuffledColumnarBuffer` instead)."""
    if capacity <= 0:
        return NoopShufflingBuffer
    floor = default_min_after(capacity, min_after_retrieve)
    return lambda: RandomShufflingBuffer(capacity, floor, extra_capacity=max(1000, batch_size),
                                         seed=seed)


class NoopShufflingBuffer(object):
    """FIFO passthrough."""

    def __init__(self):
        self._items = deque()

    def add_many(self, items):
        self._items.extend(items)

    def retrieve(self):
        return self._items.popleft()

    def can_retrieve(self):
        return len(self._items) > 0

    @property
    def size(self):
        return len(self._items)

    def finish(self):
        pass


class RandomShufflingBuffer(object):
    """Random-swap retrieve with a ``min_after_retrieve`` floor that holds
    until :meth:`finish`. Adds beyond ``capacity`` are accepted up to
    ``extra_capacity`` more (a caller may add a whole row group)."""

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve, extra_capacity=1000,
                 seed=None):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve ({}) must be smaller than capacity ({})'.format(
                min_after_retrieve, shuffling_buffer_capacity))
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._items = []
        self._done_adding = False
        self._rng = np.random.default_rng(seed)

    def add_many(self, items):
        if self._done_adding:
            raise RuntimeError('Cannot add after finish()')
        if len(self._items) + len(items) > self._capacity + self._extra_capacity:
            raise RuntimeError(
                'Attempt to add {} items to a buffer holding {} (capacity {} + extra {})'.format(
                    len(items), len(self._items), self._capacity, self._extra_capacity))
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Buffer cannot retrieve now: size={} min_after_retrieve={}'.format(
                len(self._items), self._min_after_retrieve))
        idx = int(self._rng.integers(0, len(self._items)))
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    def can_retrieve(self):
        if self._done_adding:
            return len(self._items) > 0
        return len(self._items) > self._min_after_retrieve

    @property
    def size(self):
        return len(self._items)

    @property
    def rng_state(self):
        """The RNG's picklable state, for loader checkpoints."""
        return self._rng.bit_generator.state

    @rng_state.setter
    def rng_state(self, state):
        self._rng.bit_generator.state = state

    def resize(self, capacity, min_after):
        """Set the capacity and the decorrelation floor at run time (the
        autotuner's shuffle knob). Buffered items are kept: a shrink stops
        accepting adds until retrieval drains below the new capacity."""
        if min_after >= capacity:
            raise ValueError('min_after ({}) must be smaller than capacity ({})'.format(
                min_after, capacity))
        self._capacity = capacity
        self._min_after_retrieve = min_after

    def finish(self):
        self._done_adding = True
