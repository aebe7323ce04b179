"""TorchDataLoader: reader rows or blocks -> fixed-size batches.

Twin of ``JaxDataLoader`` (``petastorm_tpu/jax/loader.py``): the columnar
fast path (batches are numpy slices/gathers of whole row-group blocks, no
per-row Python), the row path with :func:`collate_rows`, the client-side
shuffling buffer with the JAX package's seeded draws (same seed, same
batches), ``drop_last`` and ``to_device``. Output is a dict of numpy arrays,
or of torch tensors on ``to_device``; non-numeric columns stay numpy.
Not ported yet: ``state_dict``/resume, ``collate_spec`` and length buckets,
NGram windows, the autotuner hook, ``diagnostics`` and tracing.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.columnar import FifoColumnarBuffer, ShuffledColumnarBuffer
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.shuffling_buffer import default_min_after, make_shuffling_buffer_factory
from petastorm_tpu_torch.torch.infeed import stage_batch


def _sanitize_value(value):
    """numpy-ify one row value: Decimal -> float64, datetime -> int64 ns ticks."""
    if isinstance(value, Decimal):
        return np.float64(value)
    if isinstance(value, np.datetime64):
        return value.astype('datetime64[ns]').astype(np.int64)
    return value


def collate_rows(rows, field_names=None):
    """Stack a list of row dicts/namedtuples into a dict of ``[B, ...]``
    arrays; string/bytes/None fields become object arrays (host-only)."""
    if not rows:
        raise PetastormTpuError('Cannot collate an empty batch')
    rows = [r._asdict() if hasattr(r, '_asdict') else r for r in rows]
    batch = {}
    for name in field_names or list(rows[0]):
        values = [_sanitize_value(r[name]) for r in rows]
        v0 = values[0]
        if v0 is None or isinstance(v0, (str, bytes)):
            arr = np.empty(len(values), dtype=object)
            arr[:] = values
            batch[name] = arr
            continue
        try:
            batch[name] = np.stack(values)
        except ValueError:
            shapes = {np.shape(v) for v in values}
            if len(shapes) > 1:
                raise PetastormTpuError(
                    'Field {!r} has non-uniform shapes {} within a batch; use a TransformSpec '
                    'to crop/pad it to a fixed shape, or exclude it via '
                    'schema_fields.'.format(name, sorted(shapes)))
            raise
    return batch


def _sanitize_batch_columns(batch):
    """Column-at-a-time twin of :func:`_sanitize_value`: datetime columns ->
    int64 ns ticks, Decimal object columns -> float64 (``None`` cells keep
    the column an object column)."""
    for name, col in batch.items():
        if not isinstance(col, np.ndarray):
            continue
        if col.dtype.kind == 'M':
            batch[name] = col.astype('datetime64[ns]').astype(np.int64)
        elif col.dtype == object and col.size:
            v0 = next((v for v in col if v is not None), None)
            if not isinstance(v0, (Decimal, np.datetime64)):
                continue
            converted = [None if v is None else _sanitize_value(v) for v in col]
            if any(v is None for v in converted):
                out = np.empty(len(converted), dtype=object)
                out[:] = converted
                batch[name] = out
            else:
                batch[name] = np.array(converted)
    return batch


class TorchDataLoader(object):
    """
    :param reader: a :class:`petastorm_tpu_torch.reader.Reader`
    :param batch_size: rows per emitted batch
    :param shuffling_queue_capacity: > 0 enables a client-side shuffling
        buffer of that capacity
    :param min_after_retrieve: decorrelation floor (default capacity // 2)
    :param seed: shuffling buffer RNG seed
    :param drop_last: drop the ragged final batch (default True: static shapes)
    :param to_device: ``None`` -> numpy host batches; a device -> torch
        tensors staged there (use :func:`prefetch_to_device` to overlap the
        copy with compute)
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0,
                 min_after_retrieve=None, seed=None, drop_last=True, to_device=None):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        if getattr(reader, 'ngram', None) is not None:
            raise NotImplementedError('NGram windows are not yet ported to petastorm_tpu_torch '
                                      '(ROADMAP.md, "long context")')
        self.reader = reader
        self.batch_size = batch_size
        self._drop_last = drop_last
        self._to_device = to_device
        self._columnar = bool(reader.batched_output)
        self._shuffle_capacity = shuffling_queue_capacity
        self._min_after_retrieve = min_after_retrieve
        self._shuffle_seed = seed
        self._iterating = False

    def _make_buffer(self):
        capacity = self._shuffle_capacity
        if self._columnar:
            if capacity > 0:
                return ShuffledColumnarBuffer(
                    capacity, default_min_after(capacity, self._min_after_retrieve),
                    self._shuffle_seed)
            return FifoColumnarBuffer()
        return make_shuffling_buffer_factory(capacity, self._min_after_retrieve,
                                             self._shuffle_seed, self.batch_size)()

    def __iter__(self):
        if self._iterating:
            raise RuntimeError('TorchDataLoader.__iter__ called again while a previous iteration '
                               'is still active; exhaust it (or create a new loader) first.')
        self._iterating = True
        buffer = self._make_buffer()
        return self._iterate_columnar(buffer) if self._columnar else self._iterate(buffer)

    def _iterate_columnar(self, buffer):
        bs = self.batch_size
        reader_it = iter(self.reader)
        exhausted = False
        try:
            while True:
                if not exhausted:
                    if buffer.can_emit(bs):
                        yield self._emit(buffer.emit(bs))
                        continue
                elif buffer.size >= bs:
                    yield self._emit(buffer.emit(bs))
                    continue
                elif buffer.size and not self._drop_last:
                    yield self._emit(buffer.emit(buffer.size))
                    continue
                else:
                    buffer.clear()
                    return
                item = next(reader_it, None)
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    buffer.add_block(dict(item._asdict()))
        finally:
            self._iterating = False

    def _iterate(self, buffer):
        bs = self.batch_size
        reader_it = iter(self.reader)
        pending = []
        exhausted = False
        try:
            while True:
                while buffer.can_retrieve() and len(pending) < bs:
                    pending.append(buffer.retrieve())
                if len(pending) == bs:
                    batch, pending = pending, []
                    yield self._emit(collate_rows(batch))
                    continue
                if exhausted:
                    if pending and not self._drop_last:
                        batch, pending = pending, []
                        yield self._emit(collate_rows(batch))
                    return
                item = next(reader_it, None)
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    buffer.add_many([item])
        finally:
            self._iterating = False

    def _emit(self, batch):
        batch = _sanitize_batch_columns(batch)
        if self._to_device is not None:
            batch = stage_batch(batch, self._to_device)
        return batch

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()
