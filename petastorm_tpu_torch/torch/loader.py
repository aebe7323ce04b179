"""TorchDataLoader: reader rows or blocks -> fixed-size batches.

Twin of ``JaxDataLoader`` (``petastorm_tpu/jax/loader.py``): the columnar
fast path (batches are numpy slices/gathers of whole row-group blocks, no
per-row Python), the row path with :func:`collate_rows`, the client-side
shuffling buffer with the JAX package's seeded draws (same seed, same
batches), ``drop_last`` and ``to_device``. Output is a dict of numpy arrays,
or of torch tensors on ``to_device``; non-numeric columns stay numpy.

Checkpoints: :meth:`TorchDataLoader.state_dict` holds the reader's state,
the rows buffered client-side as plain rows and the shuffling buffer's RNG
state, in the JAX loader's version-1 layout, so either package resumes the
other's (``resume_state=``). Batches that ``prefetch_to_device`` has staged
count as delivered: a checkpoint that must resume exactly uses the loader's
own ``to_device`` with no prefetch queue.

Not ported yet: ``collate_spec`` and length buckets, NGram windows, the
autotuner hook, ``diagnostics`` and tracing.
"""

from __future__ import annotations

import threading
from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.columnar import FifoColumnarBuffer, ShuffledColumnarBuffer, rows_to_block
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


def _to_plain_row(row):
    """A checkpoint-friendly row: schema namedtuple types are made at run
    time and do not unpickle, so rows are kept as plain dicts."""
    return row._asdict() if hasattr(row, '_asdict') else row


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
    :param resume_state: a dict from :meth:`state_dict` (of either package):
        the rows buffered client-side at the checkpoint are restored, with
        the shuffling buffer's RNG state. Build the reader with its own
        ``resume_state=state['reader']``.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0,
                 min_after_retrieve=None, seed=None, drop_last=True, to_device=None,
                 resume_state=None):
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
        # serializes batch production against state_dict(): a prefetcher may
        # iterate this loader on its thread while the training thread
        # checkpoints
        self._state_lock = threading.Lock()
        self._buffer = None
        self._pending = []
        self._resume_rows = None
        self._resume_rng = None
        if resume_state is not None:
            if not isinstance(resume_state, dict) or resume_state.get('version') != 1:
                raise ValueError('Unrecognized resume_state (expected a dict produced by '
                                 'TorchDataLoader.state_dict())')
            self._resume_rows = list(resume_state['rows'])
            self._resume_rng = resume_state.get('buffer_rng')

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
        # eager, not in the generator: a second iter() while rows are
        # buffered would rebind the buffer and drop the first iterator's
        # rows from later checkpoints
        if (self._buffer is not None and self._buffer.size) or self._pending:
            raise RuntimeError(
                'TorchDataLoader.__iter__ called again while a previous iteration still holds '
                'buffered rows; exhaust the previous iterator (or create a new loader) first.')
        buffer = self._buffer = self._make_buffer()
        self._pending = []
        if self._resume_rng is not None and hasattr(buffer, 'rng_state'):
            buffer.rng_state = self._resume_rng
        self._resume_rng = None
        if self._resume_rows:
            if self._columnar:
                buffer.add_block(rows_to_block(self._resume_rows))
            else:
                buffer.add_many(self._resume_rows)
        # cleared even when empty: a left-over [] would keep state_dict() on
        # the resume branch
        self._resume_rows = None
        return (self._iterate_columnar(buffer) if self._columnar
                else self._iterate(buffer, self._pending))

    def _iterate_columnar(self, buffer):
        # the state lock is held around buffer changes and batch extraction,
        # never across the blocking next(reader_it); exactly one batch leaves
        # the buffer per yield, so a checkpoint never misses rows
        bs = self.batch_size
        reader_it = iter(self.reader)
        exhausted = False
        while True:
            with self._state_lock:
                batch = None
                if not exhausted:
                    if buffer.can_emit(bs):
                        batch = self._emit(buffer.emit(bs))
                elif buffer.size >= bs:
                    batch = self._emit(buffer.emit(bs))
                elif buffer.size and not self._drop_last:
                    batch = self._emit(buffer.emit(buffer.size))
                else:
                    # drop_last leftovers are dropped: clear, so an
                    # exhausted loader can be iterated again
                    buffer.clear()
                    return
            if batch is not None:
                yield batch
                continue
            item = next(reader_it, None)
            with self._state_lock:
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    buffer.add_block(dict(item._asdict()))

    def _iterate(self, buffer, pending):
        # one batch per yield, collated under the lock before the yield: a
        # checkpoint taken while the consumer holds a batch does not count
        # its rows as pending
        bs = self.batch_size
        reader_it = iter(self.reader)
        exhausted = False
        while True:
            with self._state_lock:
                batch = None
                while buffer.can_retrieve() and len(pending) < bs:
                    pending.append(buffer.retrieve())
                if len(pending) == bs:
                    batch = self._emit(collate_rows(pending))
                    pending.clear()
                elif exhausted:
                    if pending and not self._drop_last:
                        batch = self._emit(collate_rows(pending))
                    pending.clear()
                    if batch is None:
                        return
            if batch is not None:
                yield batch
                continue
            item = next(reader_it, None)
            with self._state_lock:
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    buffer.add_many([item])

    def _emit(self, batch):
        batch = _sanitize_batch_columns(batch)
        if self._to_device is not None:
            batch = stage_batch(batch, self._to_device)
        return batch

    def state_dict(self):
        """The loader's read position (version 1, the JAX loader's layout):
        the reader's :meth:`~petastorm_tpu_torch.reader.Reader.state_dict`,
        every row buffered client-side (shuffling buffer and partial batch)
        as a plain row, and the shuffling buffer's RNG state, so a seeded
        resume reproduces the stream. The state holds the buffered rows:
        with a large ``shuffling_queue_capacity`` it is as large. Resume
        with::

            reader = make_reader(url, ..., resume_state=state['reader'])
            loader = TorchDataLoader(reader, ..., resume_state=state)
        """
        with self._state_lock:
            if self._resume_rows is not None:
                # built to resume and not iterated yet: the restored rows and
                # RNG still wait to be injected
                rows = list(self._resume_rows)
                rng = self._resume_rng
            else:
                rows = []
                if self._buffer is not None:
                    rows.extend(self._buffer.snapshot_rows() if self._columnar
                                else getattr(self._buffer, '_items', []))
                rows.extend(self._pending)
                rng = getattr(self._buffer, 'rng_state', None)
            return {'version': 1,
                    'reader': self.reader.state_dict(),
                    'buffer_rng': rng,
                    'rows': [_to_plain_row(r) for r in rows]}

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()


def make_torch_dataset(reader, batch_size, **loader_kwargs):
    """An iterator of batches: :class:`TorchDataLoader` over ``reader`` (the
    twin of ``make_jax_dataset``)."""
    return iter(TorchDataLoader(reader, batch_size, **loader_kwargs))
