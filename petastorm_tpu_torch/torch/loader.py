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

Variable-length rows: ``collate_spec=`` pads the named fields per batch
(:mod:`petastorm_tpu_torch.sequence.collate`), and ``bucket_boundaries=``
batches rows by length bucket (:class:`~petastorm_tpu_torch.sequence.bucket.
BucketBatchBuffer`), as the JAX loader does.

Telemetry, as the JAX loader's: the time spent waiting on the reader
(``reader_wait_s``), :attr:`TorchDataLoader.diagnostics` with its full key
set from construction (feed it to
:func:`~petastorm_tpu_torch.observability.stall_report`), the
``shuffle.add_block``/``shuffle.emit`` spans and the ``collate`` stage (at
block granularity, never per row), ``loader_batches_total``,
:attr:`TorchDataLoader.last_trace`, the flight recorder's progress source
and the closing stall record, and the autotuner's shuffle knob
(:meth:`TorchDataLoader.set_shuffle_capacity`).

NGram windows: a row reader's windows (``offset -> namedtuple``) collate
offset by offset into ``offset -> field -> [B, ...]``; a columnar reader's
nested window blocks are buffered under flat ``(offset, field)`` keys, so
the shuffling buffer slices and shuffles windows as it does rows, and leave
as the same nested batch. :func:`stack_ngram_time_axis` turns such a batch
into ``field -> [B, T, ...]`` time-major arrays for the sequence model.
"""

from __future__ import annotations

import threading
import time
from decimal import Decimal

import numpy as np
import torch

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.columnar import FifoColumnarBuffer, ShuffledColumnarBuffer, rows_to_block
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry
from petastorm_tpu_torch.observability import blackbox
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
                    'Field {!r} has non-uniform shapes {} within a batch. For variable-length '
                    'sequences, pass collate_spec=CollateSpec({{{!r}: PadSpec(...)}}) for '
                    'per-batch ragged padding (petastorm_tpu_torch.sequence); otherwise use a '
                    'TransformSpec to crop/pad it to a fixed shape, or exclude it via '
                    'schema_fields.'.format(name, sorted(shapes), name))
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


def _flatten_ngram_block(nested):
    """Nested window block ``{offset: {field: col}}`` -> flat
    ``{(offset, field): col}``, so the columnar buffers (which see only dicts
    of equal-length columns) shuffle and slice windows as rows."""
    return {(off, name): col for off, fields in nested.items()
            for name, col in fields.items()}


def _unflatten_ngram_batch(flat):
    out = {}
    for (off, name), col in flat.items():
        out.setdefault(off, {})[name] = col
    return out


def _to_plain_row(row):
    """A checkpoint-friendly row: schema namedtuple types are made at run
    time and do not unpickle, so rows are kept as plain dicts, and an NGram
    window (``offset -> namedtuple``) as a dict of them."""
    if hasattr(row, '_asdict'):
        return row._asdict()
    if isinstance(row, dict):
        return {k: (v._asdict() if hasattr(v, '_asdict') else v) for k, v in row.items()}
    return row


class TorchDataLoader(object):
    """
    :param reader: a :class:`petastorm_tpu_torch.reader.Reader`
    :param batch_size: rows per emitted batch
    :param shuffling_queue_capacity: > 0 enables a client-side shuffling
        buffer of that capacity
    :param min_after_retrieve: decorrelation floor (default capacity // 2)
    :param seed: shuffling buffer RNG seed (with ``bucket_boundaries``, the
        within-bucket shuffle's)
    :param drop_last: drop the ragged final batch (default True: static shapes)
    :param to_device: ``None`` -> numpy host batches; a device -> torch
        tensors staged there; a
        :class:`~petastorm_tpu_torch.parallel.DataSharding` -> this rank's
        rows on its device, equal over its replica group (use
        :func:`prefetch_to_device` to overlap the copy with compute)
    :param resume_state: a dict from :meth:`state_dict` (of either package):
        the rows buffered client-side at the checkpoint are restored, with
        the shuffling buffer's RNG state. Build the reader with its own
        ``resume_state=state['reader']``.
    :param collate_spec: a :class:`~petastorm_tpu_torch.sequence.CollateSpec`:
        each batch pads the named fields to a per-batch length (``pad_to``
        rounding, a ``buckets`` ladder, a ``max_length`` cap), adds
        ``<field>_lengths`` and accounts its padding waste
        (``diagnostics['padding_waste_fraction']``). Row readers only.
    :param bucket_boundaries: with ``collate_spec``, batch by length bucket:
        rows leave the buffer only in same-bucket runs of ``batch_size``, so
        a padded batch mixes near-equal lengths. Deterministic and
        checkpoint-compatible (``seed`` drives the within-bucket shuffle);
        it replaces the shuffling buffer: pass
        ``shuffling_queue_capacity=0``.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0,
                 min_after_retrieve=None, seed=None, drop_last=True, to_device=None,
                 resume_state=None, collate_spec=None, bucket_boundaries=None):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self.reader = reader
        self.batch_size = batch_size
        self._drop_last = drop_last
        self._to_device = to_device
        self._ngram = getattr(reader, 'ngram', None)
        self._columnar = bool(reader.batched_output)
        # a columnar NGram reader's nested window blocks are buffered under
        # flat (offset, field) keys
        self._columnar_ngram = self._columnar and self._ngram is not None
        # ragged collation and bucket-by-length batching, with the JAX
        # loader's argument checks
        self._collate_spec = collate_spec
        self._bucket_boundaries = tuple(bucket_boundaries) if bucket_boundaries else None
        self._pad_stats = {'real_tokens': 0, 'padded_tokens': 0}
        if collate_spec is not None:
            if self._columnar:
                raise ValueError(
                    "collate_spec requires a row-oriented reader (output='rows'): "
                    'ragged collation pads per-row cells, and columnar blocks are '
                    'already stacked')
            if self._ngram is not None:
                raise ValueError('collate_spec is not supported with ngram windows '
                                 '(windows collate per offset, not per ragged field)')
        if self._bucket_boundaries is not None:
            if collate_spec is None:
                raise ValueError('bucket_boundaries requires collate_spec: bucketing '
                                 "batches by the spec's length field")
            if shuffling_queue_capacity > 0:
                raise ValueError('bucket_boundaries replaces the shuffling buffer '
                                 '(seed drives the within-bucket shuffle); pass '
                                 'shuffling_queue_capacity=0')
        # the shuffle knob: _make_buffer reads these live, so a run-time
        # set_shuffle_capacity applies to later epochs' buffers too
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
        # the diagnostics keys exist from construction (zeros before the
        # first batch)
        self._iter_start = None
        self._reader_wait_s = 0.0
        self._rows_out = 0
        #: virtual-root trace context of the last reader item folded into an
        #: emitted batch (a shuffled batch mixes items: the last one stands
        #: for the batch); the collate and infeed spans link to it
        self.last_trace = None
        if resume_state is not None:
            if not isinstance(resume_state, dict) or resume_state.get('version') != 1:
                raise ValueError('Unrecognized resume_state (expected a dict produced by '
                                 'TorchDataLoader.state_dict())')
            self._resume_rows = list(resume_state['rows'])
            self._resume_rng = resume_state.get('buffer_rng')
        # an autotuned reader's controller reads this loader's diagnostics
        # (they carry the consumer's wait) and gains the shuffle knob
        tuner = getattr(reader, 'autotuner', None)
        if tuner is not None:
            tuner.attach_loader(self)
        # the flight recorder's progress source: batches emitted
        if blackbox.maybe_enable('loader') is not None:
            blackbox.watch_progress('loader_batches', lambda: obs.get_registry()
                                    .value('loader_batches_total'))

    def _make_buffer(self):
        """The client-side buffer from the current shuffle knob values (one
        construction site for the first iteration and every later epoch)."""
        capacity = self._shuffle_capacity
        if self._bucket_boundaries is not None:
            from petastorm_tpu_torch.sequence.bucket import BucketBatchBuffer
            return BucketBatchBuffer(self._bucket_boundaries, self.batch_size,
                                     self._collate_spec.length_of, seed=self._shuffle_seed)
        if self._columnar:
            if capacity > 0:
                return ShuffledColumnarBuffer(
                    capacity, default_min_after(capacity, self._min_after_retrieve),
                    self._shuffle_seed)
            return FifoColumnarBuffer()
        return make_shuffling_buffer_factory(capacity, self._min_after_retrieve,
                                             self._shuffle_seed, self.batch_size)()

    @property
    def shuffle_capacity(self):
        """The live shuffle-buffer capacity (0: no shuffling buffer)."""
        return self._shuffle_capacity

    def set_shuffle_capacity(self, capacity):
        """Resize the shuffling buffer at run time (the autotuner's shuffle
        knob): the live buffer keeps its rows, and later epochs' buffers are
        built at the new capacity. Only for a loader built with a shuffling
        buffer: switching shuffling on or off mid-run would change what is
        delivered, not only how fast."""
        capacity = int(capacity)
        if capacity < 2:
            raise ValueError('shuffle capacity must be >= 2 (the decorrelation '
                             'floor must stay below it)')
        if self._shuffle_capacity <= 0:
            raise RuntimeError('loader has no shuffling buffer (constructed with '
                               'shuffling_queue_capacity=0); the shuffle knob is '
                               'unavailable')
        with self._state_lock:
            self._shuffle_capacity = capacity
            # an explicit floor may exceed the new capacity: derive it again
            self._min_after_retrieve = None
            buffer = self._buffer
            if buffer is not None and hasattr(buffer, 'resize'):
                buffer.resize(capacity, default_min_after(capacity))
        return capacity

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

    def _next_item(self, reader_it):
        """The reader's next item, or None at its end; the wait counts in
        ``reader_wait_s``."""
        w0 = time.perf_counter()
        try:
            return next(reader_it, None)
        finally:
            self._reader_wait_s += time.perf_counter() - w0

    def _start_iteration(self):
        self._iter_start = time.perf_counter()
        self._reader_wait_s = 0.0
        self._rows_out = 0

    def _iterate_columnar(self, buffer):
        # the state lock is held around buffer changes and batch extraction,
        # never across the blocking next(reader_it); exactly one batch leaves
        # the buffer per yield, so a checkpoint never misses rows
        self._start_iteration()
        bs = self.batch_size
        reader_it = iter(self.reader)
        exhausted = False
        while True:
            with self._state_lock:
                batch = None
                if not exhausted:
                    if buffer.can_emit(bs):
                        batch = self._emit_columnar(self._buffer_emit(buffer, bs))
                elif buffer.size >= bs:
                    batch = self._emit_columnar(self._buffer_emit(buffer, bs))
                elif buffer.size and not self._drop_last:
                    batch = self._emit_columnar(self._buffer_emit(buffer, buffer.size))
                else:
                    # drop_last leftovers are dropped: clear, so an
                    # exhausted loader can be iterated again
                    buffer.clear()
                    return
            if batch is not None:
                yield batch
                continue
            item = self._next_item(reader_it)
            with self._state_lock:
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    # block granularity (a row group), never per row
                    with obs.span('shuffle.add_block', cat='loader', occupancy=buffer.size):
                        buffer.add_block(_flatten_ngram_block(item) if self._columnar_ngram
                                         else dict(item._asdict()))
                    obs.gauge_set('shuffle_buffer_occupancy', buffer.size)

    @staticmethod
    def _buffer_emit(buffer, count):
        """One batch out of the shuffling buffer, traced with its occupancy
        before the emit."""
        with obs.span('shuffle.emit', cat='loader', occupancy=buffer.size, rows=count):
            return buffer.emit(count)

    def _emit_columnar(self, batch):
        n = len(next(iter(batch.values()))) if batch else 0
        self._rows_out += n
        self.last_trace = getattr(self.reader, 'last_trace', None)
        with obs.stage('collate', cat='loader', rows=n) as sp:
            sp.link(self.last_trace)
            batch = _sanitize_batch_columns(batch)
            if self._columnar_ngram:
                batch = _unflatten_ngram_batch(batch)
        return self._finish_batch(batch)

    def _iterate(self, buffer, pending):
        # one batch per yield, collated under the lock before the yield: a
        # checkpoint taken while the consumer holds a batch does not count
        # its rows as pending
        self._start_iteration()
        bs = self.batch_size
        reader_it = iter(self.reader)
        exhausted = False
        while True:
            with self._state_lock:
                batch = None
                while buffer.can_retrieve() and len(pending) < bs:
                    pending.append(buffer.retrieve())
                if len(pending) == bs:
                    batch = self._emit_rows(pending)
                    pending.clear()
                elif exhausted:
                    if pending and not self._drop_last:
                        batch = self._emit_rows(pending)
                    pending.clear()
                    if batch is None:
                        return
            if batch is not None:
                yield batch
                continue
            item = self._next_item(reader_it)
            with self._state_lock:
                if item is None:
                    buffer.finish()
                    exhausted = True
                else:
                    # one row: no telemetry here (the occupancy gauge rides
                    # the per-batch emit)
                    buffer.add_many([item])

    def _emit_rows(self, rows):
        self._rows_out += len(rows)
        self.last_trace = getattr(self.reader, 'last_trace', None)
        with obs.stage('collate', cat='loader', rows=len(rows)) as sp:
            sp.link(self.last_trace)
            if self._ngram is not None:
                batch = self._collate_ngram(rows)
            elif self._collate_spec is not None:
                from petastorm_tpu_torch.sequence.collate import (collate_ragged_rows,
                                                                  padding_waste_fraction)
                batch = collate_ragged_rows(rows, self._collate_spec, self._pad_stats)
                obs.gauge_set('padding_waste_fraction', padding_waste_fraction(self._pad_stats))
            else:
                batch = _sanitize_batch_columns(collate_rows(rows))
        if self._buffer is not None:
            obs.gauge_set('shuffle_buffer_occupancy', self._buffer.size)
        return self._finish_batch(batch)

    @staticmethod
    def _collate_ngram(windows):
        """Windows (dicts ``offset -> namedtuple``) -> ``offset -> field ->
        [B, ...]``."""
        return {offset: collate_rows([w[offset] for w in windows]) for offset in windows[0]}

    def _finish_batch(self, batch):
        obs.count('loader_batches_total')
        if self._to_device is not None:
            with obs.use_trace(self.last_trace):
                batch = stage_batch(batch, self._to_device)
        return batch

    def state_dict(self):
        """The loader's read position (version 1, the JAX loader's layout):
        the reader's :meth:`~petastorm_tpu_torch.reader.Reader.state_dict`,
        every row buffered client-side (shuffling or bucket buffer and
        partial batch) as a plain row, and the buffer's RNG state, so a
        seeded resume reproduces the stream. The state holds the buffered
        rows: with a large ``shuffling_queue_capacity`` it is as large.
        Resume with::

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

    @property
    def diagnostics(self):
        """The reader's diagnostics (the metrics registry with the workers'
        snapshots, and the pool's counters) and the loader's: rows emitted,
        seconds blocked on the reader and their share of the wall time since
        iteration started, the padding waste of ``collate_spec``, and the
        ``lifetime_*`` borrow counters (the shuffle buffer's and the staged
        batches' borrows). Every loader key is present from construction
        (zeros before the first batch). Feed it to
        :func:`~petastorm_tpu_torch.observability.stall_report`."""
        out = dict(self.reader.diagnostics)
        if self._iter_start is not None:
            elapsed = max(time.perf_counter() - self._iter_start, 1e-9)
            wait_fraction = round(self._reader_wait_s / elapsed, 4)
        else:
            wait_fraction = 0.0
        if self._collate_spec is not None:
            from petastorm_tpu_torch.sequence.collate import padding_waste_fraction
            waste = padding_waste_fraction(self._pad_stats)
        else:
            waste = 0.0
        out.update({
            'rows_emitted': self._rows_out,
            'reader_wait_s': round(self._reader_wait_s, 4),
            'reader_wait_fraction': wait_fraction,
            'padding_waste_fraction': waste,
        })
        out.update(lifetime_registry().counters())
        return out

    @property
    def quarantined_items(self):
        """The reader's records of row groups quarantined under
        ``on_error='skip'``."""
        return getattr(self.reader, 'quarantined_items', [])

    def stop(self):
        # the closing stall attribution goes into the flight file, so a
        # post-mortem names the last bottleneck
        if blackbox.get_recorder() is not None:
            try:
                blackbox.record_stall(obs.stall_report(self.diagnostics))
            except Exception:  # noqa: BLE001 - teardown forensics must never mask stop()
                pass
            blackbox.unwatch_progress('loader_batches')
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()


def stack_ngram_time_axis(ngram_batch):
    """Collapse a collated NGram batch (``offset -> field -> [B, ...]``) into
    ``field -> [B, T, ...]``, T being the window length in offset order.

    The bridge from the reader's windowed readout to sequence-sharded
    training: the result can be staged onto a sequence sharding
    (``data_sharding(mesh, seq_axis='seq')``) and consumed by the
    context-parallel attention ops (:mod:`petastorm_tpu_torch.ops.ring_attention`).
    numpy columns stack into numpy, tensors (a batch staged on a device)
    into a tensor on their device. Fields absent from some timesteps (an
    NGram allows per-timestep field sets) are skipped."""
    offsets = sorted(ngram_batch)
    common = set(ngram_batch[offsets[0]])
    for off in offsets[1:]:
        common &= set(ngram_batch[off])
    out = {}
    for name in sorted(common):
        cols = [ngram_batch[off][name] for off in offsets]
        shapes = sorted({tuple(np.shape(c)) for c in cols})
        if len(shapes) > 1:
            raise PetastormTpuError(
                'NGram field {!r} has non-uniform shapes across timesteps '
                '{}: {}. Pad/crop it to a fixed shape with a TransformSpec, or '
                'collate ragged fields via petastorm_tpu_torch.sequence '
                'before stacking the time axis.'.format(name, offsets, shapes))
        if all(isinstance(c, torch.Tensor) for c in cols):
            out[name] = torch.stack(cols, dim=1)
        else:
            out[name] = np.stack(cols, axis=1)
    return out


def make_torch_dataset(reader, batch_size, **loader_kwargs):
    """An iterator of batches: :class:`TorchDataLoader` over ``reader`` (the
    twin of ``make_jax_dataset``)."""
    return iter(TorchDataLoader(reader, batch_size, **loader_kwargs))
