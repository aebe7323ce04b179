"""The reference's ``petastorm.pytorch`` API: twin of
``petastorm_tpu/torch_utils.py``.

:class:`DataLoader` iterates a reader into batches of torch tensors with the
reference's behaviour: dtype sanitisation, a client-side shuffling buffer,
fixed-size collation, the partial final batch, ``stop``/``join`` and the
context manager. Like the JAX package's adapter it yields HOST tensors, and
the caller moves them to the card. The port's own loader,
:class:`~petastorm_tpu_torch.torch.TorchDataLoader`, stages onto the device
and checkpoints; this one keeps the reference's call signature, so code
written against ``petastorm.pytorch`` migrates unchanged.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import torch
from torch.utils.data._utils.collate import default_collate

from petastorm_tpu_torch.columnar import FifoColumnarBuffer, ShuffledColumnarBuffer
from petastorm_tpu_torch.shuffling_buffer import default_min_after, make_shuffling_buffer_factory
from petastorm_tpu_torch.torch.loader import _rows_from_columnar_batch, _sanitize_batch_columns

_TORCH_HOSTILE_PROMOTIONS = {
    np.dtype(np.uint16): np.int32,
    np.dtype(np.uint32): np.int64,
    np.dtype(np.uint64): np.int64,
}


def _sanitize_torch_types(row_dict):
    """Promote the dtypes torch cannot hold: unsigned 16/32/64-bit integers
    to signed ones, ``Decimal`` to float, ``datetime64`` to int64 ns ticks;
    a string or object array raises."""
    out = {}
    for name, value in row_dict.items():
        if isinstance(value, Decimal):
            value = float(value)
        elif isinstance(value, np.datetime64):
            value = value.astype('datetime64[ns]').astype(np.int64)
        elif isinstance(value, np.ndarray):
            if value.dtype in _TORCH_HOSTILE_PROMOTIONS:
                value = value.astype(_TORCH_HOSTILE_PROMOTIONS[value.dtype])
            elif value.dtype.kind in ('U', 'S', 'O'):
                raise TypeError(
                    'Field {!r} is a string/object array; torch tensors cannot hold it. '
                    'Exclude it via schema_fields or convert it in a TransformSpec.'.format(name))
        elif isinstance(value, np.generic) and value.dtype in _TORCH_HOSTILE_PROMOTIONS:
            value = value.astype(_TORCH_HOSTILE_PROMOTIONS[value.dtype])
        out[name] = value
    return out


def decimal_friendly_collate(batch):
    """``default_collate`` that also collates ``Decimal`` values (to
    float64)."""
    if isinstance(batch[0], Decimal):
        return torch.tensor([float(x) for x in batch], dtype=torch.float64)
    if isinstance(batch[0], dict):
        return {k: decimal_friendly_collate([b[k] for b in batch]) for k in batch[0]}
    return default_collate(batch)


def _collate_columns_to_torch(batch_columns):
    """A column block -> a dict of torch tensors, one ``from_numpy`` per
    column (the columnar counterpart of :func:`decimal_friendly_collate`).
    Datetime and Decimal columns go through the port loader's column
    sanitiser; a column torch cannot hold (strings, nullable anything)
    raises."""
    batch = _sanitize_batch_columns(dict(batch_columns))
    out = {}
    for name, col in batch.items():
        if not isinstance(col, np.ndarray):
            raise TypeError('Field {!r} is not a numpy column'.format(name))
        if col.dtype == object or col.dtype.kind in ('U', 'S'):
            raise TypeError(
                'Field {!r} is a string/object/nullable column; torch tensors cannot hold '
                'it. Exclude it via schema_fields or convert it in a '
                'TransformSpec.'.format(name))
        if col.dtype in _TORCH_HOSTILE_PROMOTIONS:
            col = col.astype(_TORCH_HOSTILE_PROMOTIONS[col.dtype])
        # torch.from_numpy needs writable memory: a read-only column copies
        out[name] = torch.from_numpy(np.require(col, requirements=['C', 'W']))
    return out


class DataLoader(object):
    """Iterates a reader, accumulates ``batch_size`` rows and collates them
    to torch tensors, through an optional client-side shuffling buffer.

    Columnar readers (``make_batch_reader``, ``make_reader(output='columnar')``)
    with the default collate take the block fast path: no Python per row,
    one ``torch.from_numpy`` per column. A custom ``collate_fn`` keeps the
    row path: its contract is a list of row dicts."""

    def __init__(self, reader, batch_size=1, collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, min_after_retrieve=None, seed=None):
        if reader.batched_output and getattr(reader, 'ngram', None) is not None:
            raise ValueError(
                'torch DataLoader does not support columnar NGram readers (nested window '
                "blocks); use make_reader(output='rows', ngram=...) here, or TorchDataLoader "
                'for the columnar window path.')
        self.reader = reader
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self._columnar = reader.batched_output and collate_fn is decimal_friendly_collate
        if self._columnar:
            if shuffling_queue_capacity > 0:
                floor = default_min_after(shuffling_queue_capacity, min_after_retrieve)
                self._make_buffer = lambda: ShuffledColumnarBuffer(
                    shuffling_queue_capacity, floor, seed)
            else:
                self._make_buffer = FifoColumnarBuffer
        else:
            self._make_buffer = make_shuffling_buffer_factory(
                shuffling_queue_capacity, min_after_retrieve, seed, batch_size,
                batched_reader=reader.batched_output)

    def __iter__(self):
        if self._columnar:
            yield from self._iter_columnar()
            return
        buffer = self._make_buffer()
        pending = []
        for item in self.reader:
            if self.reader.batched_output:
                buffer.add_many([_sanitize_torch_types(r)
                                 for r in _rows_from_columnar_batch(item)])
            else:
                buffer.add_many([_sanitize_torch_types(item._asdict())])
            while buffer.can_retrieve():
                pending.append(buffer.retrieve())
                if len(pending) == self.batch_size:
                    yield self.collate_fn(pending)
                    pending = []
        buffer.finish()
        while buffer.can_retrieve():
            pending.append(buffer.retrieve())
            if len(pending) == self.batch_size:
                yield self.collate_fn(pending)
                pending = []
        if pending:  # the partial final batch
            yield self.collate_fn(pending)

    def _iter_columnar(self):
        buffer = self._make_buffer()
        bs = self.batch_size
        for item in self.reader:
            buffer.add_block(dict(item._asdict()))
            while buffer.can_emit(bs):
                yield _collate_columns_to_torch(buffer.emit(bs))
        buffer.finish()
        while buffer.size >= bs:
            yield _collate_columns_to_torch(buffer.emit(bs))
        if buffer.size:  # the partial final batch
            yield _collate_columns_to_torch(buffer.emit(buffer.size))

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()
