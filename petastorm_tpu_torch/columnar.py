"""Column blocks and the columnar results reader / loader buffers.

Trimmed twin of ``petastorm_tpu/columnar.py`` (plus its
``BatchResultsQueueReader`` from ``batch_worker.py``). A *column block* is a
plain dict ``{field_name: column}``, each column holding one decoded value per
row: a numpy array with a leading row axis, or a 1-D object array for ragged
or non-numeric cells. Workers publish blocks; the loader slices batches out of
them with numpy, so rows never become Python objects on the hot path.

The buffers draw from ``np.random.default_rng(seed)`` exactly as the JAX
package's do, so a seed gives the same batches in both packages. For
checkpoints the results readers report each item delivered as its last row
leaves (``delivered_callback``), and the loader's buffers give their rows back
as plain row dicts (``snapshot_rows``) and their RNG state (``rng_state``).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pyarrow as pa


def column_cells(column):
    """ChunkedArray -> list of per-row cell values; binary cells are
    zero-copy memoryview slices of the Arrow data buffer."""
    t = column.type
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        out = []
        for chunk in column.chunks:
            n = len(chunk)
            if n == 0:
                continue
            if chunk.null_count:
                out.extend(chunk.to_pylist())
                continue
            off_dtype = np.int64 if pa.types.is_large_binary(t) else np.int32
            _, offsets_buf, data_buf = chunk.buffers()
            offs = np.frombuffer(offsets_buf, dtype=off_dtype, count=n + 1,
                                 offset=chunk.offset * np.dtype(off_dtype).itemsize).tolist()
            mv = memoryview(data_buf)
            out.extend(mv[offs[i]:offs[i + 1]] for i in range(n))
        return out
    return column.to_pylist()


def _object_column(values):
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def stack_cells(values):
    """List of decoded cells -> one block column: a stacked ``[N, ...]`` array
    when every cell is an array of one shape/dtype (or a numeric scalar), else
    a 1-D object array preserving each cell."""
    if not values:
        return np.empty(0, dtype=object)
    v0 = values[0]
    if isinstance(v0, np.ndarray) and v0.ndim > 0:
        shape, dtype = v0.shape, v0.dtype
        if dtype == object or not all(isinstance(v, np.ndarray) and v.shape == shape
                                      and v.dtype == dtype for v in values):
            return _object_column(values)
        return np.stack(values)
    if isinstance(v0, (np.bool_, np.number)) or type(v0) in (int, float, bool):
        try:
            return np.array(values)
        except ValueError:
            return _object_column(values)
    return _object_column(values)


def block_num_rows(block):
    return len(next(iter(block.values()))) if block else 0


def block_to_rows(block):
    """Explode a block into per-row dicts (row transforms operate on rows)."""
    names = list(block)
    cols = [block[name] for name in names]
    n = len(cols[0]) if cols else 0
    return [dict(zip(names, (c[i] for c in cols))) for i in range(n)]


def rows_to_block(rows):
    """Re-collate row dicts into a block (after a per-row transform)."""
    return {name: stack_cells([r[name] for r in rows]) for name in rows[0]}


def take_block(block, indices):
    """Select rows of every column (numpy fancy indexing; object columns too)."""
    return {name: col[indices] for name, col in block.items()}


def concat_columns(parts):
    """Concatenate per-segment arrays of one logical column; mixed layouts
    degrade to one object column."""
    if len(parts) == 1:
        return parts[0]
    if (len({p.ndim for p in parts}) == 1 and len({p.shape[1:] for p in parts}) == 1
            and len({p.dtype == object for p in parts}) == 1):
        return np.concatenate(parts)
    rows = []
    for p in parts:
        rows.extend(p[i] for i in range(len(p)))
    return _object_column(rows)


def concat_blocks(blocks):
    """Concatenate blocks row-wise (all blocks share one field set)."""
    if len(blocks) == 1:
        return blocks[0]
    return {name: concat_columns([b[name] for b in blocks]) for name in blocks[0]}


class BlockResultsReaderBase(object):
    """Consumer side of a pool that publishes one block per item: one
    payload per ``read_next``. An item counts as delivered the moment its
    payload is returned; an item that published nothing is delivered by the
    pool's completion (``on_item_done``). Subclasses convert the payload."""

    batched_output = True

    def __init__(self, schema):
        self._schema = schema
        self.delivered_callback = None

    def on_item_done(self, seq):
        if self.delivered_callback is not None:
            self.delivered_callback(seq)

    def _convert(self, payload):
        return payload

    def read_next(self, pool):
        payload = pool.get_results()
        seq = getattr(pool, 'last_result_seq', None)
        if seq is not None and self.delivered_callback is not None:
            self.delivered_callback(seq)
        return self._convert(payload)


class BatchResultsQueueReader(BlockResultsReaderBase):
    """Consumer side of ``make_reader(output='columnar')`` and
    ``make_batch_reader``: one namedtuple of column arrays per published
    block."""

    def _convert(self, payload):
        return self._schema.make_namedtuple(**payload)


class BatchingColumnQueue(object):
    """FIFO of column blocks re-chunked to a fixed row count: the one block
    buffer behind ``make_batch_reader(batch_size=)`` rebatching
    (``rebatch.RebatchingResultsQueueReader``) and the loader's
    :class:`FifoColumnarBuffer`. Input row order is kept; blocks are buffered
    as views and concatenated only where a batch crosses a block boundary.
    A block may carry a ``tag``, returned by :meth:`pop_drained_tags` once
    all its rows have left (checkpoint bookkeeping)."""

    def __init__(self, batch_size):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1, got {}'.format(batch_size))
        self._batch_size = batch_size
        self._segments = deque()  # (block, tag)
        self._head = 0  # rows of the head segment already taken
        self._buffered = 0
        self._drained_tags = []

    def __len__(self):
        return self._buffered

    def put(self, batch, tag=None):
        lengths = {len(v) for v in batch.values()}
        if len(lengths) != 1:
            raise ValueError('ragged batch: column lengths {}'.format(sorted(lengths)))
        n = lengths.pop()
        if n == 0:
            if tag is not None:
                self._drained_tags.append(tag)
            return
        self._segments.append((batch, tag))
        self._buffered += n

    def pop_drained_tags(self):
        """Tags of the blocks whose rows have all been taken since the last call."""
        tags, self._drained_tags = self._drained_tags, []
        return tags

    def empty(self):
        """True when a full ``batch_size`` batch cannot be taken yet."""
        return self._buffered < self._batch_size

    def get(self):
        if self.empty():
            raise ValueError('{} rows buffered, fewer than batch_size {}'.format(
                self._buffered, self._batch_size))
        return self.take(self._batch_size)

    def drain(self):
        """All remaining rows as one final (possibly short) batch, or None."""
        if self._buffered == 0:
            return None
        return self.take(self._buffered)

    def take(self, count):
        parts = []
        taken = 0
        while taken < count:
            head, tag = self._segments[0]
            head_len = block_num_rows(head)
            take = min(count - taken, head_len - self._head)
            parts.append({k: v[self._head:self._head + take] for k, v in head.items()})
            self._head += take
            taken += take
            if self._head == head_len:
                self._segments.popleft()
                self._head = 0
                if tag is not None:
                    self._drained_tags.append(tag)
        self._buffered -= count
        return concat_blocks(parts)

    def clear(self):
        self._segments.clear()
        self._head = 0
        self._buffered = 0
        self._drained_tags = []

    def snapshot_rows(self):
        """The buffered rows as plain row dicts, in order (loader checkpoints)."""
        rows = []
        for i, (seg, _) in enumerate(self._segments):
            cols = list(seg.items())
            for r in range(self._head if i == 0 else 0, block_num_rows(seg)):
                rows.append({k: v[r] for k, v in cols})
        return rows


class FifoColumnarBuffer(object):
    """The loader's FIFO of column blocks with fixed-size batch extraction
    (no shuffling): a facade over :class:`BatchingColumnQueue`."""

    def __init__(self):
        self._q = BatchingColumnQueue(1)

    @property
    def size(self):
        return len(self._q)

    def add_block(self, block):
        self._q.put(block)

    def can_emit(self, batch_size):
        return len(self._q) >= batch_size

    def emit(self, count):
        return self._q.take(count)

    def finish(self):
        pass

    def clear(self):
        self._q.clear()

    def snapshot_rows(self):
        return self._q.snapshot_rows()


class ShuffledColumnarBuffer(object):
    """Columnar decorrelation buffer: buffered blocks stay intact and a
    permutation of ``(segment, row)`` indices decides the emit order. A batch
    is gathered segment by segment into one fresh allocation: one copy per
    emitted row. ``min_after`` rows stay buffered until :meth:`finish`."""

    def __init__(self, capacity, min_after, seed=None):
        if min_after >= capacity:
            raise ValueError('min_after ({}) must be smaller than capacity ({})'.format(
                min_after, capacity))
        self._capacity = capacity
        self._min_after = min_after
        self._rng = np.random.default_rng(seed)
        self._segments = {}       # seg_id -> block
        self._seg_remaining = {}  # seg_id -> rows not yet emitted
        self._next_seg = 0
        self._order_seg = np.empty(0, dtype=np.int64)
        self._order_row = np.empty(0, dtype=np.int64)
        self._cursor = 0
        self._staged_ids = []     # seg ids not yet folded into the permutation
        self._staged_rows = 0
        self._done = False

    @property
    def size(self):
        return (len(self._order_seg) - self._cursor) + self._staged_rows

    @property
    def rng_state(self):
        """The RNG's picklable state, for loader checkpoints."""
        return self._rng.bit_generator.state

    @rng_state.setter
    def rng_state(self, state):
        self._rng.bit_generator.state = state

    def resize(self, capacity, min_after):
        """Set the capacity and the decorrelation floor at run time (the
        autotuner's shuffle knob). Buffered rows are kept; :meth:`can_emit`
        follows the new bounds from its next call."""
        if min_after >= capacity:
            raise ValueError('min_after ({}) must be smaller than capacity ({})'.format(
                min_after, capacity))
        self._capacity = capacity
        self._min_after = min_after

    def add_block(self, block):
        n = block_num_rows(block)
        if not n:
            return
        sid = self._next_seg
        self._next_seg += 1
        self._segments[sid] = block
        self._seg_remaining[sid] = n
        self._staged_ids.append(sid)
        self._staged_rows += n

    def can_emit(self, batch_size):
        if self._done:
            return self.size > 0
        return self.size - batch_size >= self._min_after

    def emit(self, count):
        count = min(count, self.size)
        if len(self._order_seg) - self._cursor < count:
            self._fold_staged()
        sel_seg = self._order_seg[self._cursor:self._cursor + count]
        sel_row = self._order_row[self._cursor:self._cursor + count]
        self._cursor += count
        plan = []  # (segment block, row indices), shared by all columns
        for sid in np.unique(sel_seg):
            rows = sel_row[sel_seg == sid]
            plan.append((self._segments[sid], rows))
            self._seg_remaining[sid] -= len(rows)
            if self._seg_remaining[sid] == 0:
                del self._segments[sid]
                del self._seg_remaining[sid]
        out = {}
        first = plan[0][0]
        for name in first:
            col0 = first[name]
            uniform = (isinstance(col0, np.ndarray) and col0.dtype != object and all(
                isinstance(seg[name], np.ndarray) and seg[name].dtype == col0.dtype
                and seg[name].shape[1:] == col0.shape[1:] for seg, _ in plan))
            if not uniform:
                parts = [seg[name][rows] for seg, rows in plan]
                out[name] = parts[0] if len(parts) == 1 else concat_columns(parts)
                continue
            # one gather straight into the batch allocation: wide rows
            # (images) copy faster one memcpy per row than through np.take
            out_col = np.empty((count,) + col0.shape[1:], col0.dtype)
            wide = col0[:1].nbytes >= 4096
            pos = 0
            for seg, rows in plan:
                src = seg[name]
                if wide:
                    for row in rows:
                        out_col[pos] = src[row]
                        pos += 1
                else:
                    np.take(src, rows, axis=0, out=out_col[pos:pos + len(rows)])
                    pos += len(rows)
            out[name] = out_col
        return out

    def _fold_staged(self):
        """Fold staged segments into a fresh permutation together with every
        not-yet-emitted index (index arrays only, no row data is touched)."""
        segs = [self._order_seg[self._cursor:]]
        rows = [self._order_row[self._cursor:]]
        for sid in self._staged_ids:
            n = self._seg_remaining[sid]
            segs.append(np.full(n, sid, dtype=np.int64))
            rows.append(np.arange(n, dtype=np.int64))
        all_seg = np.concatenate(segs)
        all_row = np.concatenate(rows)
        perm = self._rng.permutation(len(all_seg))
        self._order_seg = all_seg[perm]
        self._order_row = all_row[perm]
        self._cursor = 0
        self._staged_ids = []
        self._staged_rows = 0

    def finish(self):
        self._done = True

    def clear(self):
        self._segments = {}
        self._seg_remaining = {}
        self._order_seg = np.empty(0, dtype=np.int64)
        self._order_row = np.empty(0, dtype=np.int64)
        self._cursor = 0
        self._staged_ids = []
        self._staged_rows = 0

    def snapshot_rows(self):
        """The rows not yet emitted as plain row dicts: the permuted ones in
        emit order, then the staged ones (loader checkpoints)."""
        pending = list(zip(self._order_seg[self._cursor:], self._order_row[self._cursor:]))
        for sid in self._staged_ids:
            pending.extend((sid, r) for r in range(self._seg_remaining[sid]))
        return [{k: v[r] for k, v in self._segments[sid].items()} for sid, r in pending]
