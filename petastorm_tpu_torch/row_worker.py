"""Row-group decode worker: loads ONE row group per task, decodes by column.

Twin of ``RowGroupDecoderWorker.process`` in ``petastorm_tpu/row_worker.py``.
Each task opens its file through :func:`~petastorm_tpu_torch.native.open_parquet`
(the native reader for a local file, else ``pyarrow.parquet``) and serves the
row group's columns in the JAX package's order: first the columns the fused
native read decodes in one call (:meth:`NativeParquetFile.read_fused`),
adopted as they are; then the rest through ``read_row_group``, which gives
page-scan views where it can and Arrow C++ for the others, each decoded
through its codec: image codecs take the decode hints and the resize target
of the ``TransformSpec`` (``decode_column``, then ``decode_batch``), other
codecs their whole-column ``decode_column``, and per-cell ``decode`` + stack
when that declines. The decoded block goes through the reader's cache (keyed
by piece, columns, decode hints and resize target), then the optional
transform runs and one column block is published.

A work item may carry a predicate (``worker_predicate``) and a
shuffle-row-drop partition (``shuffle_row_drop_partition``). With a
predicate, the fused native read evaluates it, skips pages by their
statistics and decodes only the surviving rows in one call
(:meth:`RowGroupDecoderWorker._fused_predicate_block`); where it cannot, the
predicate columns are read and decoded first, the mask evaluated, and the
other columns read for the surviving rows only (Arrow ``take``). A partition
keeps one of ``n`` contiguous slices of the row group's rows. Filtered and
divided items bypass the cache and the in-place publish; an item that keeps
no row publishes nothing.

In a process pool on the shm transport the publish function offers
``reserve_block``: with no transform, no cache, no predicate, no partition
and no NGram (the JAX package's gate), the whole row group is then decoded
by the fused native call straight into the ring slot the consumer maps,
page-scan columns included, and published with a header write
(:meth:`RowGroupDecoderWorker._publish_fused_inplace`). Under the serve
daemon the publish function offers ``reserve_fused`` instead: behind the
same gate the fused call decodes the batch straight into a shared blob and
only its column layout is published
(:meth:`RowGroupDecoderWorker._publish_fused_blob`).

With an NGram (``args['ngram']``) the worker reads the fields every
timestep needs and publishes windows instead of the block: one nested
``{offset: {field: [W, ...]}}`` block from
:meth:`~petastorm_tpu_torch.ngram.NGram.form_ngram_columnar` for a columnar
reader (``args['columnar_ngram']``), else the list of window dicts of
:meth:`~petastorm_tpu_torch.ngram.NGram.form_ngram`. A row group with no
window publishes nothing. A shuffle-row-drop partition then spills over by
``length - 1`` rows, so no window at a partition boundary is lost.

Telemetry, as the JAX worker: a ``read`` stage around each Arrow/page-scan
read (the fused call is its own ``fused_decode``/``fused_predicate`` stage,
in ``native``), ``decode`` around the codec decode, ``transform`` around a
``TransformSpec`` function, and ``worker_rows_decoded_total``. One change:
a block whose columns the fused read decoded all has nothing left to
decode, so it opens no ``decode`` stage (the JAX worker opens an empty
one), and a fused path's stall report names ``fused_decode`` alone.
"""

from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict, deque

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.columnar import (BlockResultsReaderBase, block_num_rows, block_to_rows,
                                          column_cells, rows_to_block, stack_cells, take_block)
from petastorm_tpu_torch.native import count_route, open_parquet
from petastorm_tpu_torch.predicates import evaluate_predicate_mask
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)

_MAX_OPEN_FILES = 8


def _cache_key(dataset_path, piece, column_names, decode_hints=None, resize_hints=None):
    cols = ','.join(sorted(column_names))
    if decode_hints:
        # scaled-decode output differs per hint: readers with different hints
        # must not share cached decoded blocks
        cols += '|' + repr(sorted(decode_hints.items()))
    if resize_hints:
        # decode-time resize bakes the target size into the cached block
        cols += '|rsz' + repr(sorted(resize_hints.items()))
    cols = hashlib.md5(cols.encode()).hexdigest()[:8]
    # 'b1': the payloads are column blocks, as the JAX package's
    return '{}:{}:rg{}:b1:{}'.format(
        hashlib.md5(dataset_path.encode()).hexdigest(), piece.path, piece.row_group, cols)


def select_row_drop_indices(num_rows, partition_spec, ngram=None):
    """Row indices kept for one shuffle-row-drop partition.

    ``partition_spec`` is ``(partition_index, num_partitions)``. With an NGram,
    each partition spills over by ``length - 1`` rows so windows spanning the
    partition boundary are not lost.
    """
    if partition_spec is None:
        return np.arange(num_rows)
    part, n_parts = partition_spec
    chunks = np.array_split(np.arange(num_rows), n_parts)
    chunk = chunks[part]
    if ngram is not None and len(chunk) and chunk[-1] < num_rows - 1:
        spill = np.arange(chunk[-1] + 1, min(chunk[-1] + ngram.length, num_rows))
        chunk = np.concatenate([chunk, spill])
    return chunk


class RowGroupDecoderWorker(WorkerBase):
    """``args``: dataset_path, pieces, schema (full stored schema),
    output_schema (post column selection, pre transform), transform_spec,
    transformed_schema, filesystem, cache, ngram, columnar_ngram."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._open_files = OrderedDict()  # path -> NativeParquetFile or ParquetFile

    def _parquet_file(self, path):
        if path not in self._open_files:
            if len(self._open_files) >= _MAX_OPEN_FILES:
                _, old = self._open_files.popitem(last=False)
                old.close()
            self._open_files[path] = open_parquet(path, self.args['filesystem'])
        return self._open_files[path]

    def shutdown(self):
        for pf in self._open_files.values():
            pf.close()
        self._open_files.clear()

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=None):
        args = self.args
        piece = args['pieces'][piece_index]
        out_schema = args['output_schema']
        ngram = args.get('ngram')
        if ngram is not None:
            names = [n for n in ngram.get_field_names_at_all_timesteps() if n in out_schema.fields]
        else:
            names = list(out_schema.fields)
        transform = args['transform_spec']
        cache = args['cache']
        if worker_predicate is None and shuffle_row_drop_partition is None:
            # windows are assembled from the block: no in-place publish
            if (transform is None and ngram is None and isinstance(cache, NullCache)
                    and (self._publish_fused_blob(piece, names)
                         or self._publish_fused_inplace(piece, names))):
                # the batch was decoded straight into shared memory: the serve
                # daemon's blob, or the ring slot the consumer maps
                return
            key = _cache_key(args['dataset_path'], piece, names,
                             getattr(transform, 'image_decode_hints', None),
                             getattr(transform, 'image_resize', None))
            # the cache holds decoded (and resized) blocks, taken before the
            # transform, which runs on every pass
            block = cache.get(key, lambda: self._load_block(piece, names))
        elif worker_predicate is not None:
            block = self._load_block_with_predicate(piece, names, worker_predicate,
                                                    shuffle_row_drop_partition)
        else:
            block = self._load_block(piece, names, shuffle_row_drop_partition)
        if block is None or block_num_rows(block) == 0:
            return
        if transform is not None:
            block = self._apply_transform(block, transform)
        if not block or not block_num_rows(block):
            return
        if ngram is not None:
            self._publish_windows(ngram, block)
            return
        obs.count('worker_rows_decoded_total', block_num_rows(block))
        self.publish(block)

    def _publish_windows(self, ngram, block):
        """Publish the row group's windows: one nested block for a columnar
        reader, else the list of window dicts; nothing when none qualifies."""
        if self.args.get('columnar_ngram'):
            windows = ngram.form_ngram_columnar(block)
            if windows is not None:
                self.publish(windows)
            return
        windows = ngram.form_ngram(block_to_rows(block), self.args['transformed_schema'])
        if windows:
            self.publish(windows)

    def _fused_columns(self, piece, names):
        """``{name: decoded column}`` of the columns the fused native read
        serves in one call; ``{}`` when none qualifies, on the pyarrow route,
        or when the native read fails (the other routes then serve them all).
        Columns the page scan serves as views stay with it."""
        pf = self._parquet_file(piece.path)
        if not hasattr(pf, 'read_fused'):
            return {}
        transform = self.args.get('transform_spec')
        try:
            block, _rest = pf.read_fused(piece.row_group, names, self.args['schema'].fields,
                                         getattr(transform, 'image_decode_hints', None),
                                         getattr(transform, 'image_resize', None))
        except Exception:  # noqa: BLE001 - any surprise: the Arrow route serves it all
            logger.warning('fused read of %s rg=%s failed; Arrow route', piece.path,
                           piece.row_group, exc_info=True)
            return {}
        return block

    def _publish_fused_blob(self, piece, names):
        """The serve plane's zero-copy mode: when the publish function offers
        ``reserve_fused`` (the daemon's blob plane), run the fused decode
        straight into a shared blob mapping and publish only the column
        layout; the consumers view the mapping in place, so the batch is
        written once, by the decode, however many consumers attach. A blob
        is random access, so sizes need not be known ahead. Returns False,
        with no effect, when any precondition fails."""
        reserve = getattr(self.publish_func, 'reserve_fused', None)
        pf = self._parquet_file(piece.path) if reserve is not None else None
        if pf is None or not hasattr(pf, 'fused_plan'):
            return False
        schema = self.args['schema']
        if any(c in piece.partition_keys for c in names):
            return False  # partition columns would need a post-decode append
        physical = [c for c in names if c in schema.fields]
        if not physical or len(physical) != len(names):
            return False
        plan = pf.fused_plan(piece.row_group, physical, schema.fields, include_pagescan=True)
        if plan is None or plan.rest or not plan.columns:
            return False
        n = plan.expected_rows
        if n <= 0:
            return False
        offsets, total = [], 0
        for p in plan.columns:
            offsets.append(total)
            total += p.out_bound
        reserved = reserve(total, n)
        if reserved is None:
            return False
        view, finish, abort = reserved
        try:
            results = pf.fused_read_into(plan, view, offsets)
        except Exception:  # noqa: BLE001 - a kernel refusal: the copy path serves it
            logger.warning('fused blob read of %s rg=%s failed; copy path', piece.path,
                           piece.row_group, exc_info=True)
            abort()
            return False
        from petastorm_tpu_torch.native import fused
        cols = []
        for p, res, off in zip(plan.columns, results, offsets):
            region = fused.column_region(p, res, n)
            if region is None:
                abort()
                fused.count_fallbacks({p.name: fused.REASON_BY_STATUS.get(res[0],
                                                                         'post-validate')})
                return False
            dtype_str, shape, nbytes = region
            cols.append((p.name, dtype_str, shape, off, nbytes))
        finish(cols)
        count_route('fused_columns_total', len(plan.columns))
        count_route('fused_batches_total')
        count_route('serve_fused_blob_batches_total')
        obs.count('worker_rows_decoded_total', n)
        fused.count_fallbacks(plan.reasons)
        return True

    def _publish_fused_inplace(self, piece, names):
        """The shm ring's in-place mode: reserve the ring slot the consumer
        will map, write the serializer header first (every fused column's
        size is known ahead), run the fused decode into the slot, and
        publish with a header write: no copy of the batch between the
        Parquet pages and the consumer's numpy views. Returns False, with no
        effect, when any precondition fails; the caller then loads and
        publishes as usual."""
        reserve = getattr(self.publish_func, 'reserve_block', None)
        pf = self._parquet_file(piece.path) if reserve is not None else None
        if pf is None or not hasattr(pf, 'fused_plan'):
            return False
        plan = pf.fused_plan(piece.row_group, names, self.args['schema'].fields,
                             include_pagescan=True)
        if plan is None or plan.rest or not plan.inplace_ok:
            return False
        if any(p.field_dtype is not None and p.field_dtype != p.out_dtype
               for p in plan.columns):
            return False  # an astype after the decode would need a second buffer
        if plan.expected_rows <= 0:
            return False
        meta, offsets, total = [], [], 0
        for p in plan.columns:
            meta.append((p.name, p.out_dtype.str, p.out_shape, None))
            offsets.append(total)
            total += p.out_bound
        reserved = reserve(meta, total)
        if reserved is None:
            return False
        view, commit, abort = reserved
        try:
            results = pf.fused_read_into(plan, view, offsets)
        except Exception:  # noqa: BLE001 - any surprise: the copy path serves it
            logger.warning('in-place fused read of %s rg=%s failed; copy path', piece.path,
                           piece.row_group, exc_info=True)
            abort()
            return False
        from petastorm_tpu_torch.native import fused
        failed = {plan.columns[i].name: fused.REASON_BY_STATUS.get(r[0], 'internal')
                  for i, r in enumerate(results)
                  if r[0] != 0 or r[1] != plan.columns[i].out_bound}
        if failed:
            abort()
            fused.count_fallbacks(failed)
            return False
        commit(total)
        count_route('fused_columns_total', len(plan.columns))
        count_route('fused_batches_total')
        count_route('fused_inplace_batches_total')
        obs.count('worker_rows_decoded_total', plan.expected_rows)
        return True

    def _num_rows(self, piece):
        if piece.num_rows is not None:
            return piece.num_rows
        return self._parquet_file(piece.path).metadata.row_group(piece.row_group).num_rows

    def _read_table(self, piece, names, row_indices=None):
        """The named columns of the piece's row group as an Arrow table, only
        the rows ``row_indices`` when given."""
        pf = self._parquet_file(piece.path)
        with obs.stage('read', cat='worker', piece=piece.path, row_group=piece.row_group):
            table = pf.read_row_group(piece.row_group, columns=names)
            return table.take(row_indices) if row_indices is not None else table

    def _load_block(self, piece, names, shuffle_row_drop_partition=None):
        indices = None
        if shuffle_row_drop_partition is not None:
            indices = select_row_drop_indices(self._num_rows(piece), shuffle_row_drop_partition,
                                              self.args.get('ngram'))
        # a row subset needs Arrow's take; the whole row group serves fused
        # columns first and Arrow only the rest
        pre = self._fused_columns(piece, names) if indices is None else {}
        rest = [name for name in names if name not in pre]
        table = self._read_table(piece, rest, indices) if rest else None
        return self._decode_table(table, names, pre)

    def _decode_table(self, table, names, pre=None):
        """Arrow table -> column block. Columns the fused read decoded
        (``pre``) are adopted as they are; ``table`` may be None when ``pre``
        covers every column."""
        transform = self.args.get('transform_spec')
        decode_hints = getattr(transform, 'image_decode_hints', None) or {}
        resize_hints = getattr(transform, 'image_resize', None) or {}
        writable = transform is not None and transform.func is not None
        pre = pre or {}
        if all(name in pre for name in names):
            return {name: pre[name] for name in names}
        with obs.stage('decode', cat='worker', rows=table.num_rows):
            return self._decode_columns(table, names, pre, decode_hints, resize_hints, writable)

    def _decode_columns(self, table, names, pre, decode_hints, resize_hints, writable):
        schema = self.args['schema']
        block = {}
        for name in names:
            if name in pre:
                # fused columns are fresh writable views of the batch buffer
                block[name] = pre[name]
                continue
            field = schema.fields[name]
            codec = field.codec
            column = table.column(name)
            decoded = None
            if getattr(codec, 'decode_column_accepts_hints', False):
                decoded = codec.decode_column(field, column, min_size=decode_hints.get(name),
                                              resize=resize_hints.get(name))
            elif hasattr(codec, 'decode_column'):
                decoded = codec.decode_column(field, column)
            if decoded is None:
                cells = column_cells(column)
                hint, resize = decode_hints.get(name), resize_hints.get(name)
                if hasattr(codec, 'decode_batch'):
                    values = codec.decode_batch(field, cells, min_size=hint, resize=resize)
                else:
                    values = [None if v is None else codec.decode(field, v) for v in cells]
                decoded = stack_cells(values)
            elif writable and isinstance(decoded, np.ndarray) and not decoded.flags.writeable:
                # zero-copy decodes are read-only views of the Arrow buffer or
                # of the mmapped file; user transforms may mutate in place
                decoded = decoded.copy()
            block[name] = decoded
        return block

    def _fused_predicate_block(self, pf, piece, names, predicate_fields, predicate,
                               drop_indices):
        """Native predicate pushdown: clause evaluation, min/max page-stat
        skipping, row selection and the decode of ONLY the surviving rows run
        in one GIL-released fused call; Arrow reads just the columns the
        kernel cannot serve, their rows filtered by the same selection.
        Returns the decoded block (``{}`` when no row survives), or None when
        the predicate or its columns are not natively evaluable: the caller
        then takes the Python route."""
        if not hasattr(pf, 'read_fused_predicate'):
            return None
        clauses = getattr(predicate, 'native_clauses', lambda: None)()
        if clauses is None:
            return None
        schema = self.args['schema']
        if any(f in piece.partition_keys or f not in schema.fields for f in predicate_fields):
            return None
        transform = self.args.get('transform_spec')
        try:
            res = pf.read_fused_predicate(piece.row_group, names, predicate_fields, clauses,
                                          schema.fields,
                                          getattr(transform, 'image_decode_hints', None),
                                          getattr(transform, 'image_resize', None))
        except Exception:  # noqa: BLE001 - any surprise: the Python route serves it
            logger.warning('fused predicate read of %s rg=%s failed; Python route', piece.path,
                           piece.row_group, exc_info=True)
            return None
        if res is None:
            return None
        block, _rest, sel_mask, _n_selected, _pages_skipped = res
        kept_global = np.flatnonzero(sel_mask)
        if drop_indices is not None:
            # the kernel selected over the WHOLE row group: narrow the fused
            # block and the surviving rows' indices to this partition
            keep = np.isin(kept_global, drop_indices)
            block = take_block(block, np.flatnonzero(keep))
            kept_global = kept_global[keep]
        if not len(kept_global):
            return {}
        remaining = [name for name in names if name not in block]
        rem_block = (self._decode_table(self._read_table(piece, remaining, kept_global),
                                        remaining) if remaining else {})
        return {name: (block[name] if name in block else rem_block[name]) for name in names}

    def _load_block_with_predicate(self, piece, names, predicate, shuffle_row_drop_partition):
        """Predicate pushdown: the fused native route where it applies, else
        decode the predicate columns first, mask, leave early when no row
        survives, then read and decode the other columns for the surviving
        rows only."""
        predicate_fields = sorted(predicate.get_fields())
        schema = self.args['schema']
        unknown = [f for f in predicate_fields
                   if f not in schema.fields and f not in piece.partition_keys]
        if unknown:
            raise ValueError('Predicate fields {} are not in the dataset schema'.format(unknown))
        pf = self._parquet_file(piece.path)
        num_rows = self._num_rows(piece)
        drop_indices = select_row_drop_indices(num_rows, shuffle_row_drop_partition,
                                               self.args.get('ngram'))
        fast = self._fused_predicate_block(pf, piece, names, predicate_fields, predicate,
                                           drop_indices if shuffle_row_drop_partition else None)
        if fast is not None:
            return fast or None
        pred_table = self._read_table(piece, predicate_fields,
                                      drop_indices if shuffle_row_drop_partition else None)
        pred_block = self._decode_table(pred_table, predicate_fields)
        mask = evaluate_predicate_mask(predicate, dict(pred_block), block_num_rows(pred_block))
        if mask is None:  # no batch path: per-row semantics
            mask = [predicate.do_include(r) for r in block_to_rows(pred_block)]
        if not np.any(mask):
            return None
        kept_local = np.flatnonzero(mask)
        base = drop_indices if shuffle_row_drop_partition else np.arange(num_rows)
        kept_global = base[kept_local]
        remaining = [name for name in names if name not in predicate_fields]
        rem_block = (self._decode_table(self._read_table(piece, remaining, kept_global),
                                        remaining) if remaining else {})
        kept_pred = take_block(pred_block, kept_local)
        return {name: (kept_pred[name] if name in kept_pred else rem_block[name])
                for name in names if name in kept_pred or name in rem_block}

    def _apply_transform(self, block, transform):
        """Row transforms get per-row dicts; ``batched=True`` transforms get
        the column block itself."""
        final_fields = set(self.args['transformed_schema'].fields)
        if transform.func is None:
            return {k: v for k, v in block.items() if k in final_fields}
        with obs.stage('transform', cat='worker'):
            if transform.batched:
                return {k: v for k, v in transform.func(dict(block)).items()
                        if k in final_fields}
            rows = [transform.func(r) for r in block_to_rows(block)]
            rows = [{k: v for k, v in r.items() if k in final_fields} for r in rows]
        return rows_to_block(rows) if rows else None


class NgramBlockResultsQueueReader(BlockResultsReaderBase):
    """Consumer side of ``make_reader(output='columnar', ngram=...)``: one
    nested window block per published item, a plain dict
    ``offset -> {field: [W, ...]}`` (namedtuples cannot key on integer
    offsets, so there is no conversion). W varies per row group, as any
    columnar block's length does."""

    def __init__(self, schema, ngram):
        super().__init__(schema)
        self._ngram = ngram


class RowResultsQueueReader(object):
    """Consumer side of ``make_reader(output='rows')``: slices schema
    namedtuples out of published column blocks, one row per ``read_next``.
    An NGram reader receives lists of window dicts instead and yields one
    window (``offset -> namedtuple`` of that timestep's fields) per call.

    Checkpoints: the block being sliced (or each buffered window list)
    remembers the seq of the item it came from, and ``delivered_callback(seq)``
    fires when its last row is yielded, so a reader's state never counts a
    partly yielded row group as read."""

    batched_output = False

    def __init__(self, schema, ngram=None):
        self._schema = schema
        self._ngram = ngram
        self._namedtuple = schema.namedtuple if ngram is None else None
        self._field_order = list(schema.fields)
        self._cols = None
        self._n = 0
        self._i = 0
        self._seq = None
        # the NGram path: buffered windows and [seq, windows left] per list
        self._windows = deque()
        self._spans = deque()
        self.delivered_callback = None

    def on_item_done(self, seq):
        """The pool consumed the completion of ``seq``. A completion comes
        after its item's payloads, so that item's rows were all yielded
        already, or it published none: it is delivered either way."""
        if self.delivered_callback is not None:
            self.delivered_callback(seq)

    def read_next(self, pool):
        if self._ngram is not None:
            return self._read_next_window(pool)
        while self._cols is None:
            block = pool.get_results()  # raises EmptyResultError at the end
            n = block_num_rows(block)
            if n:
                self._cols = [block[name] for name in self._field_order]
                self._n, self._i = n, 0
                self._seq = getattr(pool, 'last_result_seq', None)
        row = self._namedtuple(*[col[self._i] for col in self._cols])
        self._i += 1
        if self._i == self._n:
            self._cols = None
            if self._seq is not None and self.delivered_callback is not None:
                self.delivered_callback(self._seq)
        return row

    def _read_next_window(self, pool):
        while not self._windows:
            windows = pool.get_results()
            self._windows.extend(windows)
            self._spans.append([getattr(pool, 'last_result_seq', None), len(windows)])
        window = self._windows.popleft()
        span = self._spans[0]
        span[1] -= 1
        if span[1] == 0:
            self._spans.popleft()
            if span[0] is not None and self.delivered_callback is not None:
                self.delivered_callback(span[0])
        return self._ngram.make_namedtuple(self._schema, window)
