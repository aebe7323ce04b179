"""Row-group decode worker: loads ONE row group per task, decodes by column.

Trimmed twin of ``RowGroupDecoderWorker.process`` in
``petastorm_tpu/row_worker.py``. Each task opens its file through
:func:`~petastorm_tpu_torch.native.open_parquet` (the native reader for a
local file, else ``pyarrow.parquet``) and serves the row group's columns in
the JAX package's order: first the columns the fused native read decodes in
one call (:meth:`NativeParquetFile.read_fused`), adopted as they are; then
the rest through ``read_row_group``, which gives page-scan views where it can
and Arrow C++ for the others, each decoded through its codec: image codecs
take the decode hints and the resize target of the ``TransformSpec``
(``decode_column``, then ``decode_batch``), other codecs their whole-column
``decode_column``, and per-cell ``decode`` + stack when that declines. The
decoded block goes through the reader's cache (keyed by piece, columns,
decode hints and resize target), then the optional transform runs and one
column block is published.

In a process pool on the shm transport the publish function offers
``reserve_block``: with no transform and no cache (the JAX package's gate;
predicates and NGram windows are not ported), the whole row group is then
decoded by the fused native call straight into the ring slot the consumer
maps, page-scan columns included, and published with a header write
(:meth:`RowGroupDecoderWorker._publish_fused_inplace`). Not ported yet:
predicates, NGram windows, shuffle-row-drop partitions and the serve plane's
fused blob publish.
"""

from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.columnar import (block_num_rows, block_to_rows, column_cells,
                                          rows_to_block, stack_cells)
from petastorm_tpu_torch.native import open_parquet, read_routes
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


class RowGroupDecoderWorker(WorkerBase):
    """``args``: dataset_path, pieces, schema (full stored schema),
    output_schema (post column selection, pre transform), transform_spec,
    transformed_schema, filesystem, cache."""

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

    def process(self, piece_index):
        args = self.args
        piece = args['pieces'][piece_index]
        names = list(args['output_schema'].fields)
        transform = args['transform_spec']
        if (transform is None and isinstance(args['cache'], NullCache)
                and self._publish_fused_inplace(piece, names)):
            # the batch was decoded into the ring slot the consumer maps
            return
        decode_hints = getattr(transform, 'image_decode_hints', None) or {}
        resize_hints = getattr(transform, 'image_resize', None) or {}
        key = _cache_key(args['dataset_path'], piece, names, decode_hints, resize_hints)
        # the cache holds decoded (and resized) blocks, taken before the
        # transform, which runs on every pass
        block = args['cache'].get(key, lambda: self._load_block(
            piece, names, decode_hints, resize_hints,
            writable=transform is not None and transform.func is not None))
        if transform is not None:
            block = self._apply_transform(block, transform)
        if block and block_num_rows(block):
            self.publish(block)

    def _fused_columns(self, piece, names, decode_hints, resize_hints):
        """``{name: decoded column}`` of the columns the fused native read
        serves in one call; ``{}`` when none qualifies, on the pyarrow route,
        or when the native read fails (the other routes then serve them all).
        Columns the page scan serves as views stay with it."""
        pf = self._parquet_file(piece.path)
        if not hasattr(pf, 'read_fused'):
            return {}
        try:
            block, _rest = pf.read_fused(piece.row_group, names, self.args['schema'].fields,
                                         decode_hints, resize_hints)
        except Exception:  # noqa: BLE001 - any surprise: the Arrow route serves it all
            logger.warning('fused read of %s rg=%s failed; Arrow route', piece.path,
                           piece.row_group, exc_info=True)
            return {}
        return block

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
        read_routes.add('fused_columns_total', len(plan.columns))
        read_routes.add('fused_batches_total')
        read_routes.add('fused_inplace_batches_total')
        return True

    def _load_block(self, piece, names, decode_hints, resize_hints, writable):
        pre = self._fused_columns(piece, names, decode_hints, resize_hints)
        rest = [name for name in names if name not in pre]
        table = (self._parquet_file(piece.path).read_row_group(piece.row_group, columns=rest)
                 if rest else None)
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

    def _apply_transform(self, block, transform):
        """Row transforms get per-row dicts; ``batched=True`` transforms get
        the column block itself."""
        final_fields = set(self.args['transformed_schema'].fields)
        if transform.func is None:
            return {k: v for k, v in block.items() if k in final_fields}
        if transform.batched:
            return {k: v for k, v in transform.func(dict(block)).items() if k in final_fields}
        rows = [transform.func(r) for r in block_to_rows(block)]
        rows = [{k: v for k, v in r.items() if k in final_fields} for r in rows]
        return rows_to_block(rows) if rows else None


class RowResultsQueueReader(object):
    """Consumer side of ``make_reader(output='rows')``: slices schema
    namedtuples out of published column blocks, one row per ``read_next``."""

    batched_output = False

    def __init__(self, schema):
        self._namedtuple = schema.namedtuple
        self._field_order = list(schema.fields)
        self._cols = None
        self._n = 0
        self._i = 0

    def read_next(self, pool):
        while self._cols is None:
            block = pool.get_results()  # raises EmptyResultError at the end
            n = block_num_rows(block)
            if n:
                self._cols = [block[name] for name in self._field_order]
                self._n, self._i = n, 0
        row = self._namedtuple(*[col[self._i] for col in self._cols])
        self._i += 1
        if self._i == self._n:
            self._cols = None
        return row
