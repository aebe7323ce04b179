"""Row-group decode worker: loads ONE row group per task, decodes by column.

Trimmed twin of ``RowGroupDecoderWorker.process`` in
``petastorm_tpu/row_worker.py``: the pyarrow path only. Each task reads one
row group with ``pyarrow.parquet``, decodes every column through its codec's
whole-column ``decode_column`` (per-cell ``decode`` + stack when that
declines), applies the optional transform and publishes one column block.
Not ported yet: the native fused decode, predicates, the row-group cache,
NGram windows and shuffle-row-drop partitions.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.columnar import (block_num_rows, block_to_rows, column_cells,
                                          rows_to_block, stack_cells)
from petastorm_tpu_torch.workers.worker_base import WorkerBase

_MAX_OPEN_FILES = 8


class RowGroupDecoderWorker(WorkerBase):
    """``args``: pieces, schema (full stored schema), output_schema
    (post column selection, pre transform), transform_spec,
    transformed_schema, filesystem."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._open_files = OrderedDict()  # path -> (input file, ParquetFile)

    def _parquet_file(self, path):
        if path not in self._open_files:
            if len(self._open_files) >= _MAX_OPEN_FILES:
                _, (handle, _pf) = self._open_files.popitem(last=False)
                handle.close()
            handle = self.args['filesystem'].open_input_file(path)
            self._open_files[path] = (handle, pq.ParquetFile(handle))
        return self._open_files[path][1]

    def shutdown(self):
        for handle, _pf in self._open_files.values():
            handle.close()
        self._open_files.clear()

    def process(self, piece_index):
        piece = self.args['pieces'][piece_index]
        names = list(self.args['output_schema'].fields)
        table = self._parquet_file(piece.path).read_row_group(piece.row_group, columns=names)
        transform = self.args['transform_spec']
        block = self._decode_table(table, names, writable=transform is not None
                                   and transform.func is not None)
        if transform is not None:
            block = self._apply_transform(block, transform)
        if block and block_num_rows(block):
            self.publish(block)

    def _decode_table(self, table, names, writable):
        schema = self.args['schema']
        block = {}
        for name in names:
            field = schema.fields[name]
            codec = field.codec
            column = table.column(name)
            decoded = codec.decode_column(field, column) if hasattr(codec, 'decode_column') else None
            if decoded is None:
                cells = column_cells(column)
                decoded = stack_cells([None if v is None else codec.decode(field, v) for v in cells])
            elif writable and isinstance(decoded, np.ndarray) and not decoded.flags.writeable:
                # zero-copy decodes may be read-only views of the Arrow
                # buffer; user transforms may mutate in place
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
