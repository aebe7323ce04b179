"""Columnar worker of ``make_batch_reader``: one row group -> one column block.

Twin of ``ArrowBatchWorker`` in ``petastorm_tpu/batch_worker.py``. It reads
RAW columns, with no codec decode (an encoded image stays bytes): the
columns the fused native read serves with no schema (plain fixed-width
numeric columns) come from one call, the rest through ``read_row_group``
(page-scan views or Arrow C++), each turned into numpy by
:func:`_column_to_numpy` with the JAX package's conversions. A work item may
carry a predicate, evaluated by the fused native call where its clauses
allow and on the column block otherwise, and a shuffle-row-drop partition
(Arrow ``take``). The ``TransformSpec``'s ``func`` runs on the whole column
block.

Telemetry, as the JAX worker: ``read`` (the Arrow read), ``decode`` (the
columns to numpy) and ``transform`` stages, and
``worker_rows_decoded_total``. Its consumer side,
:class:`~petastorm_tpu_torch.columnar.BatchResultsQueueReader`, lives in
``columnar.py`` beside the row path's and is importable from here too, as
in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.columnar import BatchResultsQueueReader  # noqa: F401 - the JAX name
from petastorm_tpu_torch.native import open_parquet
from petastorm_tpu_torch.predicates import evaluate_predicate_mask
from petastorm_tpu_torch.row_worker import _MAX_OPEN_FILES, _cache_key, select_row_drop_indices
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)


def _column_to_numpy(column):
    """``pyarrow.ChunkedArray`` -> numpy, as the JAX package converts: a
    ``list`` column goes through ``to_pylist`` (so integers come out int64)
    and stacks to 2-D when every row has one length, else an object column
    of arrays (``None`` kept); strings become a unicode array (an object one
    when a cell is null); binary and decimal cells object arrays;
    timestamps and dates through pandas; everything else ``to_numpy``."""
    t = column.type
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        values = column.to_pylist()
        lengths = {len(v) for v in values if v is not None}
        if len(lengths) == 1 and None not in values:
            return np.asarray(values)
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = None if v is None else np.asarray(v)
        return out
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        values = column.to_pylist()
        if any(v is None for v in values):
            out = np.empty(len(values), dtype=object)
            out[:] = values
            return out
        return np.asarray(values, dtype=np.str_)
    if pa.types.is_binary(t) or pa.types.is_large_binary(t) or pa.types.is_decimal(t):
        return np.asarray(column.to_pylist(), dtype=object)
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        return column.to_pandas().to_numpy()
    return column.to_numpy(zero_copy_only=False)


class ArrowBatchWorker(WorkerBase):
    """``args``: dataset_path, filesystem_factory (a picklable zero-argument
    callable; the filesystem is made on first use, in the worker's process),
    pieces, schema (stored or inferred), output_schema, transform_spec,
    transformed_schema, cache, chunk_cache (a ``ChunkCacheConfig`` for a
    remote store, or None)."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._fs = None
        self._open_files = {}

    def _parquet_file(self, path):
        if self._fs is None:
            self._fs = self.args['filesystem_factory']()
        if path not in self._open_files:
            if len(self._open_files) >= _MAX_OPEN_FILES:
                _, old = self._open_files.popitem()
                old.close()
            self._open_files[path] = open_parquet(path, self._fs,
                                                  chunk_cache=self.args.get('chunk_cache'))
        return self._open_files[path]

    def shutdown(self):
        for pf in self._open_files.values():
            pf.close()
        self._open_files = {}

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=None):
        args = self.args
        piece = args['pieces'][piece_index]
        needed = list(args['output_schema'].fields)
        if worker_predicate is None and shuffle_row_drop_partition is None:
            key = _cache_key(args['dataset_path'], piece, needed)
            batch = args['cache'].get(key, lambda: self._load_batch(piece, needed, None))
        else:
            batch = None
            fused_served = False
            if worker_predicate is not None and shuffle_row_drop_partition is None:
                fast = self._load_batch_with_predicate(piece, needed, worker_predicate)
                if fast is not None:
                    batch = fast or None  # {}: no row survived
                    fused_served = True
            if not fused_served:
                # the predicate's columns are read even when not selected
                load_cols = needed
                if worker_predicate is not None:
                    load_cols = sorted(set(needed) | set(worker_predicate.get_fields()))
                batch = self._load_batch(piece, load_cols, shuffle_row_drop_partition)
                if worker_predicate is not None:
                    batch = self._apply_predicate(batch, worker_predicate)
                    if batch is not None:
                        batch = {k: v for k, v in batch.items() if k in needed}
        if not batch or len(next(iter(batch.values()))) == 0:
            return
        transform = args['transform_spec']
        if transform is not None:
            if transform.func is not None:
                with obs.stage('transform', cat='worker'):
                    batch = transform.func(batch)
            final_fields = set(args['transformed_schema'].fields)
            batch = {k: v for k, v in batch.items() if k in final_fields}
        obs.count('worker_rows_decoded_total', len(next(iter(batch.values()))) if batch else 0)
        self.publish(batch)

    def _load_batch(self, piece, column_names, shuffle_row_drop_partition):
        schema = self.args['schema']
        physical = [c for c in column_names if c not in piece.partition_keys and c in schema.fields]
        pf = self._parquet_file(piece.path)
        # a whole row group serves the plain fixed-width numeric columns
        # through the fused read (no schema: raw columns, no codec decode)
        # and Arrow only the rest; a row subset needs Arrow's take
        pre = {}
        if shuffle_row_drop_partition is None and physical and hasattr(pf, 'read_fused'):
            try:
                pre, _rest = pf.read_fused(piece.row_group, physical, None)
            except Exception:  # noqa: BLE001 - any surprise: the Arrow route serves it all
                logger.warning('fused read of %s rg=%s failed; Arrow route', piece.path,
                               piece.row_group, exc_info=True)
                pre = {}
        rest = [c for c in physical if c not in pre]
        if rest or not pre:
            with obs.stage('read', cat='worker', piece=piece.path, row_group=piece.row_group):
                table = pf.read_row_group(piece.row_group, columns=rest)
                if shuffle_row_drop_partition is not None:
                    table = table.take(select_row_drop_indices(table.num_rows,
                                                               shuffle_row_drop_partition))
            num_rows = table.num_rows
        else:
            table = None
            num_rows = len(next(iter(pre.values())))
        with obs.stage('decode', cat='worker', rows=num_rows):
            batch = {name: pre[name] if name in pre else _column_to_numpy(table.column(name))
                     for name in physical}
        for key, value in piece.partition_keys.items():
            if key in column_names:
                batch[key] = np.full(num_rows, value)
        return batch

    def _load_batch_with_predicate(self, piece, needed, predicate):
        """The fused predicate pushdown for raw columns: clauses, page-stat
        skipping and the selected rows' collation in one GIL-released call,
        Arrow serving only the columns it cannot, taken at the surviving rows.
        The filtered block (``{}`` when no row survives), or None when the
        predicate or its columns cannot be evaluated natively: the caller
        then filters the column block in Python."""
        pf = self._parquet_file(piece.path)
        if not hasattr(pf, 'read_fused_predicate'):
            return None
        clauses = getattr(predicate, 'native_clauses', lambda: None)()
        if clauses is None:
            return None
        schema = self.args['schema']
        pred_fields = sorted(predicate.get_fields())
        if any(f in piece.partition_keys or f not in schema.fields for f in pred_fields):
            return None
        physical = [c for c in needed if c not in piece.partition_keys and c in schema.fields]
        if not physical:
            return None
        try:
            res = pf.read_fused_predicate(piece.row_group, physical, pred_fields, clauses, None)
        except Exception:  # noqa: BLE001 - any surprise: the Python route serves it
            logger.warning('fused predicate read of %s rg=%s failed; Python route', piece.path,
                           piece.row_group, exc_info=True)
            return None
        if res is None:
            return None
        block, rest, sel_mask, _n_selected, _pages_skipped = res
        kept = np.flatnonzero(sel_mask)
        if not len(kept):
            return {}
        batch = dict(block)
        if rest:
            with obs.stage('read', cat='worker', piece=piece.path, row_group=piece.row_group):
                table = pf.read_row_group(piece.row_group, columns=rest).take(kept)
            with obs.stage('decode', cat='worker', rows=len(kept)):
                for name in rest:
                    batch[name] = _column_to_numpy(table.column(name))
        for key, value in piece.partition_keys.items():
            if key in needed:
                batch[key] = np.full(len(kept), value)
        return batch

    @staticmethod
    def _apply_predicate(batch, predicate):
        """The rows ``predicate`` keeps: its vectorised mask where it has
        one, else ``do_include`` row by row over the predicate's columns.
        None when no row is kept."""
        fields = sorted(predicate.get_fields())
        missing = [f for f in fields if f not in batch]
        if missing:
            raise ValueError('Predicate fields {} not available in batch columns {}'.format(
                missing, sorted(batch)))
        n = len(next(iter(batch.values())))
        mask = evaluate_predicate_mask(predicate, {f: batch[f] for f in fields}, n)
        if mask is None:
            mask = np.empty(n, dtype=bool)
            for i in range(n):
                mask[i] = predicate.do_include({f: batch[f][i] for f in fields})
        if not mask.any():
            return None
        return {k: v[mask] for k, v in batch.items()}
