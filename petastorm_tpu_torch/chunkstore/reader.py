"""Chunk-cached Parquet file: the remote-store face of the zero-copy page
scan and the fused read.

Twin of ``petastorm_tpu/chunkstore/reader.py``. :class:`ChunkCachedParquetFile`
presents the surface the workers consume from ``native.open_parquet``
(``read_row_group(i, columns)`` -> ``pyarrow.Table``, the fused calls,
``metadata``, ``close``) over a REMOTE ``pyarrow.fs`` filesystem (the
retry-wrapped ones of ``fs.py``/``retry.py`` included):

* the footer is fetched once and kept in the chunk store, so a warm cache
  opens a file with one ``get_file_info`` round trip;
* every column chunk the page scan qualifies (the local path's strict check,
  ``pagescan.column_qualifies``) is mirrored byte for byte into the local
  chunk store and served as zero-copy Arrow views over the mirror's mapping
  (``pagescan.read_mirrored_chunk``);
* every chunk the fused read qualifies (dictionary, RLE, snappy, PNG images)
  is mirrored too and decoded by the fused native call from the mirror
  (:meth:`read_fused`, :meth:`read_fused_predicate`, and
  :meth:`fused_read_into` for the process pool's in-place publish);
* everything else decodes through a ``pq.ParquetFile`` over the remote
  filesystem with ``pre_buffer`` coalescing.

Epoch 1 therefore pays one ranged read per qualifying chunk; later epochs
read at local speed with no remote read for the mirrored columns.

Telemetry: the page scan over mirrors is a ``pagescan`` stage and the Arrow
read of the other columns an ``arrow_decode`` stage, as on the local reader
(the JAX chunk reader times neither); the fused calls are ``fused_decode``
and ``fused_predicate`` stages. Mirror fetches are ``chunk_fetch`` stages
of the store. No read-route counter is added for the mirrored columns: the
store's ``chunk_cache_*`` counters and these stages show which route served.
"""

from __future__ import annotations

import logging
import os

import pyarrow as pa

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.chunkstore.store import open_store
from petastorm_tpu_torch.native import pagescan

logger = logging.getLogger(__name__)

#: first guess at the footer size; one refetch covers larger footers
_FOOTER_GUESS = 64 * 1024

#: slack past the thrift footer so pyarrow's size sanity checks pass on the
#: tail-only buffer (footer + 8-byte trailer + room for the header magic)
_FOOTER_SLACK = 64


class ChunkCachedParquetFile(object):
    """One remote Parquet file served through the local chunk store.

    :param path: in-filesystem path of the Parquet file
    :param filesystem: a ``pyarrow.fs.FileSystem`` (typically retry-wrapped)
    :param config: :class:`petastorm_tpu_torch.chunkstore.store.ChunkCacheConfig`
    """

    def __init__(self, path, filesystem, config):
        from petastorm_tpu_torch import native

        self.path = path
        self._fs = filesystem
        self._store = open_store(config)
        self._lib = native._load_library()  # None -> no fast path, Arrow only
        info = filesystem.get_file_info([path])[0]
        if getattr(info, 'size', None) is None:
            raise IOError('cannot stat {} on {}'.format(path, filesystem))
        self._file_size = info.size
        mtime_ns = getattr(info, 'mtime_ns', None)
        # identity of the remote bytes: a rewritten file must never hit the
        # old mirror. mtime may be unavailable on some stores -> size-only.
        self._file_id = '{}|{}|{}'.format(path, info.size,
                                          mtime_ns if mtime_ns is not None else '-')
        self._meta = self._read_footer_metadata()
        self.metadata = self._meta
        # flat REQUIRED-eligible columns: leaf path == top-level name (same
        # construction as NativeParquetFile._zerocopy_columns)
        self._flat_index = {
            self._meta.schema.column(idx).path: idx
            for idx in range(self._meta.num_columns)
            if '.' not in self._meta.schema.column(idx).path}
        self._arrow_pf = None
        # warm-read memoization: qualification is pure over the (immutable)
        # footer metadata, and a page plan is pure over the chunk's bytes,
        # which are content-addressed — neither needs recomputing per read
        self._qual_cache = {}   # (row_group, tuple(names)) -> _qualifying list
        self._pages_cache = {}  # chunk key -> scan_mirrored_chunk plan
        self._disable_scan = bool(os.environ.get('PSTPU_DISABLE_PAGESCAN'))
        self._fused_plans = {}  # (rg, columns, hints sig) -> FusedPlan | None

    # -- remote IO -----------------------------------------------------------

    def _fetch_range(self, offset, length, deadline_s=None):
        from petastorm_tpu_torch.retry import fetch_range
        return fetch_range(self._fs, self.path, offset, length, deadline_s=deadline_s)

    def _chunk_key(self, offset, length):
        return '{}|{}+{}'.format(self._file_id, offset, length)

    def _read_footer_metadata(self):
        import pyarrow.parquet as pq

        def tail(n):
            n = min(n, self._file_size)
            off = self._file_size - n
            key = self._chunk_key(off, n)
            path, _, _ = self._store.ensure(key, n, self._range_fetcher(off, n))
            with open(path, 'rb') as f:
                return f.read()
        try:
            data = tail(_FOOTER_GUESS)
            if len(data) >= 8:
                footer_len = int.from_bytes(data[-8:-4], 'little')
                need = footer_len + 8 + _FOOTER_SLACK
                if need > len(data):
                    data = tail(need)
            return pq.read_metadata(pa.BufferReader(data))
        except Exception as e:  # noqa: BLE001 - odd tail/store: read footer remotely
            logger.debug('footer tail parse failed for %s (%s); remote metadata read',
                         self.path, e)
            return pq.read_metadata(self._fs.open_input_file(self.path))

    def _arrow(self):
        if self._arrow_pf is None:
            import pyarrow.parquet as pq
            self._arrow_pf = pq.ParquetFile(self._fs.open_input_file(self.path),
                                            pre_buffer=True)
        return self._arrow_pf

    # -- qualification / planning --------------------------------------------

    def _qualifying(self, row_group, column_names):
        """[(name, col_meta, schema_col, qual, start, length)] for the columns
        of ``row_group`` the page scan can serve from a cached mirror.
        Memoized — qualification reads only the immutable footer metadata."""
        memo_key = (row_group, tuple(column_names))
        cached = self._qual_cache.get(memo_key)
        if cached is not None:
            return cached
        try:
            rg = self._meta.row_group(row_group)
        except Exception:  # noqa: BLE001 - malformed metadata: Arrow path decides
            return []
        out = []
        for name in column_names:
            idx = self._flat_index.get(name)
            if idx is None:
                continue
            try:
                col = rg.column(idx)
                schema_col = self._meta.schema.column(idx)
                qual = pagescan.column_qualifies(
                    col, schema_col.max_definition_level,
                    schema_col.max_repetition_level)
                if not qual:
                    continue
                start = col.data_page_offset
                length = col.total_compressed_size
            except Exception as e:  # noqa: BLE001 - odd chunk metadata: Arrow serves it
                logger.debug('chunk qualification failed for %s:%s (%s)',
                             self.path, name, e)
                continue
            if start < 0 or length <= 0 or start + length > self._file_size:
                continue
            out.append((name, col, schema_col, qual, start, length))
        self._qual_cache[memo_key] = out
        return out

    def chunk_plan(self, row_group, column_names=None):
        """[(key, length, fetch_fn)] for the cacheable chunks of a row group:
        the prefetcher's work list. It covers both routes served from
        mirrors: chunks the page scan qualifies (views) and chunks the fused
        read qualifies (dictionary/RLE/snappy, decoded by
        ``pstpu_read_fused`` from the mirror). Prefetches go through the
        store's ``for_prefetch`` path, so they count under the
        ``chunk_cache_prefetch_*`` counters the autotuner's prefetch knob
        watches."""
        names = column_names if column_names is not None else list(self._flat_index)
        plan, seen = [], set()
        for _name, _col, _schema_col, _qual, start, length in \
                self._qualifying(row_group, names):
            key = self._chunk_key(start, length)
            seen.add(key)
            plan.append((key, length, self._range_fetcher(start, length)))
        fused = self.fused_plan(row_group, tuple(names))
        if fused is not None:
            for col in fused.columns:
                key = self._chunk_key(col.chunk_off, col.chunk_len)
                if key in seen:
                    continue
                seen.add(key)
                plan.append((key, col.chunk_len,
                             self._range_fetcher(col.chunk_off, col.chunk_len)))
        return plan

    def _range_fetcher(self, offset, length):
        def fetch(deadline_s=None):
            return self._fetch_range(offset, length, deadline_s=deadline_s)
        # the fabric client hands what remains of its transfer budget to the
        # object-store fallback through this capability flag
        fetch.supports_deadline = True
        return fetch

    # -- reading -------------------------------------------------------------

    def _zerocopy_cached(self, row_group, column_names):
        if self._lib is None or self._disable_scan:
            return {}
        expected_rows = self._meta.row_group(row_group).num_rows
        out = {}
        for name, col, schema_col, qual, start, length in \
                self._qualifying(row_group, column_names):
            key = self._chunk_key(start, length)
            try:
                mm = self._store.mmap_chunk(
                    key, length, self._range_fetcher(start, length))
                pages = self._pages_cache.get(key)
                if pages is None:
                    pages = pagescan.scan_mirrored_chunk(
                        self._lib, mm, col, has_def_levels=(qual == 'def'))
                    if pages is None:
                        continue
                    # a plan is pure over the chunk's content-addressed bytes:
                    # any future mirror of this key scans identically
                    self._pages_cache[key] = pages
                arrays = pagescan.read_mirrored_chunk(
                    self._lib, mm, col, expected_rows,
                    getattr(schema_col, 'length', 0),
                    has_def_levels=(qual == 'def'),
                    require_exact=(qual != 'def'), pages=pages)
            except Exception as e:  # noqa: BLE001 - fetch/scan surprise: Arrow path serves it
                logger.debug('chunk-cached scan of %s:%s failed (%s); Arrow path',
                             self.path, name, e)
                continue
            if arrays is None:
                continue
            out[name] = pa.chunked_array(arrays)
        return out

    # -- fused batch decode over mirrored chunks ----------------------------

    def fused_plan(self, i, columns, schema_fields=None, decode_hints=None,
                   resize_hints=None, include_pagescan=False):
        """Fused-decode plan for one row group of this REMOTE file — the same
        qualification the local path runs, judged from the cached footer.
        Dictionary/RLE/snappy chunks that the view path cannot mirror now
        become cacheable too: the fused kernel decodes them from the local
        mirror, so epoch 2+ touches no remote bytes for them either."""
        if self._lib is None or os.environ.get('PSTPU_DISABLE_FUSED'):
            return None
        from petastorm_tpu_torch.native import fused
        key = (i, tuple(columns), bool(include_pagescan),
               frozenset(n for n in (decode_hints or {}) if decode_hints[n]),
               frozenset(n for n in (resize_hints or {}) if resize_hints[n]))
        if key not in self._fused_plans:
            plan = fused.plan_row_group(self._meta, self._flat_index, i, columns,
                                        schema_fields, decode_hints, resize_hints,
                                        include_pagescan=include_pagescan)
            if plan is not None:
                for p in list(plan.columns):
                    if p.chunk_off + p.chunk_len > self._file_size:
                        plan.columns.remove(p)
                        plan.rest.append(p.name)
                        plan.reasons[p.name] = 'bounds'
            self._fused_plans[key] = plan
        return self._fused_plans[key]

    def _fused_chunks(self, cols):
        """Per-column chunk views served from the content-addressed local
        mirror (fetched once per chunk; warm reads are pure mmap)."""
        chunks = []
        for p in cols:
            key = self._chunk_key(p.chunk_off, p.chunk_len)
            try:
                mm = self._store.mmap_chunk(
                    key, p.chunk_len, self._range_fetcher(p.chunk_off, p.chunk_len))
            except Exception as e:  # noqa: BLE001 - fetch surprise: column falls back
                logger.debug('chunk mirror fetch failed for %s:%s (%s)',
                             self.path, p.name, e)
                mm = None
            chunks.append(mm)
        return chunks

    def read_fused(self, i, columns, schema_fields=None, decode_hints=None,
                   resize_hints=None):
        """Same contract as ``NativeParquetFile.read_fused``, served from
        mirrored chunks."""
        from petastorm_tpu_torch.native import fused
        plan = self.fused_plan(i, columns, schema_fields, decode_hints, resize_hints)
        if plan is None:
            return {}, list(columns)
        if not plan.columns:
            fused.count_fallbacks(plan.reasons)
            return {}, list(columns)
        block, _reasons = fused.read_block(self._lib,
                                           self._fused_chunks(plan.columns),
                                           plan, stage_args={'row_group': i})
        rest = [c for c in columns if c not in block]
        return block, rest

    def read_fused_predicate(self, i, columns, pred_fields, clauses,
                             schema_fields=None, decode_hints=None,
                             resize_hints=None):
        """Same contract as ``NativeParquetFile.read_fused_predicate``, with
        every chunk (output AND predicate columns) served from the local
        mirror — a warm filtered read touches no remote bytes at all."""
        from petastorm_tpu_torch.native import fused
        plan = self.fused_plan(i, columns, schema_fields, decode_hints,
                               resize_hints, include_pagescan=True)
        if plan is None or not plan.columns:
            return None
        got = fused.plan_predicate_columns(self._meta, self._flat_index, i,
                                           pred_fields, schema_fields)
        if got is None:
            fused.count_fallbacks({f: 'predicate' for f in pred_fields})
            return None
        pred_plans, pred_index = got
        for p in pred_plans:
            if p.chunk_off + p.chunk_len > self._file_size:
                fused.count_fallbacks({p.name: 'bounds'})
                return None
        compiled = fused.compile_predicate(clauses, pred_index)
        if isinstance(compiled, str):
            fused.count_fallbacks({f: compiled for f in pred_fields})
            return None
        preds, keepalive = compiled
        res = fused.read_block_pred(
            self._lib, self._fused_chunks(plan.columns), plan,
            self._fused_chunks(pred_plans), pred_plans, preds, keepalive,
            stage_args={'row_group': i})
        if res is None:
            return None
        block, _reasons, sel_mask, n_selected, pages_skipped = res
        rest = [c for c in columns if c not in block]
        return block, rest, sel_mask, n_selected, pages_skipped

    def fused_read_into(self, plan, out_buf, offsets):
        """In-place (shm-ring slot) variant, mirroring the local reader."""
        from petastorm_tpu_torch.native import fused
        with obs.stage('fused_decode', cat='native', rows=plan.expected_rows):
            return fused.read_into(self._lib, self._fused_chunks(plan.columns),
                                   plan.columns, plan.expected_rows, out_buf,
                                   offsets)

    def read_row_group(self, i, columns=None):
        """One row group as a ``pyarrow.Table``; qualifying columns are views
        over locally mirrored chunks, the rest decode through Arrow over the
        remote filesystem. Mixed tables split per column, preserving the
        requested order (same contract as ``NativeParquetFile``)."""
        if columns:
            with obs.stage('pagescan', cat='native'):
                fast = self._zerocopy_cached(i, columns)
        else:
            fast = {}
        rest = [c for c in columns if c not in fast] if columns is not None else None
        # columns=[] keeps the 0-column N-row semantics of the Arrow path
        # (partition-key-only reads take row counts from it)
        if columns and not rest:
            return pa.table({c: fast[c] for c in columns})
        with obs.stage('arrow_decode', cat='native'):
            table = self._arrow().read_row_group(i, columns=rest)
        if not fast:
            return table
        return pa.table({c: (fast[c] if c in fast else table.column(c))
                         for c in columns})

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        if self._arrow_pf is not None:
            try:
                self._arrow_pf.close()
            except Exception:  # noqa: BLE001 - underlying remote stream already broken
                pass
            self._arrow_pf = None
        # the workers close their files as they shut down: their last hits
        # reach the stats file the consumer's diagnostics merge
        self._store.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.close()
