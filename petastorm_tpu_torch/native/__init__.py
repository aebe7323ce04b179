"""Native host code of the port: the Parquet row-group reader and the
batched PNG/JPEG decoder, each the port's own copy of the JAX package's C++.

Twin of ``petastorm_tpu/native/__init__.py``. The row worker's hot loop is
"read the selected columns of one row group". ``open_parquet(path,
filesystem)`` serves it from ``rowgroup_reader.cpp``, built with g++ at first
use into ``.torch_build/native/`` against the pyarrow wheel's Arrow C++
(:mod:`~petastorm_tpu_torch.native.build`), when the file is local and the
library builds; else from ``pyarrow.parquet.ParquetFile``, whose
``read_row_group(i, columns)`` and ``close()`` :class:`NativeParquetFile`
shares. A local row group's columns are served in this order:

1. fused: decoded, images included, into one batch buffer by one
   GIL-released native call (:meth:`NativeParquetFile.read_fused`,
   ``fused.py``);
2. page scan: uncompressed PLAIN fixed-width columns as read-only views over
   the mmapped file (``pagescan.py``);
3. Arrow C++, decoding on its own threads, imported through the Arrow C
   stream interface.

:data:`read_routes` counts the columns each route served. Switches, as in
the JAX package: ``PETASTORM_TPU_DISABLE_NATIVE=1`` forces
``pq.ParquetFile``, ``PSTPU_DISABLE_FUSED=1`` skips the fused route and
``PSTPU_DISABLE_PAGESCAN=1`` the page scan. In the process pool's in-place
mode the fused read writes a whole row group into the shm-ring slot the
consumer maps (:meth:`NativeParquetFile.fused_read_into`), counted as
``fused_inplace_batches_total``. The ring itself is
:mod:`~petastorm_tpu_torch.native.shm_ring`, and the lifetime of views into
it :mod:`~petastorm_tpu_torch.native.lifetime`. A filtered read
(:meth:`NativeParquetFile.read_fused_predicate`) evaluates a predicate,
skips pages by their statistics and decodes only the surviving rows in the
same kind of single call. A remote file opened with a chunk cache is a
:class:`~petastorm_tpu_torch.chunkstore.reader.ChunkCachedParquetFile`: the
same fused and page-scan routes, served from local mirrors of its chunks.

Telemetry, as the JAX package's: each fused call is a ``fused_decode`` (or
``fused_predicate``) stage, the page scan a ``pagescan`` stage and the
Arrow C++ read an ``arrow_decode`` stage; the route counters also go to the
metrics registry (:func:`count_route`).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

from petastorm_tpu_torch import observability as obs

logger = logging.getLogger(__name__)


class RouteCounts(object):
    """Counts by name since the last :meth:`reset`, summed over every thread
    of the process. ``keys`` start at 0; any other name may be added too (a
    fallback reason is a label)."""

    def __init__(self, keys=()):
        self._keys = tuple(keys)
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self._keys, 0)

    def add(self, key, n=1):
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def reset(self):
        with self._lock:
            self._counts = dict.fromkeys(self._keys, 0)

    def snapshot(self):
        with self._lock:
            return dict(self._counts)


#: the columns each read route served, with the JAX package's counter names:
#: ``fused_batches_total`` (native fused calls that decoded at least one
#: column), ``fused_columns_total``, ``fused_fallback_total`` and
#: ``fused_fallback_reason:<reason>`` (columns not fused, and why),
#: ``pagescan_columns_total`` (columns served as views) and
#: ``arrow_fallback_columns_total`` (columns decoded by Arrow C++); in a
#: process pool's in-place mode also ``fused_inplace_batches_total`` (fused
#: batches decoded straight into a ring slot); for filtered reads
#: ``fused_pred_batches_total``, ``fused_pred_pages_skipped_total`` and
#: ``fused_pred_rows_selected``; ``fused_fallback_column:<name>:<reason>``
#: names each column that was not fused. A process pool adds its workers'
#: counts to the consumer's as they arrive
read_routes = RouteCounts(('fused_batches_total', 'fused_columns_total', 'fused_fallback_total',
                           'pagescan_columns_total', 'arrow_fallback_columns_total'))


def count_route(key, n=1):
    """Count ``n`` on the read route ``key``: in :data:`read_routes` and, as
    the JAX package counts it, in the telemetry registry (the counter of the
    same name in ``Reader.diagnostics``). A process pool adds its workers'
    route counts to ``read_routes`` only: their registries arrive whole."""
    read_routes.add(key, n)
    obs.count(key, n)

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _load_library():
    """The reader library, built at first use; None when it is unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get('PETASTORM_TPU_DISABLE_NATIVE'):
            _load_failed = True
            return None
        try:
            from petastorm_tpu_torch.native.build import build
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError) as e:  # no compiler or headers, a failed build or load
            logger.info('native reader unavailable (%s); using pyarrow', e)
            _load_failed = True
            return None
        from petastorm_tpu_torch.native import fused
        try:
            lib.pstpu_abi_version.restype = ctypes.c_int
            lib.pstpu_abi_version.argtypes = []
            abi = lib.pstpu_abi_version()
        except AttributeError:  # a library older than the version gate
            abi = None
        if abi != fused.EXPECTED_ABI:
            # structs laid out for another ABI would corrupt memory, not fall back
            logger.warning('native reader reports ABI version %s but petastorm_tpu_torch '
                           'expects %d (a stale build?); using pyarrow. Rebuild with '
                           'python -m petastorm_tpu_torch.native.build --force',
                           abi, fused.EXPECTED_ABI)
            _load_failed = True
            return None
        lib.pstpu_open.restype = ctypes.c_void_p
        lib.pstpu_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong]
        lib.pstpu_close.argtypes = [ctypes.c_void_p]
        lib.pstpu_last_error.restype = ctypes.c_char_p
        lib.pstpu_num_columns.argtypes = [ctypes.c_void_p]
        lib.pstpu_column_name.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.pstpu_read_row_group.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                             ctypes.c_void_p]
        lib.pstpu_scan_plain_pages.restype = ctypes.c_longlong
        lib.pstpu_scan_plain_pages.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_ulonglong),  # per-page values-region lengths
            ctypes.c_int, ctypes.c_int]
        fused.register_abi(lib)
        _lib = lib
        return _lib


def is_available():
    return _load_library() is not None


def abi_version():
    """The loaded library's ``pstpu_abi_version()``; None when unavailable."""
    lib = _load_library()
    return None if lib is None else lib.pstpu_abi_version()


def _last_error(lib):
    return lib.pstpu_last_error().decode('utf-8', 'replace')


class NativeParquetFile(object):
    """C++-backed Parquet file. One instance per worker thread: the library
    serializes concurrent reads of one handle."""

    def __init__(self, path):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('native reader not available')
        self._lib = lib
        # Arrow C++ decodes on its own threads (1), which overlaps the
        # workers' GIL-bound Python; plain reads, no coalescing buffer (0)
        self._handle = lib.pstpu_open(path.encode(), 1, 0)
        if not self._handle:
            raise IOError('pstpu_open({}): {}'.format(path, _last_error(lib)))
        self.path = path
        # a requested name (top-level field, or a full dotted leaf path) ->
        # the Parquet leaf indices it covers: lists and structs span several
        # leaves, like "col.list.element"
        self._leaf_indices = {}
        buf = ctypes.create_string_buffer(4096)
        for i in range(lib.pstpu_num_columns(self._handle)):
            if lib.pstpu_column_name(self._handle, i, buf, len(buf)) >= 0:
                dotted = buf.value.decode()
                top = dotted.split('.', 1)[0]
                self._leaf_indices.setdefault(top, []).append(i)
                if dotted != top:
                    self._leaf_indices.setdefault(dotted, []).append(i)
        from petastorm_tpu_torch.native.pagescan import _MmapPool
        self._pq_meta = None        # pyarrow FileMetaData, or False (unusable)
        self._flat_index = {}
        self._mmaps = _MmapPool()
        self._fused_plans = {}      # (rg, columns, hinted columns) -> FusedPlan or None

    def _ensure_pq_meta(self):
        """The footer parsed by pyarrow ONCE per file (the chunk metadata the
        page scan and the fused plan judge columns by); False when unusable."""
        if self._pq_meta is None:
            import pyarrow.parquet as pq
            try:
                self._pq_meta = pq.read_metadata(self.path)
            except Exception:  # noqa: BLE001 - odd footer: the Arrow path serves it all
                self._pq_meta = False
            else:
                # flat columns: leaf path == top-level name
                self._flat_index = {
                    self._pq_meta.schema.column(idx).path: idx
                    for idx in range(self._pq_meta.num_columns)
                    if '.' not in self._pq_meta.schema.column(idx).path}
        return self._pq_meta

    @property
    def metadata(self):
        """The file's footer as a ``pyarrow`` ``FileMetaData``, as
        ``pq.ParquetFile.metadata`` gives it."""
        if self._ensure_pq_meta() is False:
            raise IOError('unreadable Parquet footer: {}'.format(self.path))
        return self._pq_meta

    def _zerocopy_columns(self, i, columns):
        """``{name: ChunkedArray}`` of the columns servable as views over the
        mmapped file (``pagescan.py``).

        :borrows: the arrays alias the pool's long-lived file mapping; each
            holds it alive through ``pa.py_buffer``'s base."""
        if os.environ.get('PSTPU_DISABLE_PAGESCAN'):
            return {}
        if self._ensure_pq_meta() is False:
            return {}
        from petastorm_tpu_torch.native import pagescan
        return pagescan.read_columns_zerocopy(self.path, self._pq_meta, i, columns,
                                              self._flat_index, self._mmaps, self._lib)

    def fused_plan(self, i, columns, schema_fields=None, decode_hints=None, resize_hints=None,
                   include_pagescan=False):
        """The :class:`~petastorm_tpu_torch.native.fused.FusedPlan` of one row
        group's column selection (memoized per file), or None when the fused
        route is switched off or the footer is unusable. ``include_pagescan``
        fuses the page-scan columns too (the in-place ring mode)."""
        if os.environ.get('PSTPU_DISABLE_FUSED') or self._ensure_pq_meta() is False:
            return None
        key = (i, tuple(columns), bool(include_pagescan),
               frozenset(n for n in (decode_hints or {}) if decode_hints[n]),
               frozenset(n for n in (resize_hints or {}) if resize_hints[n]))
        if key not in self._fused_plans:
            from petastorm_tpu_torch.native import fused
            self._fused_plans[key] = fused.plan_row_group(
                self._pq_meta, self._flat_index, i, columns, schema_fields, decode_hints,
                resize_hints, include_pagescan=include_pagescan)
        return self._fused_plans[key]

    def _fused_chunks(self, cols):
        """Each column chunk's bytes as a view over the mmapped file, or None
        where the footer points past the file (a stale footer fails the
        column, not the process)."""
        mm = self._mmaps.get(self.path)
        chunks = []
        for p in cols:
            if p.chunk_off < 0 or p.chunk_off + p.chunk_len > mm.size:
                chunks.append(None)
            else:
                chunks.append(mm[p.chunk_off:p.chunk_off + p.chunk_len])
        return chunks

    def read_fused(self, i, columns, schema_fields=None, decode_hints=None, resize_hints=None):
        """Fused read→decode→collate of one row group: every qualifying
        column lands as a numpy array backed by ONE fresh contiguous buffer,
        decoded by a single GIL-released native call. Returns ``(block,
        rest)``: ``rest`` keeps the requested order of the columns left to
        the other routes (their fallback reasons counted)."""
        from petastorm_tpu_torch.native import fused
        plan = self.fused_plan(i, columns, schema_fields, decode_hints, resize_hints)
        if plan is None:
            return {}, list(columns)
        if not plan.columns:
            fused.count_fallbacks(plan.reasons)
            return {}, list(columns)
        block, _reasons = fused.read_block(self._lib, self._fused_chunks(plan.columns), plan,
                                           stage_args={'row_group': i})
        return block, [c for c in columns if c not in block]

    def read_fused_predicate(self, i, columns, pred_fields, clauses, schema_fields=None,
                             decode_hints=None, resize_hints=None):
        """Filtered fused read of one row group: the predicate's evaluation
        (with min/max page-stat skipping), the row selection and the decode
        of ONLY the surviving rows run in one GIL-released call. ``clauses``
        is the ``PredicateBase.native_clauses()`` list. Returns ``(block,
        rest, sel_mask, n_selected, pages_skipped)``, where the ``rest``
        columns are for the caller to read through Arrow and filter with
        ``sel_mask``; or None when the predicate or its columns cannot be
        evaluated natively (reason ``predicate`` counted for each predicate
        column) or the kernel declined."""
        from petastorm_tpu_torch.native import fused
        plan = self.fused_plan(i, columns, schema_fields, decode_hints, resize_hints,
                               include_pagescan=True)
        if plan is None or not plan.columns:
            return None
        got = fused.plan_predicate_columns(self._pq_meta, self._flat_index, i, pred_fields,
                                           schema_fields)
        if got is None:
            fused.count_fallbacks({f: 'predicate' for f in pred_fields})
            return None
        pred_plans, pred_index = got
        compiled = fused.compile_predicate(clauses, pred_index)
        if isinstance(compiled, str):
            fused.count_fallbacks({f: compiled for f in pred_fields})
            return None
        preds, keepalive = compiled
        res = fused.read_block_pred(self._lib, self._fused_chunks(plan.columns), plan,
                                    self._fused_chunks(pred_plans), pred_plans, preds, keepalive,
                                    stage_args={'row_group': i})
        if res is None:
            return None
        block, _reasons, sel_mask, n_selected, pages_skipped = res
        return block, [c for c in columns if c not in block], sel_mask, n_selected, pages_skipped

    def fused_read_into(self, plan, out_buf, offsets):
        """Run a prepared fused plan writing each column at its offset in
        ``out_buf`` (in the in-place mode, the ring slot the consumer maps).
        Returns the per-column native results of :func:`fused.read_into`."""
        from petastorm_tpu_torch.native import fused
        with obs.stage('fused_decode', cat='native', rows=plan.expected_rows):
            return fused.read_into(self._lib, self._fused_chunks(plan.columns), plan.columns,
                                   plan.expected_rows, out_buf, offsets)

    def read_row_group(self, i, columns=None):
        """One row group as a ``pyarrow.Table``. Columns that qualify for the
        page scan become views over the mmapped file; the rest decode on
        Arrow C++ threads and come in through the Arrow C stream interface.
        The table keeps the requested column order."""
        import pyarrow as pa

        if columns:
            with obs.stage('pagescan', cat='native'):
                fast = self._zerocopy_columns(i, columns)
        else:
            fast = {}
        rest = [c for c in columns if c not in fast] if columns is not None else None
        if fast:
            count_route('pagescan_columns_total', len(fast))
        if rest:
            count_route('arrow_fallback_columns_total', len(rest))
        # columns=[] keeps the Arrow path's 0-column N-row table
        if columns and not rest:
            return pa.table({c: fast[c] for c in columns})
        if rest is not None:
            indices = []
            for c in rest:
                try:
                    indices.extend(self._leaf_indices[c])
                except KeyError:
                    raise KeyError('column {!r} not in file {} (has: {})'.format(
                        c, self.path, sorted(self._leaf_indices)))
            arr = (ctypes.c_int * len(indices))(*indices)
            n = len(indices)
        else:
            arr, n = None, -1
        with obs.stage('arrow_decode', cat='native'):
            # an ArrowArrayStream is 4 pointers and private fields: 256 bytes
            # is ample
            stream_buf = ctypes.create_string_buffer(256)
            rc = self._lib.pstpu_read_row_group(self._handle, i, arr, n,
                                                ctypes.byref(stream_buf))
            if rc != 0:
                raise IOError('pstpu_read_row_group({}, rg={}): {}'.format(
                    self.path, i, _last_error(self._lib)))
            table = pa.RecordBatchReader._import_from_c(ctypes.addressof(stream_buf)).read_all()
        if not fast:
            return table
        return pa.table({c: (fast[c] if c in fast else table.column(c)) for c in columns})

    def close(self):
        if self._handle:
            self._lib.pstpu_close(self._handle)
            self._handle = None
        # drops the pool's references only: arrays over a mapping keep it alive
        self._mmaps.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.close()


def open_parquet(path, filesystem=None, chunk_cache=None):
    """``path`` through the native reader when it can serve it (a local
    file, a library that built), else a ``pq.ParquetFile`` over
    ``filesystem``.

    ``chunk_cache`` (a :class:`~petastorm_tpu_torch.chunkstore.ChunkCacheConfig`)
    routes a REMOTE file through the chunk store: its qualifying column
    chunks are mirrored locally once and served by the page scan and the
    fused read, the routes local files take. Ignored for local filesystems
    and without the native library (the mirror exists to feed it). When the
    chunk-cached open raises (a bad cache directory, a failed remote stat),
    the file is read plainly. Any other remote file is opened with
    ``pre_buffer``: a row group's column-chunk ranges coalesce into few large
    reads issued ahead of decode."""
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    local = filesystem is None or isinstance(filesystem, pafs.LocalFileSystem)
    if local and is_available():
        try:
            return NativeParquetFile(path)
        except IOError as e:
            logger.warning('native open failed for %s (%s); pyarrow fallback', path, e)
    if not local and chunk_cache is not None and is_available():
        from petastorm_tpu_torch.chunkstore.reader import ChunkCachedParquetFile
        try:
            return ChunkCachedParquetFile(path, filesystem, chunk_cache)
        except Exception as e:  # noqa: BLE001 - cache directory or remote stat trouble: plain read
            logger.warning('chunk-cached open failed for %s (%s); plain remote read', path, e)
    # the ParquetFile opens the file itself, so its close() closes it
    if local:
        return pq.ParquetFile(path, filesystem=filesystem)
    return pq.ParquetFile(path, filesystem=filesystem, pre_buffer=True)
