"""Zero-copy Parquet column reads through the first-party page scanner.

Twin of ``petastorm_tpu/native/pagescan.py``. Arrow C++ assembles a fresh
contiguous buffer per column chunk; for the decode-free ``RawTensorCodec``
training stores (uncompressed, PLAIN, fixed-width) that assembly is the whole
host cost of a read. Here the C++ scanner (``pstpu_scan_plain_pages`` in
``rowgroup_reader.cpp``) parses the thrift-compact page headers itself, and
each page's values region becomes an Arrow array VIEW over the mmapped file:
no byte is copied, the OS page cache is the only storage layer.

Qualification is strict and checked per column chunk from the Parquet
metadata: UNCOMPRESSED, PLAIN-only encodings (plus the level encodings), a
flat path with ``max_definition_level == 0`` (REQUIRED), or ``== 1`` when the
chunk statistics PROVE ``null_count == 0`` (the page's RLE definition-levels
block is then skipped), and physical type FIXED_LEN_BYTE_ARRAY, INT32, INT64,
FLOAT or DOUBLE. Any other chunk is left to the Arrow path; tables split per
column, so one dictionary-encoded label does not cost the image column next
to it its views.

A remote chunk mirrored by the chunk store is served by the same scan over
its mirror (:func:`scan_mirrored_chunk`, :func:`read_mirrored_chunk`).

The views are read-only. The row worker copies them where a user transform
may write into its block; the infeed copies non-writable arrays into pinned
memory anyway.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np
import pyarrow as pa

logger = logging.getLogger(__name__)

#: physical type -> (arrow type factory, itemsize); FLBA is handled apart
_PHYSICAL_FIXED = {
    'INT32': (pa.int32, 4),
    'INT64': (pa.int64, 8),
    'FLOAT': (pa.float32, 4),
    'DOUBLE': (pa.float64, 8),
}

_MAX_PAGES = 4096

#: per-thread scratch for the scanner's out-arrays (allocating and zeroing
#: them per call costs about as much as the scan)
_scratch = threading.local()

#: a chunk over the page cap warns once per process; the counter keeps counting
_page_cap_warned = False


def _scratch_arrays():
    arrays = getattr(_scratch, 'arrays', None)
    if arrays is None:
        arrays = ((ctypes.c_ulonglong * _MAX_PAGES)(),
                  (ctypes.c_longlong * _MAX_PAGES)(),
                  (ctypes.c_ulonglong * _MAX_PAGES)())
        _scratch.arrays = arrays
    return arrays


def _note_scan_failure(lib, where):
    """A scan returned -1. Most causes are qualification gaps the caller
    already accounts; a chunk with more pages than ``_MAX_PAGES`` would lose
    the view path for good without a word, so it is counted under
    ``pagescan_fallback_reason:page-cap`` and warned about once."""
    global _page_cap_warned
    err = lib.pstpu_last_error().decode('utf-8', 'replace')
    if 'max_pages' not in err:
        return
    from petastorm_tpu_torch.native import count_route
    count_route('pagescan_fallback_reason:page-cap')
    if not _page_cap_warned:
        _page_cap_warned = True
        logger.warning(
            'page scan of %s hit the %d-page-per-chunk cap and fell back to '
            'Arrow; this store writes unusually small pages: rewrite it with '
            'a larger data_page_size to recover the zero-copy path', where, _MAX_PAGES)


class _MmapPool(object):
    """One long-lived read-only mmap per file path. Arrays built over it hold
    the mmap through ``pa.py_buffer``'s base, so the mapping outlives the pool
    entry; closing the pool only stops NEW views."""

    def __init__(self):
        self._maps = {}

    def get(self, path):
        """The pool's read-only mapping of ``path``, created on first use.

        :borrows: every array served zero-copy from ``path`` aliases this
            mapping; the registry slot keeps it visible in
            ``lifetime_live_borrows`` until the last such array dies."""
        mm = self._maps.get(path)
        if mm is None:
            mm = np.memmap(path, dtype=np.uint8, mode='r')
            from petastorm_tpu_torch.native.lifetime import registry
            slot = registry().open_slot(label='pagescan-mmap')
            slot.adopt(mm)
            slot.seal()
            self._maps[path] = mm
        return mm

    def close(self):
        self._maps.clear()


def _column_qualifies(meta_col, max_def_level, max_rep_level):
    """True/False, or ``'def'`` for an OPTIONAL column whose statistics PROVE
    it null-free: its pages lead with an RLE def-levels block the scanner
    skips. Any repetition disqualifies (a top-level ``repeated`` primitive has
    a dot-free path and max_def_level 1, but also a repetition-levels block)."""
    if max_rep_level != 0 or max_def_level > 1:
        return False
    if max_def_level == 1:
        stats = meta_col.statistics
        if stats is None or stats.null_count is None or stats.null_count != 0:
            return False
    if meta_col.compression != 'UNCOMPRESSED':
        return False
    # PLAIN data pages only; RLE appears as the level encoding
    if any(e not in ('PLAIN', 'RLE', 'BIT_PACKED') for e in meta_col.encodings):
        return False
    if meta_col.has_dictionary_page:
        return False
    pt = meta_col.physical_type
    if pt != 'FIXED_LEN_BYTE_ARRAY' and pt not in _PHYSICAL_FIXED:
        return False
    return 'def' if max_def_level == 1 else True


def column_qualifies(meta_col, max_def_level, max_rep_level):
    """The strict check of the local path, public: the chunk store
    qualifies remote chunks with it (``chunkstore/reader.py``)."""
    return _column_qualifies(meta_col, max_def_level, max_rep_level)


def scan_mirrored_chunk(lib, mm, meta_col, has_def_levels=False):
    """Page plan ``[(offset_in_mirror, num_values, values_region_len)]`` of a
    byte-exact local mirror of one column chunk (the chunk's bytes alone, at
    offset 0), or None. The mirror must be exactly ``total_compressed_size``
    bytes: any other length means the cache entry does not match the footer.

    The plan depends only on the mirror's bytes, which the chunk store keys
    by content and never changes, so callers keep it per chunk key."""
    length = int(mm.size)
    if length <= 0 or length != meta_col.total_compressed_size:
        return None
    offs, counts, vlens = _scratch_arrays()
    n = lib.pstpu_scan_plain_pages(
        mm.ctypes.data_as(ctypes.c_void_p), length, offs, counts, vlens,
        _MAX_PAGES, 1 if has_def_levels else 0)
    if n < 0:
        _note_scan_failure(lib, 'mirrored chunk')
        return None
    return [(offs[i], counts[i], vlens[i]) for i in range(n)]


def read_mirrored_chunk(lib, mm, meta_col, expected_rows, flba_width,
                        has_def_levels=False, require_exact=True, pages=None):
    """Arrow arrays (one per page) of a column chunk served from a
    byte-exact local mirror ``mm`` (the chunk's bytes alone, at offset 0)
    instead of the whole mmapped file: how a remote chunk, mirrored once by
    the chunk store (:mod:`petastorm_tpu_torch.chunkstore`), rides the local
    zero-copy path, with the same per-page bounds checks
    (:func:`_chunk_to_arrays`) and the same Arrow fallback on any mismatch.

    ``pages`` is an optional :func:`scan_mirrored_chunk` plan (valid for any
    mirror of the same chunk key); without it the mirror is scanned here.
    Returns None when the chunk cannot be served."""
    if pages is None:
        pages = scan_mirrored_chunk(lib, mm, meta_col, has_def_levels=has_def_levels)
    if pages is None:
        return None
    return _chunk_to_arrays(mm, meta_col, pages, expected_rows, flba_width,
                            require_exact=require_exact)


def _scan_chunk(lib, mm, meta_col, has_def_levels=False):
    """``[(values_offset_in_file, num_values, values_region_len)]`` for one
    column chunk, or None. The region length is the scanner-verified span
    from the values' start to the page's end: the bound a view must fit."""
    start = meta_col.data_page_offset
    length = meta_col.total_compressed_size
    if start < 0 or length <= 0 or start + length > mm.size:
        return None
    chunk = mm[start:start + length]
    offs, counts, vlens = _scratch_arrays()
    n = lib.pstpu_scan_plain_pages(
        chunk.ctypes.data_as(ctypes.c_void_p), length, offs, counts, vlens,
        _MAX_PAGES, 1 if has_def_levels else 0)
    if n < 0:
        _note_scan_failure(lib, getattr(meta_col, 'path_in_schema', 'chunk'))
        return None
    return [(start + offs[i], counts[i], vlens[i]) for i in range(n)]


def _chunk_to_arrays(mm, meta_col, pages, expected_rows, flba_width, require_exact=True):
    """One Arrow array per page, each a view over the mmap.

    Every view is checked against its PAGE's values region, not just the
    file: a wrong null_count statistic or a short page would otherwise serve
    the next page's header bytes as data. REQUIRED columns
    (``require_exact``) must fill the region exactly; def-skipped OPTIONAL
    columns may leave a tail. Any mismatch returns None and the Arrow path
    serves the column."""
    pt = meta_col.physical_type
    if pt == 'FIXED_LEN_BYTE_ARRAY':
        if not flba_width or flba_width <= 0:
            return None
        arrow_type = pa.binary(flba_width)
        itemsize = flba_width
    else:
        factory, itemsize = _PHYSICAL_FIXED[pt]
        arrow_type = factory()
    arrays = []
    total = 0
    for off, count, region_len in pages:
        nbytes = count * itemsize
        if nbytes > region_len or (require_exact and nbytes != region_len):
            return None
        if off + nbytes > mm.size:
            return None
        buf = pa.py_buffer(memoryview(mm)[off:off + nbytes])
        arrays.append(pa.Array.from_buffers(arrow_type, count, [None, buf]))
        total += count
    if total != expected_rows:
        return None
    return arrays


def read_columns_zerocopy(path, pq_metadata, row_group, column_names, name_to_index,
                          mmap_pool, lib):
    """``{name: pyarrow.ChunkedArray}`` for the subset of ``column_names``
    servable zero-copy from ``path``'s row group; ``{}`` when none qualify.
    ``name_to_index`` maps a top-level column name to its single leaf index;
    nested columns are absent from it and fall to the Arrow path."""
    out = {}
    try:
        rg = pq_metadata.row_group(row_group)
    except Exception:  # noqa: BLE001 - malformed metadata: the Arrow path decides
        return out
    expected_rows = rg.num_rows
    mm = None
    for name in column_names:
        idx = name_to_index.get(name)
        if idx is None:
            continue
        try:
            col = rg.column(idx)
            schema_col = pq_metadata.schema.column(idx)
            qual = _column_qualifies(col, schema_col.max_definition_level,
                                     schema_col.max_repetition_level)
            if not qual:
                continue
            if mm is None:
                mm = mmap_pool.get(path)
            pages = _scan_chunk(lib, mm, col, has_def_levels=(qual == 'def'))
            if pages is None:
                continue
            # the FLBA byte width lives on the schema column (``length``)
            arrays = _chunk_to_arrays(mm, col, pages, expected_rows,
                                      getattr(schema_col, 'length', 0),
                                      require_exact=(qual != 'def'))
            if arrays is None:
                continue
            out[name] = pa.chunked_array(arrays)
        except Exception as e:  # noqa: BLE001 - any surprise: the Arrow path serves it
            logger.debug('zero-copy scan of %s:%s failed (%s); Arrow path', path, name, e)
            continue
    return out
