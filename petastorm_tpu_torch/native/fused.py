"""Fused native read→decode→collate: one native call per row group.

Twin of ``petastorm_tpu/native/fused.py``. It drives
the ``pstpu_read_fused`` kernel (``rowgroup_reader.cpp``): a row group's
qualifying column chunks are page-walked, decompressed (first-party snappy,
ZSTD and LZ4), PLAIN- and dictionary/RLE-decoded, and written straight into
ONE preallocated contiguous batch buffer on C++ threads, with the GIL
released for the whole call. Python sees the finished columns as numpy views
over that buffer: read, decode and collate are one native transition.

Three fused column flavors:

* **fixed**: INT32/INT64/FLOAT/DOUBLE/FLBA values, PLAIN or
  dictionary-encoded; rows land as the final ``[N, ...]`` array.
* **raw cells**: BYTE_ARRAY columns whose cells are uniform (``NdarrayCodec``
  ``np.save`` payloads, their headers checked identical and stripped
  natively, or legacy raw tensors): one contiguous copy.
* **images**: ``CompressedImageCodec`` columns with a fully specified shape:
  the batched image decoder (``image_codec.cpp``) is called through function
  pointers INSIDE the fused call, so pixels decode into the batch rows.

Each column chunk is judged from the Parquet metadata; every column that is
not fused is counted under ``fused_fallback_reason:<reason>`` in
:data:`~petastorm_tpu_torch.native.read_routes`, so an Arrow-fallback count
is always explained.

Two places the batch lands: a fresh heap buffer (:func:`read_block`), or, in
the process pool's in-place mode, the shm-ring slot the consumer maps
(:func:`read_into` over a reserved region, planned with
``include_pagescan=True`` so that the columns the page scan would serve as
views are copied once, into the slot).

The predicate half drives ``pstpu_read_fused_pred`` (:func:`read_block_pred`):
the clauses of a predicate's ``native_clauses()`` are compiled onto
``FusedPred`` descriptors (:func:`compile_predicate`), and one GIL-released
call evaluates them over the predicate columns, skips whole pages whose
min/max statistics exclude every row, and decodes only the selected rows of
the output columns. It counts ``fused_pred_batches_total``,
``fused_pred_pages_skipped_total`` and ``fused_pred_rows_selected``; a
predicate the kernel cannot evaluate counts reason ``predicate`` for each of
its columns.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.native import count_route

logger = logging.getLogger(__name__)

#: hard page-count cap per chunk, shared with the page scanner; overflowing it
#: is a counted per-column fallback (status ``page-cap``), never silent
MAX_PAGES = 4096

#: the batch-buffer ABI version the ctypes mirrors below describe. It MUST
#: equal the ``pstpu_abi_version()`` literal in rowgroup_reader.cpp: the
#: loader refuses a library that reports anything else.
EXPECTED_ABI = 4

# modes / codecs: keep in sync with rowgroup_reader.cpp
MODE_FIXED = 0
MODE_BINARY_RAW = 1
MODE_BINARY_IMG = 2
CODEC_UNCOMPRESSED = 0
CODEC_SNAPPY = 1
CODEC_ZSTD = 2
CODEC_LZ4_RAW = 3
CODEC_LZ4 = 4      # parquet legacy LZ4: hadoop-framed / frame / raw, auto-detected

#: Parquet metadata compression name -> kernel codec id. Every codec here has
#: a first-party bounds-checked decompressor in rowgroup_reader.cpp; others
#: (GZIP, BROTLI, LZO) are an Arrow-path ``compression`` fallback.
CODEC_BY_NAME = {
    'UNCOMPRESSED': CODEC_UNCOMPRESSED,
    'SNAPPY': CODEC_SNAPPY,
    'ZSTD': CODEC_ZSTD,
    'LZ4_RAW': CODEC_LZ4_RAW,
    'LZ4': CODEC_LZ4,
}

# predicate ops / comparison dtypes: keep in sync with rowgroup_reader.cpp
PRED_IN = 0
PRED_RANGE = 1
_PRED_DTYPE_CODES = {('i', 4): 0, ('i', 8): 1, ('u', 4): 2, ('u', 8): 3,
                     ('f', 4): 4, ('f', 8): 5}

#: native per-column status -> fallback reason label (rowgroup_reader.cpp)
REASON_BY_STATUS = {
    1: 'parse', 2: 'page-type', 3: 'encoding', 4: 'compression',
    5: 'def-levels', 6: 'page-cap', 7: 'rows', 8: 'bounds', 9: 'dict',
    10: 'nonuniform', 11: 'image-probe', 12: 'image-dims', 13: 'image-decode',
    14: 'internal',
}

_PHYS_DTYPE = {'INT32': np.dtype(np.int32), 'INT64': np.dtype(np.int64),
               'FLOAT': np.dtype(np.float32), 'DOUBLE': np.dtype(np.float64)}

_OK_ENCODINGS = frozenset(('PLAIN', 'RLE', 'BIT_PACKED', 'PLAIN_DICTIONARY',
                           'RLE_DICTIONARY'))

#: size of the per-column side buffer the kernel copies a cell's np.save
#: header into (v1 headers are 64-byte padded; 256 covers every sane shape)
_AUX_BYTES = 256


class FusedColStruct(ctypes.Structure):
    """Field-for-field mirror of ``struct FusedCol`` (the batch-buffer ABI)."""

    _fields_ = [
        ('chunk', ctypes.c_void_p),
        ('chunk_len', ctypes.c_uint64),
        ('out', ctypes.c_void_p),
        ('out_cap', ctypes.c_uint64),
        ('aux_buf', ctypes.c_void_p),
        ('aux_cap', ctypes.c_uint64),
        ('expected_rows', ctypes.c_int64),
        ('mode', ctypes.c_int32),
        ('codec', ctypes.c_int32),
        ('itemsize', ctypes.c_int32),
        ('has_def_levels', ctypes.c_int32),
        ('strip_npy', ctypes.c_int32),
        ('img_w', ctypes.c_int32),
        ('img_h', ctypes.c_int32),
        ('img_c', ctypes.c_int32),
        ('img_threads', ctypes.c_int32),
        ('status', ctypes.c_int32),
        ('out_used', ctypes.c_uint64),
        ('aux0', ctypes.c_uint64),
        ('aux1', ctypes.c_uint64),
    ]


class FusedPredStruct(ctypes.Structure):
    """Field-for-field mirror of ``struct FusedPred`` (the batch-buffer ABI)."""

    _fields_ = [
        ('values', ctypes.c_void_p),
        ('values_cap', ctypes.c_uint64),
        ('count', ctypes.c_int64),
        ('col', ctypes.c_int32),
        ('op', ctypes.c_int32),
        ('dtype', ctypes.c_int32),
        ('negate', ctypes.c_int32),
        ('has_lo', ctypes.c_int32),
        ('has_hi', ctypes.c_int32),
        ('lo_incl', ctypes.c_int32),
        ('hi_incl', ctypes.c_int32),
        ('status', ctypes.c_int32),
        ('pages_skipped', ctypes.c_int32),
    ]


def register_abi(lib):
    """ctypes signatures of the fused entry points (called by the loader)."""
    lib.pstpu_read_fused.restype = ctypes.c_longlong
    lib.pstpu_read_fused.argtypes = [
        ctypes.POINTER(FusedColStruct), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.pstpu_read_fused_pred.restype = ctypes.c_longlong
    lib.pstpu_read_fused_pred.argtypes = [
        ctypes.POINTER(FusedColStruct), ctypes.c_int,
        ctypes.POINTER(FusedColStruct), ctypes.c_int,
        ctypes.POINTER(FusedPredStruct), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong)]


class ColumnPlan(object):
    """One column's fused-decode recipe, derived from the chunk metadata."""

    __slots__ = ('name', 'mode', 'codec', 'itemsize', 'has_def', 'strip_npy',
                 'img', 'chunk_off', 'chunk_len', 'out_bound', 'known_size',
                 'phys_dtype', 'field_dtype', 'field_shape', 'out_dtype', 'out_shape')

    def __init__(self, name):
        self.name = name
        self.mode = MODE_FIXED
        self.codec = CODEC_UNCOMPRESSED
        self.itemsize = 0
        self.has_def = False
        self.strip_npy = False
        self.img = None          # (h, w, c) for MODE_BINARY_IMG
        self.chunk_off = 0
        self.chunk_len = 0
        self.out_bound = 0       # bytes reserved in the batch buffer
        self.known_size = True   # False: out_bound is an upper bound (raw cells)
        self.phys_dtype = None
        self.field_dtype = None  # final dtype (None: keep the decoded dtype)
        self.field_shape = None  # trailing row shape (None: flat or discovered)
        self.out_dtype = None    # dtype the raw out bytes are viewed as
        self.out_shape = None


class FusedPlan(object):
    """Plan for one (row group, column selection): the fused candidates, the
    columns that must ride Arrow, and the reason each one fell back."""

    __slots__ = ('columns', 'rest', 'reasons', 'expected_rows')

    def __init__(self, columns, rest, reasons, expected_rows):
        self.columns = columns
        self.rest = rest
        self.reasons = reasons
        self.expected_rows = expected_rows

    @property
    def inplace_ok(self):
        """True when every fused column's byte size is known ahead of the
        decode: what assembling the batch in a ring slot needs (the
        serializer header is written before the payload)."""
        return bool(self.columns) and all(c.known_size for c in self.columns)

    def payload_bytes(self):
        return sum(c.out_bound for c in self.columns)


def _np_dtype(maybe_dtype):
    """numpy dtype of a Unischema field's numpy_dtype, or None for the flavors
    numpy cannot type (Decimal, str/bytes ride the per-cell path)."""
    try:
        dt = np.dtype(maybe_dtype)
    except TypeError:
        return None
    return None if dt.kind in 'OUSMm' else dt


def _chunk_span(meta_col):
    start = meta_col.data_page_offset
    if meta_col.has_dictionary_page and meta_col.dictionary_page_offset is not None \
            and 0 <= meta_col.dictionary_page_offset < start:
        start = meta_col.dictionary_page_offset
    return start, meta_col.total_compressed_size


def _qualify_chunk(meta_col, schema_col):
    """Chunk-level gate shared by every mode: ``(codec, has_def)`` or a
    reason string."""
    if schema_col.max_repetition_level != 0 or schema_col.max_definition_level > 1:
        return 'nesting'
    has_def = schema_col.max_definition_level == 1
    if has_def:
        stats = meta_col.statistics
        if stats is None or stats.null_count is None or stats.null_count != 0:
            return 'nullable'
    codec = CODEC_BY_NAME.get(meta_col.compression)
    if codec is None:
        return 'compression'
    if any(e not in _OK_ENCODINGS for e in meta_col.encodings):
        return 'encoding'
    return codec, has_def


def _logical_numeric_dtype(schema_col, phys):
    """Final numpy dtype of a fixed-width column judged from the Parquet
    LOGICAL type alone (no Unischema field): plain columns keep their
    physical dtype, INT-annotated ones narrow or unsign to the declared width
    (the stored int32/int64 are sign- or zero-extended, so a same-width
    ``astype`` recovers them exactly). Anything else (TIMESTAMP, DATE, TIME,
    DECIMAL) returns None: Arrow materializes those."""
    lt = getattr(schema_col, 'logical_type', None)
    lt_type = getattr(lt, 'type', 'NONE')
    if lt_type == 'NONE':
        return phys
    if lt_type != 'INT':
        return None
    try:
        import json
        spec = json.loads(lt.to_json())
        bits = int(spec.get('bitWidth', phys.itemsize * 8))
        signed = bool(spec.get('isSigned', True))
        return np.dtype('{}{}'.format('i' if signed else 'u', bits // 8))
    except Exception:  # noqa: BLE001 - odd annotation: the Arrow path decides
        return None


def _pagescan_eligible(meta_col):
    """True when the zero-copy VIEW path (``pagescan.py``) serves this chunk:
    uncompressed, dictionary-free, PLAIN-only. Fusing it would trade a view
    for a copy, so the default plan leaves it alone (reason ``pagescan``,
    which is not a fallback); the in-place ring mode fuses it anyway, where
    the one copy lands in the consumer's slot."""
    return (meta_col.compression == 'UNCOMPRESSED'
            and not meta_col.has_dictionary_page
            and all(e in ('PLAIN', 'RLE', 'BIT_PACKED') for e in meta_col.encodings))


def _plan_column(name, meta_col, schema_col, field, expected_rows, decode_hints,
                 resize_hints, include_pagescan=False):
    """ColumnPlan for one column, or a reason string when it must ride Arrow.
    ``field`` is the Unischema field (None for plain stores, where only
    numeric fixed-width columns fuse)."""
    gate = _qualify_chunk(meta_col, schema_col)
    if isinstance(gate, str):
        return gate
    codec, has_def = gate
    plan = ColumnPlan(name)
    plan.codec = codec
    plan.has_def = has_def
    plan.chunk_off, plan.chunk_len = _chunk_span(meta_col)
    if plan.chunk_len <= 0 or plan.chunk_off < 0:
        return 'parse'
    pt = meta_col.physical_type

    codec_obj = getattr(field, 'codec', None)
    codec_id = getattr(codec_obj, 'codec_id', None)

    if pt in _PHYS_DTYPE:
        if not include_pagescan and _pagescan_eligible(meta_col):
            return 'pagescan'
        phys = _PHYS_DTYPE[pt]
        if field is not None:
            if codec_id != 'scalar':
                return 'codec'
            dtype = _np_dtype(field.numpy_dtype)
            if dtype is None or dtype.kind not in 'iufb':
                return 'codec'  # str/Decimal/datetime flavors: per-cell path
            plan.field_dtype = dtype
        else:
            dtype = _logical_numeric_dtype(schema_col, phys)
            if dtype is None:
                return 'codec'
            plan.field_dtype = dtype
        plan.mode = MODE_FIXED
        plan.itemsize = phys.itemsize
        plan.phys_dtype = phys
        plan.out_dtype = phys
        plan.out_bound = expected_rows * phys.itemsize
        plan.out_shape = (expected_rows,)
        return plan

    if pt == 'FIXED_LEN_BYTE_ARRAY':
        if not include_pagescan and _pagescan_eligible(meta_col):
            return 'pagescan'
        if field is None or codec_id != 'raw_tensor':
            return 'codec'
        width = getattr(schema_col, 'length', 0)
        dtype = _np_dtype(field.numpy_dtype)
        shape = tuple(field.shape or ())
        if dtype is None or not width or any(d is None for d in shape):
            return 'codec'
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if count * dtype.itemsize != width:
            return 'codec'
        plan.mode = MODE_FIXED
        plan.itemsize = width
        plan.out_dtype = dtype
        plan.out_shape = (expected_rows,) + shape
        plan.out_bound = expected_rows * width
        return plan

    if pt == 'BYTE_ARRAY':
        if field is None:
            return 'codec'
        if codec_id == 'ndarray':
            plan.mode = MODE_BINARY_RAW
            plan.strip_npy = True
            plan.out_bound = meta_col.total_uncompressed_size
            plan.known_size = False
            return plan
        if codec_id == 'raw_tensor':
            # older stores wrote raw tensors as variable binary
            dtype = _np_dtype(field.numpy_dtype)
            shape = tuple(field.shape or ())
            if dtype is None or any(d is None for d in shape):
                return 'codec'
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            plan.mode = MODE_BINARY_RAW
            plan.itemsize = count * dtype.itemsize
            plan.out_dtype = dtype
            plan.out_shape = (expected_rows,) + shape
            plan.out_bound = expected_rows * plan.itemsize
            return plan
        if codec_id == 'compressed_image':
            from petastorm_tpu_torch.native import image_codec
            if not image_codec.is_available():
                return 'image-codec-unavailable'
            if (decode_hints or {}).get(name) or (resize_hints or {}).get(name):
                return 'image-hints'  # scaled or resized decode: the columnar path
            dtype = _np_dtype(field.numpy_dtype)
            shape = tuple(field.shape or ())
            if dtype != np.uint8 or any(d is None for d in shape) or len(shape) not in (2, 3):
                return 'codec'
            h, w = int(shape[0]), int(shape[1])
            c = int(shape[2]) if len(shape) == 3 else 1
            plan.mode = MODE_BINARY_IMG
            plan.img = (h, w, c)
            plan.out_dtype = np.dtype(np.uint8)
            plan.out_shape = (expected_rows,) + shape
            plan.out_bound = expected_rows * h * w * c
            return plan
        return 'codec'

    return 'physical-type'


def plan_row_group(pq_meta, flat_index, row_group, column_names, schema_fields,
                   decode_hints=None, resize_hints=None, include_pagescan=False):
    """Build the :class:`FusedPlan` for one row group. ``flat_index`` maps a
    flat top-level column name to its leaf index (nested columns are absent
    and fall back with reason ``nesting``); ``schema_fields`` maps field name
    -> Unischema field (None for plain stores). ``include_pagescan`` also
    fuses the columns the page scan would serve as views (the in-place ring
    mode)."""
    try:
        rg = pq_meta.row_group(row_group)
    except Exception:  # noqa: BLE001 - malformed metadata: the Arrow path decides
        return None
    expected_rows = rg.num_rows
    columns, rest, reasons = [], [], {}
    for name in column_names:
        idx = flat_index.get(name)
        if idx is None:
            rest.append(name)
            reasons[name] = 'nesting'
            continue
        try:
            field = schema_fields.get(name) if schema_fields is not None else None
            plan = _plan_column(name, rg.column(idx), pq_meta.schema.column(idx), field,
                                expected_rows, decode_hints, resize_hints,
                                include_pagescan=include_pagescan)
        except Exception as e:  # noqa: BLE001 - odd metadata: Arrow serves it
            logger.debug('fused qualification of %s failed (%s); Arrow path', name, e)
            plan = 'parse'
        if isinstance(plan, str):
            rest.append(name)
            reasons[name] = plan
        else:
            columns.append(plan)
    return FusedPlan(columns, rest, reasons, expected_rows)


def count_fallbacks(reasons):
    """One ``fused_fallback_total``, one ``fused_fallback_reason:<reason>``
    and one ``fused_fallback_column:<name>:<reason>`` per column that was not
    fused. ``pagescan`` is not a fallback: those columns are served as
    views."""
    for name, reason in reasons.items():
        if reason == 'pagescan':
            continue
        count_route('fused_fallback_total')
        count_route('fused_fallback_reason:{}'.format(reason))
        count_route('fused_fallback_column:{}:{}'.format(name, reason))


def _pred_domain(plan):
    """``(dtype_code, comparison dtype, logical dtype)`` for one predicate
    column plan, or None when the column's values cannot be compared natively
    (binary modes, FLBA tensors, non-numeric logicals). Integer comparisons
    run at the PHYSICAL width; they go unsigned only when the logical dtype is
    unsigned at full physical width: narrower unsigned logicals zero-extend
    into the positive signed range, where the signed compare is already
    exact."""
    phys = plan.phys_dtype
    if plan.mode != MODE_FIXED or phys is None or phys.itemsize != plan.itemsize:
        return None
    logical = plan.field_dtype or phys
    if logical.kind == 'u' and logical.itemsize == phys.itemsize:
        cmp_dtype = np.dtype('u{}'.format(phys.itemsize))
    else:
        cmp_dtype = phys
    code = _PRED_DTYPE_CODES.get((cmp_dtype.kind, cmp_dtype.itemsize))
    if code is None:
        return None
    return code, cmp_dtype, logical


def _pred_operand(value, logical, cmp_dtype):
    """``value`` encoded as ``cmp_dtype`` bytes, or None when it is not
    EXACTLY representable in the column's logical domain: the native compare
    must agree bit for bit with the numpy route, so a rounding cast is never
    acceptable."""
    try:
        v0 = np.asarray(value)
        if v0.shape != () or v0.dtype.kind not in 'iufb':
            return None
        with np.errstate(all='ignore'):
            c = v0.astype(logical)
            if not bool(c == v0):
                return None
            return c.astype(cmp_dtype).tobytes()
    except (TypeError, ValueError, OverflowError):
        return None


def compile_predicate(clauses, pred_index):
    """Map the clause dicts of ``PredicateBase.native_clauses`` onto a ctypes
    ``FusedPred`` array. ``pred_index`` maps a predicate column's name to
    ``(descriptor index, ColumnPlan)``. Returns ``(preds, keepalive)``, the
    struct array and the operand buffers it points into (they MUST stay
    referenced across the kernel call), or the string ``'predicate'`` when a
    clause's shape is not natively evaluable (the caller counts the fallback
    and takes the Python predicate route)."""
    entries = []
    keepalive = []
    for cl in clauses or ():
        hit = pred_index.get(cl.get('field'))
        if hit is None:
            return 'predicate'
        idx, plan = hit
        dom = _pred_domain(plan)
        if dom is None:
            return 'predicate'
        code, cmp_dtype, logical = dom
        w = cmp_dtype.itemsize
        e = {'col': idx, 'dtype': code, 'negate': 1 if cl.get('negate') else 0,
             'has_lo': 0, 'has_hi': 0, 'lo_incl': 0, 'hi_incl': 0}
        op = cl.get('op')
        if op == 'in':
            packed = set()
            for v in cl.get('values', ()):
                b = _pred_operand(v, logical, cmp_dtype)
                # an unrepresentable operand can never equal a column value:
                # dropping it is exact, as the numpy route agrees
                if b is not None:
                    packed.add(b)
            data = b''.join(sorted(packed))
            buf = np.frombuffer(bytearray(data or b'\x00'), dtype=np.uint8)
            e.update(op=PRED_IN, count=len(data) // w, values=buf)
        elif op == 'range':
            bounds = []
            for key, flag, incl in (('lo', 'has_lo', 'lo_incl'), ('hi', 'has_hi', 'hi_incl')):
                v = cl.get(key)
                if v is None:
                    bounds.append(b'\x00' * w)
                    continue
                b = _pred_operand(v, logical, cmp_dtype)
                if b is None:
                    return 'predicate'
                bounds.append(b)
                e[flag] = 1
                e[incl] = 1 if cl.get(key + '_incl', True) else 0
            buf = np.frombuffer(bytearray(b''.join(bounds)), dtype=np.uint8)
            e.update(op=PRED_RANGE, count=0, values=buf)
        else:
            return 'predicate'
        keepalive.append(e['values'])
        entries.append(e)
    if not entries:
        return 'predicate'
    preds = (FusedPredStruct * len(entries))()
    for p, e in zip(preds, entries):
        buf = e['values']
        p.values = buf.ctypes.data
        p.values_cap = buf.nbytes
        p.count = e['count']
        p.col = e['col']
        p.op = e['op']
        p.dtype = e['dtype']
        p.negate = e['negate']
        p.has_lo = e['has_lo']
        p.has_hi = e['has_hi']
        p.lo_incl = e['lo_incl']
        p.hi_incl = e['hi_incl']
    return preds, keepalive


def plan_predicate_columns(pq_meta, flat_index, row_group, pred_fields, schema_fields):
    """ColumnPlans of the predicate columns (always planned with
    ``include_pagescan``: a view cannot gate the collation) and the
    name -> (descriptor index, plan) map :func:`compile_predicate` takes.
    None when a predicate column does not qualify natively."""
    plan = plan_row_group(pq_meta, flat_index, row_group, list(pred_fields), schema_fields,
                          include_pagescan=True)
    if plan is None or plan.rest:
        return None
    index = {}
    for i, p in enumerate(plan.columns):
        if _pred_domain(p) is None:
            return None
        index[p.name] = (i, p)
    return plan.columns, index


def _invoke_read_fused(lib, descs, n_cols, n_threads, img_probe, img_decode):
    """THE single Python->C transition of a fused batch (ctypes releases the
    GIL for the call). Kept apart so a test can count the calls."""
    return lib.pstpu_read_fused(descs, n_cols, n_threads, MAX_PAGES, img_probe, img_decode)


def read_into(lib, chunks, plans, expected_rows, out_buf, offsets):
    """Run the fused kernel over ``plans``, writing each column at its offset
    in ``out_buf`` (a writable contiguous buffer). Returns one
    ``(status, out_used, aux0, aux1, npy_header)`` per column.

    ``chunks[i]`` is column i's chunk bytes as a numpy uint8 view over the
    mmapped file, anchored here for the call; the kernel re-checks every page
    and value region against the chunk and output capacities."""
    n = len(plans)
    descs = (FusedColStruct * n)()
    base = np.frombuffer(out_buf, dtype=np.uint8)
    total = base.nbytes
    aux_bufs = []
    has_img = any(p.mode == MODE_BINARY_IMG for p in plans)
    probe_addr = decode_addr = None
    if has_img:
        from petastorm_tpu_torch.native import image_codec
        addrs = image_codec.batch_fn_addrs()
        if addrs is None:
            return [(11, 0, 0, 0, b'')] * n  # image-probe: codec unavailable
        probe_addr, decode_addr = addrs
    for i, p in enumerate(plans):
        d = descs[i]
        # appended for every column, so aux_bufs stays index-aligned with descs
        aux = np.zeros(_AUX_BYTES, dtype=np.uint8)
        aux_bufs.append(aux)
        chunk = chunks[i]
        if chunk is None or chunk.nbytes != p.chunk_len or offsets[i] + p.out_bound > total:
            d.status = 8  # the planning bound does not hold (stale metadata): bounds
            continue
        d.chunk = chunk.ctypes.data
        d.chunk_len = p.chunk_len
        d.out = base.ctypes.data + offsets[i]
        d.out_cap = p.out_bound
        d.aux_buf = aux.ctypes.data
        d.aux_cap = aux.nbytes
        d.expected_rows = expected_rows
        d.mode = p.mode
        d.codec = p.codec
        d.itemsize = p.itemsize
        d.has_def_levels = 1 if p.has_def else 0
        d.strip_npy = 1 if p.strip_npy else 0
        if p.img is not None:
            d.img_h, d.img_w, d.img_c = p.img
        d.status = 0
    if has_img:
        from petastorm_tpu_torch.native import image_codec
        with image_codec._thread_grant(None) as grant:
            for i in range(n):
                descs[i].img_threads = grant
            _invoke_read_fused(lib, descs, n, _column_threads(n), probe_addr, decode_addr)
    else:
        _invoke_read_fused(lib, descs, n, _column_threads(n), None, None)
    return [(descs[i].status, descs[i].out_used, descs[i].aux0, descs[i].aux1,
             bytes(aux_bufs[i][:descs[i].aux1]) if descs[i].aux1 else b'')
            for i in range(n)]


def read_block(lib, chunks, plan, stage_args=None):
    """Allocate one contiguous batch buffer, run the fused kernel and build
    the numpy columns. Returns ``(block, reasons)``: the decoded columns, and
    the fallback reason of every column that did not decode (at planning or
    in the kernel); the counts go to ``read_routes``."""
    offsets, total = [], 0
    for p in plan.columns:
        offsets.append(total)
        total += p.out_bound
    out = np.empty(total, dtype=np.uint8)
    with obs.stage('fused_decode', cat='native', rows=plan.expected_rows, **(stage_args or {})):
        results = read_into(lib, chunks, plan.columns, plan.expected_rows, out, offsets)
    block = {}
    reasons = dict(plan.reasons)
    for p, res, off in zip(plan.columns, results, offsets):
        col = build_column(p, res, out, off, plan.expected_rows)
        if col is None:
            reasons[p.name] = REASON_BY_STATUS.get(res[0], 'post-validate')
        else:
            block[p.name] = col
    if block:
        count_route('fused_columns_total', len(block))
        count_route('fused_batches_total')
    count_fallbacks({n: r for n, r in reasons.items() if n not in block})
    return block, reasons


def _invoke_read_fused_pred(lib, descs, n_cols, pred_descs, n_pred_cols, preds, n_preds,
                            sel_ptr, sel_cap, total_rows, n_threads, img_probe, img_decode,
                            out_selected, out_skipped):
    """THE single Python->C transition of a filtered fused batch: predicate
    evaluation, page-stat skipping and the selected rows' collation all run
    in this one GIL-released call. Kept apart so a test can count the
    calls."""
    return lib.pstpu_read_fused_pred(
        descs, n_cols, pred_descs, n_pred_cols, preds, n_preds, sel_ptr, sel_cap, total_rows,
        n_threads, MAX_PAGES, img_probe, img_decode, out_selected, out_skipped)


def _fill_desc(d, plan, chunk, out_ptr, out_cap, aux, expected_rows):
    d.chunk = chunk.ctypes.data
    d.chunk_len = plan.chunk_len
    d.out = out_ptr
    d.out_cap = out_cap
    if aux is not None:
        d.aux_buf = aux.ctypes.data
        d.aux_cap = aux.nbytes
    d.expected_rows = expected_rows
    d.mode = plan.mode
    d.codec = plan.codec
    d.itemsize = plan.itemsize
    d.has_def_levels = 1 if plan.has_def else 0
    d.strip_npy = 1 if plan.strip_npy else 0
    if plan.img is not None:
        d.img_h, d.img_w, d.img_c = plan.img
    d.status = 0


def _narrow_plan(plan, full_rows, n_selected):
    """Shallow copy of ``plan`` with the row-dependent bounds rescaled from
    the planned full row group to the ``n_selected`` rows the gather kept."""
    q = ColumnPlan(plan.name)
    for slot in ColumnPlan.__slots__:
        setattr(q, slot, getattr(plan, slot))
    if plan.out_shape is not None:
        q.out_shape = (n_selected,) + tuple(plan.out_shape[1:])
    if plan.known_size and full_rows:
        q.out_bound = plan.out_bound // full_rows * n_selected
    return q


def read_block_pred(lib, chunks, plan, pred_chunks, pred_plans, preds, keepalive,
                    stage_args=None):
    """Filtered fused batch: evaluate the compiled predicate clauses over the
    predicate column chunks (skipping whole pages by their min/max
    statistics first), then collate ONLY the selected rows of every output
    column, in one GIL-released call.

    Returns ``(block, reasons, sel_mask, n_selected, pages_skipped)``, where
    ``sel_mask`` is the boolean row mask over the full row group that the
    caller filters the other routes' columns with; or None when the kernel
    declined (a clause or a predicate column failed natively): the caller
    then takes the unfused predicate route for the whole block."""
    rows = plan.expected_rows
    offsets, total = [], 0
    for p in plan.columns:
        offsets.append(total)
        total += p.out_bound
    out = np.empty(total, dtype=np.uint8)
    n = len(plan.columns)
    npred = len(pred_plans)
    if n == 0 or npred == 0 or len(preds) == 0:
        return None
    descs = (FusedColStruct * n)()
    pred_descs = (FusedColStruct * npred)()
    aux_bufs = []
    has_img = any(p.mode == MODE_BINARY_IMG for p in plan.columns)
    probe_addr = decode_addr = None
    if has_img:
        from petastorm_tpu_torch.native import image_codec
        addrs = image_codec.batch_fn_addrs()
        if addrs is None:
            return None
        probe_addr, decode_addr = addrs
    for i, p in enumerate(plan.columns):
        aux = np.zeros(_AUX_BYTES, dtype=np.uint8)
        aux_bufs.append(aux)
        chunk = chunks[i]
        if chunk is None or chunk.nbytes != p.chunk_len:
            return None
        _fill_desc(descs[i], p, chunk, out.ctypes.data + offsets[i], p.out_bound, aux, rows)
    for i, p in enumerate(pred_plans):
        chunk = pred_chunks[i]
        if chunk is None or chunk.nbytes != p.chunk_len:
            return None
        _fill_desc(pred_descs[i], p, chunk, None, 0, None, rows)
    sel = np.zeros((rows + 7) // 8 or 1, dtype=np.uint8)
    out_selected = ctypes.c_longlong(0)
    out_skipped = ctypes.c_longlong(0)
    with obs.stage('fused_predicate', cat='native', rows=rows, **(stage_args or {})):
        if has_img:
            from petastorm_tpu_torch.native import image_codec
            with image_codec._thread_grant(None) as grant:
                for i in range(n):
                    descs[i].img_threads = grant
                ret = _invoke_read_fused_pred(
                    lib, descs, n, pred_descs, npred, preds, len(preds), sel.ctypes.data,
                    sel.nbytes, rows, _column_threads(n), probe_addr, decode_addr,
                    ctypes.byref(out_selected), ctypes.byref(out_skipped))
        else:
            ret = _invoke_read_fused_pred(
                lib, descs, n, pred_descs, npred, preds, len(preds), sel.ctypes.data, sel.nbytes,
                rows, _column_threads(n), None, None, ctypes.byref(out_selected),
                ctypes.byref(out_skipped))
    # chunks, aux_bufs and the keepalive operand buffers were anchored
    # through the call
    del keepalive
    # the return counts FAILED OUTPUT COLUMNS: those fall back one by one to
    # the Arrow route below, as in the unfiltered read. Only a failed
    # predicate stage (a clause or a predicate column with a nonzero status)
    # voids the selection itself, and with it the whole block.
    if ret < 0:
        return None
    if any(pred_descs[i].status != 0 for i in range(npred)):
        return None
    if any(pr.status != 0 for pr in preds):
        return None
    n_selected = int(out_selected.value)
    pages_skipped = int(out_skipped.value)
    sel_mask = np.unpackbits(sel, bitorder='little')[:rows].astype(bool)
    block = {}
    reasons = dict(plan.reasons)
    if n_selected == 0:
        for p in plan.columns:
            if p.out_shape is None:
                # npy-stripped cells: the row shape shows only in a decoded
                # cell, and there is none; Arrow serves the column (zero rows
                # either way)
                reasons[p.name] = 'post-validate'
                continue
            dtype = p.field_dtype if p.field_dtype is not None else p.out_dtype
            block[p.name] = np.empty((0,) + tuple(p.out_shape[1:]), dtype=dtype)
    else:
        for i, p in enumerate(plan.columns):
            res = (descs[i].status, descs[i].out_used, descs[i].aux0, descs[i].aux1,
                   bytes(aux_bufs[i][:descs[i].aux1]) if descs[i].aux1 else b'')
            col = build_column(_narrow_plan(p, rows, n_selected), res, out, offsets[i],
                               n_selected)
            if col is None:
                reasons[p.name] = REASON_BY_STATUS.get(res[0], 'post-validate')
            else:
                block[p.name] = col
    count_fallbacks({n: r for n, r in reasons.items() if n not in block})
    if not block:
        return None  # nothing fused: the unfused predicate route is simpler
    count_route('fused_pred_batches_total')
    count_route('fused_pred_pages_skipped_total', pages_skipped)
    count_route('fused_pred_rows_selected', n_selected)
    count_route('fused_columns_total', len(block))
    count_route('fused_batches_total')
    return block, reasons, sel_mask, n_selected, pages_skipped


def _column_threads(n_cols):
    return max(1, min(n_cols, os.cpu_count() or 1))


def _parse_npy(header_bytes):
    """``(dtype, shape)`` from the np.save header the kernel copied out, or
    None (fortran order and non-standard headers take the per-cell path)."""
    from petastorm_tpu_torch.codecs import _parse_npy_header
    parsed = _parse_npy_header(header_bytes)
    if parsed is None:
        return None
    dtype, fortran, shape, _off = parsed
    if fortran:
        return None
    return dtype, shape


def column_region(plan, result, expected_rows):
    """``(dtype_str, row_shape, nbytes)`` of one decoded column's bytes in
    place (no array built): the layout a consumer needs to view a shared
    mapping directly. Mirrors :func:`build_column`'s checks; None rejects
    the column. Columns that need an ``astype`` after the decode decline:
    that conversion is a copy."""
    status, out_used, aux0, _aux1, aux_header = result
    if status != 0:
        return None
    if plan.mode == MODE_BINARY_RAW and plan.strip_npy:
        parsed = _parse_npy(aux_header)
        if parsed is None:
            return None
        dtype, shape = parsed
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if count * dtype.itemsize != aux0 or out_used != expected_rows * aux0:
            return None
        return dtype.str, (expected_rows,) + shape, out_used
    if plan.out_dtype is None or plan.out_shape is None:
        return None
    if plan.known_size and out_used != plan.out_bound:
        return None
    if plan.mode == MODE_BINARY_RAW and aux0 != plan.itemsize:
        return None
    if plan.field_dtype is not None and plan.field_dtype != plan.out_dtype:
        return None
    return plan.out_dtype.str, plan.out_shape, out_used


def build_column(plan, result, out_buf, offset, expected_rows):
    """numpy column for one decoded plan: a typed view over the batch buffer
    (fresh writable memory, so decode's writable-array contract holds with no
    copy). None when the checks after the decode reject the bytes; the caller
    then reads the column through Arrow."""
    status, out_used, aux0, _aux1, aux_header = result
    if status != 0:
        return None
    mv = memoryview(out_buf)
    if mv.readonly:
        # decode's contract hands out writable arrays: an immutable caller
        # buffer degrades to a copy, never to a read-only view
        mv = memoryview(bytearray(mv))
    region = mv[offset:offset + out_used]
    if plan.mode == MODE_BINARY_RAW and plan.strip_npy:
        parsed = _parse_npy(aux_header)
        if parsed is None:
            return None
        dtype, shape = parsed
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if count * dtype.itemsize != aux0 or out_used != expected_rows * aux0:
            return None
        arr = np.frombuffer(region, dtype=dtype)
        return arr.reshape((expected_rows,) + shape)
    if plan.out_dtype is None or plan.out_shape is None:
        return None
    if plan.known_size and out_used != plan.out_bound:
        return None
    if plan.mode == MODE_BINARY_RAW and aux0 != plan.itemsize:
        return None  # legacy raw cells must match the schema's cell width
    arr = np.frombuffer(region, dtype=plan.out_dtype).reshape(plan.out_shape)
    if plan.field_dtype is not None and plan.field_dtype != arr.dtype:
        arr = arr.astype(plan.field_dtype)
    return arr
