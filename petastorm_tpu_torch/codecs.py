"""Field codecs: how a logical tensor/scalar field is stored in a Parquet column.

Twin of ``petastorm_tpu/codecs.py``. The codec ids and JSON params are the JAX
package's, so a schema written by either package decodes in the other:
``ScalarCodec``, ``NdarrayCodec``, ``RawTensorCodec``,
``CompressedNdarrayCodec``, ``ScalarListCodec`` and ``CompressedImageCodec``
with THE resize policy (:func:`_resize_image`) that every image decode path
shares. Images decode through the port's native batched decoder
(``native/image_codec.py``) where it builds, else per image through OpenCV;
:data:`image_routes` counts which route decoded and resized each image.
"""

from __future__ import annotations

import io
import re
import struct
from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.columnar import column_cells, stack_cells
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.native import RouteCounts, image_codec


def _import_cv2():
    import cv2

    # Parallelism comes from the reader's worker pool, one image per worker
    # thread. OpenCV's own thread pool on top of that oversubscribes the
    # cores and triples per-image decode latency under contention.
    if getattr(cv2, '_pstpu_threads_pinned', False) is False:
        try:
            cv2.setNumThreads(0)
        except AttributeError:
            pass
        cv2._pstpu_threads_pinned = True
    return cv2


#: the process's image route counts (read by ``chip_smoke.py``), images
#: decoded and resized per route, summed over every thread:
#:
#: - ``decode_native``: decoded by the native library (one call per column);
#: - ``decode_cv2``: decoded by ``cv2.imdecode`` in :meth:`CompressedImageCodec.decode`;
#: - ``decode_fallback``: cells of a column the native route refused or could
#:   not take, decoded per image instead (a subset of ``decode_cv2``);
#: - ``resize_cv2`` / ``resize_native`` / ``resize_numpy``: images resized by
#:   each route of :func:`_resize_image` or the fused native decode+resize.
image_routes = RouteCounts(('decode_native', 'decode_cv2', 'decode_fallback',
                            'resize_cv2', 'resize_native', 'resize_numpy'))

_CODEC_REGISTRY = {}


def register_codec(cls):
    """Class decorator registering a codec under its ``codec_id`` for JSON round-trip."""
    _CODEC_REGISTRY[cls.codec_id] = cls
    return cls


def codec_from_json(spec):
    """Reconstruct a codec from its JSON dict ``{"codec_id": ..., **params}``."""
    spec = dict(spec)
    codec_id = spec.pop('codec_id')
    if codec_id not in _CODEC_REGISTRY:
        raise SchemaError('Unknown codec id: {}'.format(codec_id))
    return _CODEC_REGISTRY[codec_id].from_json(spec)


class DataFieldCodec(object):
    """Abstract codec protocol."""

    codec_id = None

    #: Parquet column compression this codec's payloads want (``None`` = the
    #: dataset default; ``'none'`` for cells that are already compressed)
    preferred_column_compression = None

    def encode(self, field, value):
        raise NotImplementedError

    def decode(self, field, encoded):
        raise NotImplementedError

    def arrow_type(self, field):
        raise NotImplementedError

    def to_json(self):
        return {'codec_id': self.codec_id}

    @classmethod
    def from_json(cls, params):
        return cls(**params)

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(self.codec_id)

    def __repr__(self):
        return '{}()'.format(type(self).__name__)


_NUMPY_TO_ARROW = {
    np.int8: pa.int8(),
    np.uint8: pa.uint8(),
    np.int16: pa.int16(),
    np.uint16: pa.uint16(),
    np.int32: pa.int32(),
    np.uint32: pa.uint32(),
    np.int64: pa.int64(),
    np.uint64: pa.uint64(),
    np.float16: pa.float16(),
    np.float32: pa.float32(),
    np.float64: pa.float64(),
    np.bool_: pa.bool_(),
    np.str_: pa.string(),
    np.bytes_: pa.binary(),
    np.datetime64: pa.timestamp('ns'),
    Decimal: pa.string(),
}


def arrow_type_for_numpy(numpy_dtype):
    """Map a field's numpy dtype (a type object) to the Arrow storage type."""
    if numpy_dtype in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[numpy_dtype]
    dt = np.dtype(numpy_dtype)
    if dt.type in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[dt.type]
    raise SchemaError('No Arrow mapping for numpy dtype {}'.format(numpy_dtype))


@register_codec
class ScalarCodec(DataFieldCodec):
    """Stores a scalar in a typed Parquet column. ``dtype`` optionally
    overrides the field's numpy dtype for storage."""

    codec_id = 'scalar'

    def __init__(self, dtype=None):
        self._dtype = np.dtype(dtype).type if dtype is not None else None

    def _storage_dtype(self, field):
        return self._dtype or field.numpy_dtype

    def encode(self, field, value):
        if field.shape:
            raise SchemaError(
                'ScalarCodec can only encode scalars; field {} has shape {}'.format(field.name, field.shape))
        dtype = self._storage_dtype(field)
        if dtype is Decimal:
            return str(value)
        if dtype in (np.str_, np.bytes_):
            return value if not isinstance(value, np.generic) else value.item()
        if isinstance(value, np.ndarray):
            if value.shape != ():
                raise SchemaError('Field {} expects a scalar, got array of shape {}'.format(field.name, value.shape))
            value = value[()]
        if dtype is np.datetime64:
            return np.datetime64(value, 'ns')
        return dtype(value).item()

    def decode(self, field, encoded):
        dtype = field.numpy_dtype
        if dtype is Decimal:
            return Decimal(encoded)
        return dtype(encoded)

    def decode_column(self, field, column):
        """Whole-column decode of a numeric/bool Arrow column to one numpy
        array; ``None`` for flavors that need the per-cell path."""
        dtype = field.numpy_dtype
        if dtype is Decimal or dtype in (np.str_, np.bytes_, np.datetime64):
            return None
        if column.null_count:
            return None
        arr = column.to_numpy(zero_copy_only=False)
        if isinstance(arr, np.ndarray) and arr.dtype.kind in 'biuf':
            return arr.astype(np.dtype(dtype), copy=False)
        return None

    def arrow_type(self, field):
        return arrow_type_for_numpy(self._storage_dtype(field))

    def to_json(self):
        spec = {'codec_id': self.codec_id}
        if self._dtype is not None:
            spec['dtype'] = np.dtype(self._dtype).str
        return spec

    def __repr__(self):
        return 'ScalarCodec(dtype={})'.format(np.dtype(self._dtype).str if self._dtype else None)


def _require_ndarray(field, value):
    if not isinstance(value, np.ndarray):
        raise SchemaError('Field {} expects a numpy array, got {}'.format(field.name, type(value)))
    if value.dtype.type is not np.dtype(field.numpy_dtype).type:
        raise SchemaError('Field {} expects dtype {}, got {}'.format(
            field.name, np.dtype(field.numpy_dtype), value.dtype))
    _validate_shape(field, value.shape)


def _validate_shape(field, shape):
    """Shape compliance with ``None`` wildcards."""
    expected = field.shape
    if expected is None:
        return
    if len(shape) != len(expected):
        raise SchemaError('Field {} expects rank {} (shape {}), got shape {}'.format(
            field.name, len(expected), expected, shape))
    for actual_dim, expected_dim in zip(shape, expected):
        if expected_dim is not None and actual_dim != expected_dim:
            raise SchemaError('Field {} expects shape {}, got {}'.format(field.name, expected, shape))


@register_codec
class NdarrayCodec(DataFieldCodec):
    """Raw ``np.save`` bytes in a binary column."""

    codec_id = 'ndarray'

    def encode(self, field, value):
        _require_ndarray(field, value)
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(value))
        return buf.getvalue()

    def decode(self, field, encoded):
        arr = _fast_npy_decode(encoded)
        if arr is None:  # unusual header (e.g. structured dtype): general path
            arr = np.load(io.BytesIO(encoded), allow_pickle=False)
        return arr

    def decode_column(self, field, column):
        """Whole-column decode: the cells of a row group almost always carry
        one identical ``np.save`` header, so parse it once and copy each
        cell's payload into a preallocated ``[N, ...]`` output. ``None``
        (-> per-cell path) for nulls, ragged shapes or non-standard headers."""
        if column.null_count:
            return None
        cells = column_cells(column)
        if not cells:
            return None
        first = memoryview(cells[0])
        parsed = _parse_npy_header(first)
        if parsed is None:
            return None
        dtype, fortran, shape, data_off = parsed
        if fortran:
            return None
        count = 1
        for dim in shape:
            count *= dim
        cell_len = data_off + count * dtype.itemsize
        header = bytes(first[:data_off])
        out = np.empty((len(cells),) + shape, dtype=dtype)
        flat_out = out.reshape(len(cells), -1) if count else out.reshape(len(cells), 0)
        for i, cell in enumerate(cells):
            buf = memoryview(cell)
            if len(buf) != cell_len or bytes(buf[:data_off]) != header:
                return None  # mixed shapes/dtypes in this row group: generic path
            flat_out[i] = np.frombuffer(buf, dtype=dtype, count=count, offset=data_off)
        return out

    def arrow_type(self, field):
        return pa.binary()


# np.save v1/v2 headers are a repr'd dict padded with spaces; a regex parses
# them an order of magnitude faster than np.load's tokenizer
_NPY_MAGIC = b'\x93NUMPY'
_NPY_HEADER_RE = re.compile(
    rb"\{'descr': '([^']+)', 'fortran_order': (False|True), "
    rb"'shape': \(([0-9, ]*),?\), \}\s*")


def _parse_npy_header(buf):
    """``(dtype, fortran_order, shape, data_offset)`` of standard ``np.save``
    bytes; None if the header is non-standard."""
    if len(buf) < 12 or bytes(buf[:6]) != _NPY_MAGIC:
        return None
    major = buf[6]
    if major == 1:
        (hlen,) = struct.unpack('<H', buf[8:10])
        data_off = 10 + hlen
        header = bytes(buf[10:data_off])
    else:
        (hlen,) = struct.unpack('<I', buf[8:12])
        data_off = 12 + hlen
        header = bytes(buf[12:data_off])
    m = _NPY_HEADER_RE.match(header)
    if m is None:
        return None
    dtype = np.dtype(m.group(1).decode())
    fortran = m.group(2) == b'True'
    shape = tuple(int(x) for x in m.group(3).split(b',') if x.strip())
    return dtype, fortran, shape, data_off


def _fast_npy_decode(encoded):
    """Decode standard ``np.save`` bytes; None if the header is non-standard."""
    buf = memoryview(encoded)
    parsed = _parse_npy_header(buf)
    if parsed is None:
        return None
    dtype, fortran, shape, data_off = parsed
    count = 1
    for dim in shape:
        count *= dim
    if data_off + count * dtype.itemsize > len(buf):
        return None
    flat = np.frombuffer(buf, dtype=dtype, count=count, offset=data_off)
    # copy: decode() hands user transforms a writable array, as np.load does
    return flat.reshape(shape, order='F' if fortran else 'C').copy()


@register_codec
class RawTensorCodec(DataFieldCodec):
    """Fixed-shape tensors stored as raw little-endian C-order bytes in a
    fixed-size-binary column. Every cell has the same length, so the column's
    values buffer IS the contiguous ``[N, *shape]`` payload and whole-column
    decode is one reshape view. Requires a fully specified shape and a
    fixed-width numeric/bool dtype. Columnar decode returns a (possibly
    read-only) view into the Arrow column."""

    codec_id = 'raw_tensor'
    preferred_column_compression = 'none'

    @staticmethod
    def _cell_spec(field):
        dtype = np.dtype(field.numpy_dtype)
        if dtype.kind not in 'biuf':
            raise SchemaError('RawTensorCodec supports fixed-width numeric/bool dtypes; '
                              'field {} has dtype {}'.format(field.name, dtype))
        if dtype.byteorder == '>':
            raise SchemaError('RawTensorCodec stores little-endian; field {} has '
                              'big-endian dtype {}'.format(field.name, dtype))
        if field.shape is None or any(dim is None for dim in field.shape):
            raise SchemaError(
                'RawTensorCodec requires a fully-specified shape (no None dims); field {} '
                'has shape {}'.format(field.name, field.shape))
        count = 1
        for dim in field.shape:
            count *= dim
        return dtype, tuple(field.shape), count

    def encode(self, field, value):
        _require_ndarray(field, value)
        dtype, _, _ = self._cell_spec(field)
        return np.ascontiguousarray(value, dtype=dtype).tobytes()

    def decode(self, field, encoded):
        dtype, shape, count = self._cell_spec(field)
        if len(encoded) != count * dtype.itemsize:
            raise SchemaError('Field {}: raw cell is {} bytes, expected {} for shape {} '
                              'dtype {}'.format(field.name, len(encoded),
                                                count * dtype.itemsize, shape, dtype))
        return np.frombuffer(encoded, dtype=dtype, count=count).reshape(shape).copy()

    def decode_column(self, field, column):
        """Whole-column zero-copy decode: one reshape view over the Arrow
        values buffer (fixed-size binary, or plain binary of equal-length
        cells). ``None`` (-> per-cell path) for nulls or other storage."""
        if column.null_count:
            return None
        dtype, shape, count = self._cell_spec(field)
        cell_len = count * dtype.itemsize
        if column.num_chunks > 1:
            views = [self.decode_column(field, pa.chunked_array([c])) for c in column.chunks]
            if any(v is None for v in views):
                return None
            return np.concatenate(views, axis=0)
        if column.num_chunks == 0:
            return None
        col = column.chunk(0)
        n = len(col)
        if not n:
            return None
        if pa.types.is_fixed_size_binary(col.type):
            if col.type.byte_width != cell_len:
                return None
            payload = np.frombuffer(col.buffers()[1], dtype=np.uint8)[
                col.offset * cell_len: (col.offset + n) * cell_len]
            return payload.view(dtype).reshape((n,) + shape)
        if col.type not in (pa.binary(), pa.large_binary()):
            return None
        bufs = col.buffers()
        off_dtype = np.int64 if col.type == pa.large_binary() else np.int32
        offsets = np.frombuffer(bufs[1], dtype=off_dtype)[col.offset: col.offset + n + 1]
        if (np.diff(offsets) != cell_len).any():
            return None
        payload = np.frombuffer(bufs[2], dtype=np.uint8)[int(offsets[0]):int(offsets[-1])]
        return payload.view(dtype).reshape((n,) + shape)

    def arrow_type(self, field):
        dtype, _, count = self._cell_spec(field)
        return pa.binary(count * dtype.itemsize)


@register_codec
class CompressedNdarrayCodec(DataFieldCodec):
    """zlib-compressed ``np.savez_compressed`` bytes."""

    codec_id = 'compressed_ndarray'
    preferred_column_compression = 'none'  # cells are already zlib streams

    def encode(self, field, value):
        _require_ndarray(field, value)
        buf = io.BytesIO()
        np.savez_compressed(buf, arr=np.ascontiguousarray(value))
        return buf.getvalue()

    def decode(self, field, encoded):
        with np.load(io.BytesIO(encoded), allow_pickle=False) as npz:
            return npz['arr']

    def arrow_type(self, field):
        return pa.binary()


@register_codec
class ScalarListCodec(DataFieldCodec):
    """1-D variable-length array stored as a native Parquet LIST column."""

    codec_id = 'scalar_list'

    def encode(self, field, value):
        arr = np.asarray(value)
        if arr.ndim != 1:
            raise SchemaError('Field {} expects a 1-D array, got shape {}'.format(field.name, arr.shape))
        return arr.astype(np.dtype(field.numpy_dtype), copy=False).tolist()

    def decode(self, field, encoded):
        return np.asarray(encoded, dtype=np.dtype(field.numpy_dtype))

    def decode_column(self, field, column):
        """Whole-column decode of a LIST column whose rows have one length:
        one reshape over the flattened Arrow values. ``None`` (-> per-cell
        path) for ragged or null flavors."""
        if column.null_count:
            return None
        col = column.combine_chunks()
        offs = col.offsets.to_numpy()
        if len(offs) < 2:
            return None
        lens = np.diff(offs)
        if (lens != lens[0]).any() or col.values.null_count:
            return None
        vals = col.values.to_numpy(zero_copy_only=False)
        if not isinstance(vals, np.ndarray) or vals.dtype.kind not in 'biuf':
            return None
        out = vals[offs[0]:offs[-1]].reshape(len(lens), int(lens[0]))
        return out.astype(np.dtype(field.numpy_dtype), copy=False)

    def arrow_type(self, field):
        return pa.list_(arrow_type_for_numpy(field.numpy_dtype))


def _area_weights(in_len, out_len):
    """``[out_len, in_len]`` row-stochastic pixel-coverage matrix (the area
    resampling kernel as an explicit matmul; the plain route)."""
    scale = in_len / out_len
    w = np.zeros((out_len, in_len), np.float32)
    for o in range(out_len):
        lo, hi = o * scale, min((o + 1) * scale, in_len)
        s = min(in_len - 1, int(lo))
        e = min(in_len, max(s + 1, int(np.ceil(hi))))
        for p in range(s, e):
            w[o, p] = max(0.0, min(p + 1, hi) - max(p, lo))
        total = w[o].sum()
        if total:
            w[o] /= total
    return w


def _bilinear_weights(in_len, out_len):
    """``[out_len, in_len]`` row-stochastic bilinear matrix (half-pixel
    centers, cv2 ``INTER_LINEAR`` semantics; the plain route)."""
    scale = in_len / out_len
    w = np.zeros((out_len, in_len), np.float32)
    for o in range(out_len):
        f = (o + 0.5) * scale - 0.5
        i = int(np.floor(f))
        frac = f - i
        if i < 0:
            i, frac = 0, 0.0
        if i >= in_len - 1:
            i, frac = (in_len - 2, 1.0) if in_len >= 2 else (0, 0.0)
        w[o, i] = 1.0 - frac
        if in_len >= 2:
            w[o, i + 1] += frac
    return w


def _resample_numpy(img, out_h, out_w, weights_fn):
    """Pure-numpy separable resample, any dtype: the route where neither cv2
    nor the native resampler takes the image. Clarity over speed."""
    wy = weights_fn(img.shape[0], out_h)
    wx = weights_fn(img.shape[1], out_w)
    arr = img.astype(np.float32)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    out = np.einsum('yh,hwc,xw->yxc', wy, arr, wx)
    if img.dtype.kind in 'iu':
        out = np.clip(np.rint(out), 0, np.iinfo(img.dtype).max)
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out


def _area_resize_numpy(img, out_h, out_w):
    return _resample_numpy(img, out_h, out_w, _area_weights)


def _bilinear_resize_numpy(img, out_h, out_w):
    return _resample_numpy(img, out_h, out_w, _bilinear_weights)


def _mild_ratio(in_h, in_w, out_h, out_w):
    """True when bilinear is the right filter: any upscaled axis, or both-axis
    decimation under 2x, where a box (area) filter spans at most 2 source
    pixels per axis and has bilinear's support. Mixed down+up shapes go
    bilinear on every route: area's anti-aliasing needs decimation on both
    axes, and there the native area resampler diverges from cv2 INTER_AREA,
    while a store must decode the same with or without OpenCV. Scaled JPEG
    decode lands here by construction (the covering m/8 scale is under 2x
    the target). The native library mirrors this test (``mild_ratio``)."""
    if out_h > in_h or out_w > in_w:
        return True
    return in_h < 2 * out_h and in_w < 2 * out_w


def _resize_image(img, out_h, out_w, dst=None):
    """THE resize policy, shared by every decode path so they cannot drift:
    area for real decimation (2x or more on either axis), bilinear for mild
    ratios (:func:`_mild_ratio`). cv2 (SIMD) when present, else the native
    resampler (uint8), else numpy (any dtype). ``dst`` writes the result into
    a preallocated row of a block."""
    if img.shape[:2] == (out_h, out_w):
        if dst is None:
            return img
        dst[...] = img
        return dst
    mild = _mild_ratio(img.shape[0], img.shape[1], out_h, out_w)
    try:
        cv2 = _import_cv2()
    except ImportError:
        cv2 = None
    if cv2 is not None:
        image_routes.add('resize_cv2')
        interp = cv2.INTER_LINEAR if mild else cv2.INTER_AREA
        if dst is not None:
            cv2.resize(img, (out_w, out_h), dst=dst, interpolation=interp)
            return dst
        return cv2.resize(img, (out_w, out_h), interpolation=interp)
    if img.dtype == np.uint8 and image_codec.is_available():
        image_routes.add('resize_native')
        native = image_codec.resize_bilinear_image if mild else image_codec.resize_area_image
        out = native(img, (out_h, out_w))
    else:
        image_routes.add('resize_numpy')
        out = (_bilinear_resize_numpy if mild else _area_resize_numpy)(img, out_h, out_w)
    if dst is None:
        return out
    dst[...] = out
    return dst


@register_codec
class CompressedImageCodec(DataFieldCodec):
    """png/jpeg image compression.

    Accepts uint8 (and uint16 for png) HxW or HxWx3 arrays in RGB channel
    order; handles the RGB<->BGR swap around OpenCV internally. Encoding
    needs OpenCV; decoding takes the native batched decoder where it builds
    and takes the image, else OpenCV per image.
    """

    codec_id = 'compressed_image'
    preferred_column_compression = 'none'  # cells are already png/jpeg streams
    #: TransformSpec.image_resize only works on fields whose codec declares
    #: this (transform_schema checks it)
    supports_image_resize = True
    #: the row worker passes decode hints and the resize target to
    #: decode_column
    decode_column_accepts_hints = True

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise SchemaError('Unsupported image codec: {}'.format(image_codec))
        self._format = 'jpeg' if image_codec == 'jpg' else image_codec
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._format

    @property
    def quality(self):
        return self._quality

    def encode(self, field, value):
        cv2 = _import_cv2()
        _require_ndarray(field, value)
        if value.dtype.type not in (np.uint8, np.uint16):
            raise SchemaError('Image codec supports uint8/uint16, got {}'.format(value.dtype))
        if self._format == 'jpeg' and value.dtype.type is np.uint16:
            raise SchemaError('jpeg does not support uint16 images')
        if value.ndim == 3 and value.shape[2] == 3:
            value = cv2.cvtColor(value, cv2.COLOR_RGB2BGR)
        elif value.ndim not in (2, 3):
            raise SchemaError('Image must be HxW or HxWxC, got shape {}'.format(value.shape))
        if self._format == 'png':
            ok, contents = cv2.imencode('.png', value)
        else:
            ok, contents = cv2.imencode('.jpeg', value, [int(cv2.IMWRITE_JPEG_QUALITY), self._quality])
        if not ok:
            raise SchemaError('Image encoding failed for field {}'.format(field.name))
        return contents.tobytes()

    def decode(self, field, encoded):
        cv2 = _import_cv2()
        image = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
        if image is None:
            raise SchemaError('Image decoding failed for field {}'.format(field.name))
        image_routes.add('decode_cv2')
        if image.ndim == 3 and image.shape[2] == 3:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        return image.astype(np.dtype(field.numpy_dtype), copy=False)

    def decode_column(self, field, column, min_size=None, resize=None):
        """Whole-column native decode with ONE header probe: straight into one
        ``[N, H, W(, C)]`` block when every cell probes to the same dims,
        else per-image arrays stacked to an object column.
        ``resize=(out_h, out_w)`` (``TransformSpec.image_resize``) brings
        every image to that size in the same pass (:meth:`_decode_column_resized`).
        ``None`` defers to :meth:`decode_batch` (nulls, a refused cell, no
        native library)."""
        if column.null_count or not image_codec.is_available():
            return None
        cells = column_cells(column)
        if not cells:
            return None
        dtype = np.dtype(field.numpy_dtype)
        try:
            if resize is not None:
                return self._decode_column_resized(cells, resize, dtype, min_size)
            decoded = image_codec.decode_images_auto(cells, min_size=min_size)
        except (image_codec.NativeDecodeError, MemoryError):
            return None
        image_routes.add('decode_native', len(cells))
        if isinstance(decoded, np.ndarray):
            return decoded.astype(dtype, copy=False)
        return stack_cells([img.astype(dtype, copy=False) for img in decoded])

    @staticmethod
    def _decode_column_resized(cells, resize, dtype, min_size=None):
        """Native single-probe decode (JPEG at the DCT scale covering
        ``min_size``, an explicit decode hint, or else the resize target),
        then cv2 per image straight into the rows of one ``[N, out_h, out_w(,
        C)]`` block: cv2's SIMD resize beats the native scalar resampler, so
        the fully native fused path (:func:`decode_images_resized`) serves
        only hosts without OpenCV."""
        out_h, out_w = int(resize[0]), int(resize[1])
        try:
            _import_cv2()
        except ImportError:
            block = image_codec.decode_images_resized(cells, resize, min_size=min_size)
            if block is None:
                return None
            image_routes.add('decode_native', len(cells))
            image_routes.add('resize_native', len(cells))
            return block.astype(dtype, copy=False)
        decoded = image_codec.decode_images_auto(cells, min_size=min_size or resize)
        image_routes.add('decode_native', len(cells))
        if isinstance(decoded, np.ndarray):
            if decoded.shape[1:3] == (out_h, out_w):
                return decoded.astype(dtype, copy=False)
            imgs = list(decoded)
        else:
            imgs = decoded
        if any(img.dtype != np.uint8 for img in imgs):
            return None  # 16-bit: the per-image path converts the dtype
        channels = {img.shape[2] if img.ndim == 3 else 1 for img in imgs}
        if len(channels) != 1:
            return None  # mixed gray/RGB cannot share one block
        c = channels.pop()
        out = np.empty((len(imgs), out_h, out_w) + ((c,) if c > 1 else ()), np.uint8)
        for i, img in enumerate(imgs):
            _resize_image(img, out_h, out_w, dst=out[i])
        return out.astype(dtype, copy=False)

    def decode_batch(self, field, encoded_list, min_size=None, resize=None):
        """Decode a column of image cells in one native call (GIL released,
        RGB pixels straight into numpy memory). Cells the native route refuses
        (palette/alpha PNG, CMYK JPEG, a format the build lacks) or a host
        without the native library decode per image through OpenCV; without
        OpenCV that raises, naming both routes. ``None`` cells pass through.

        ``min_size=(min_h, min_w)`` (``TransformSpec.image_decode_hints``)
        enables scaled JPEG decode on the native route; OpenCV decodes full
        size, still at least the hint. ``resize=(out_h, out_w)``
        (``TransformSpec.image_resize``) brings every image to exactly that
        size through :func:`_resize_image`."""
        present = [(i, v) for i, v in enumerate(encoded_list) if v is not None]
        out = [None] * len(encoded_list)
        if not present:
            return out
        if resize is not None and min_size is None:
            min_size = resize
        decoded, refusal = None, 'the native image codec did not build or load'
        if image_codec.is_available():
            try:
                decoded = image_codec.decode_images([v for _, v in present], min_size=min_size)
            except (image_codec.NativeDecodeError, MemoryError) as e:
                # MemoryError: a corrupt header can claim huge dims and blow
                # the output allocation; retry per image like any other bad cell
                refusal = str(e) or type(e).__name__
        if decoded is None:
            try:
                _import_cv2()
            except ImportError:
                raise SchemaError('Cannot decode field {}: {}, and OpenCV (cv2) is not '
                                  'installed for the per-image route'.format(field.name, refusal))
            image_routes.add('decode_fallback', len(present))
            decoded = [self.decode(field, v) for _, v in present]
        else:
            image_routes.add('decode_native', len(present))
            dtype = np.dtype(field.numpy_dtype)
            decoded = [img.astype(dtype, copy=False) for img in decoded]
        if resize is not None:
            out_h, out_w = int(resize[0]), int(resize[1])
            decoded = [_resize_image(img, out_h, out_w) for img in decoded]
        for (i, _), img in zip(present, decoded):
            out[i] = img
        return out

    def arrow_type(self, field):
        return pa.binary()

    def to_json(self):
        return {'codec_id': self.codec_id, 'image_codec': self._format, 'quality': self._quality}

    def __repr__(self):
        return 'CompressedImageCodec(image_codec={!r}, quality={})'.format(self._format, self._quality)
