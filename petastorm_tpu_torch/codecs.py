"""Field codecs: how a logical tensor/scalar field is stored in a Parquet column.

Trimmed twin of ``petastorm_tpu/codecs.py``. The codec ids and JSON params are
the JAX package's, so a schema written by either package decodes in the other.
Ported: ``ScalarCodec`` and ``RawTensorCodec`` (the decode-free raw-store path).
The other ids are known but not ported yet: a schema that names one raises
:class:`SchemaError` when it is loaded.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.errors import SchemaError

_CODEC_REGISTRY = {}

#: codec ids of the JAX package that this package cannot decode yet
#: (ROADMAP "Modules to port")
_NOT_YET_PORTED = ('ndarray', 'compressed_ndarray', 'compressed_image', 'scalar_list')


def register_codec(cls):
    """Class decorator registering a codec under its ``codec_id`` for JSON round-trip."""
    _CODEC_REGISTRY[cls.codec_id] = cls
    return cls


def codec_from_json(spec):
    """Reconstruct a codec from its JSON dict ``{"codec_id": ..., **params}``."""
    spec = dict(spec)
    codec_id = spec.pop('codec_id')
    if codec_id in _NOT_YET_PORTED:
        raise SchemaError('Codec {!r} is not yet ported to petastorm_tpu_torch (see ROADMAP.md); '
                          'store the field with RawTensorCodec or ScalarCodec'.format(codec_id))
    if codec_id not in _CODEC_REGISTRY:
        raise SchemaError('Unknown codec id: {}'.format(codec_id))
    return _CODEC_REGISTRY[codec_id].from_json(spec)


class DataFieldCodec(object):
    """Abstract codec protocol."""

    codec_id = None

    #: Parquet column compression this codec's payloads want (``None`` = the
    #: dataset default)
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
    expected = field.shape
    if expected is None:
        return
    if len(value.shape) != len(expected) or any(
            e is not None and a != e for a, e in zip(value.shape, expected)):
        raise SchemaError('Field {} expects shape {}, got {}'.format(field.name, expected, value.shape))


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
