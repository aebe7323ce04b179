"""Unischema: one schema definition rendered to numpy / Arrow views.

Trimmed twin of ``petastorm_tpu/unischema.py``: the same JSON layout
(``to_json``/``from_json``) and field semantics, so a schema stored by either
package loads in the other. A field given no codec gets ``ScalarCodec`` when
it is a scalar and ``NdarrayCodec`` otherwise, as in the JAX package.
:meth:`Unischema.from_arrow_schema` infers a schema for a plain Parquet store
with the JAX package's type mapping.
"""

from __future__ import annotations

import re
from collections import OrderedDict, namedtuple
from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import (DataFieldCodec, NdarrayCodec, ScalarCodec, ScalarListCodec,
                                        codec_from_json)
from petastorm_tpu_torch.errors import SchemaError

_SPECIAL_DTYPE_TOKENS = {
    'string': np.str_,
    'bytes': np.bytes_,
    'decimal': Decimal,
    'bool': np.bool_,
    'datetime64': np.datetime64,
}


def _dtype_to_token(numpy_dtype):
    for token, t in _SPECIAL_DTYPE_TOKENS.items():
        if numpy_dtype is t:
            return token
    return np.dtype(numpy_dtype).str


def _token_to_dtype(token):
    if token in _SPECIAL_DTYPE_TOKENS:
        return _SPECIAL_DTYPE_TOKENS[token]
    return np.dtype(token).type


class UnischemaField(object):
    """A single field: name, numpy dtype, shape (``None`` entries are
    wildcards), codec, nullability. Equality ignores the codec."""

    __slots__ = ('name', 'numpy_dtype', 'shape', 'codec', 'nullable')

    def __init__(self, name, numpy_dtype, shape=(), codec=None, nullable=False):
        if codec is not None and not isinstance(codec, DataFieldCodec):
            raise SchemaError('codec for field {} must be a DataFieldCodec, got {!r}'.format(name, codec))
        self.name = name
        self.numpy_dtype = numpy_dtype if numpy_dtype is Decimal else np.dtype(numpy_dtype).type
        self.shape = tuple(shape) if shape is not None else None
        if codec is None:
            codec = ScalarCodec() if self.shape == () else NdarrayCodec()
        self.codec = codec
        self.nullable = bool(nullable)

    @property
    def is_scalar(self):
        return self.shape == ()

    def to_json(self):
        return {
            'name': self.name,
            'numpy_dtype': _dtype_to_token(self.numpy_dtype),
            'shape': list(self.shape) if self.shape is not None else None,
            'codec': self.codec.to_json(),
            'nullable': self.nullable,
        }

    @classmethod
    def from_json(cls, spec):
        return cls(
            name=spec['name'],
            numpy_dtype=_token_to_dtype(spec['numpy_dtype']),
            shape=tuple(spec['shape']) if spec['shape'] is not None else None,
            codec=codec_from_json(spec['codec']),
            nullable=spec['nullable'],
        )

    def _key(self):
        return (self.name, _dtype_to_token(self.numpy_dtype), self.shape, self.nullable)

    def __eq__(self, other):
        return isinstance(other, UnischemaField) and self._key() == other._key()

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return 'UnischemaField(name={!r}, numpy_dtype={}, shape={}, codec={!r}, nullable={})'.format(
            self.name, _dtype_to_token(self.numpy_dtype), self.shape, self.codec, self.nullable)


_NAMEDTUPLES = {}


def _namedtuple_type(parent_name, field_names):
    """Cached namedtuple type per (schema name, field names): repeated calls
    return the same type object."""
    key = (parent_name, tuple(field_names))
    if key not in _NAMEDTUPLES:
        _NAMEDTUPLES[key] = namedtuple(parent_name, field_names)
    return _NAMEDTUPLES[key]


class Unischema(object):
    """An ordered (name-sorted) collection of :class:`UnischemaField`."""

    def __init__(self, name, fields):
        self._name = name
        names = [f.name for f in fields]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise SchemaError('Duplicate field names in schema {}: {}'.format(name, dupes))
        self._fields = OrderedDict((f.name, f) for f in sorted(fields, key=lambda f: f.name))
        for f in self._fields.values():
            if not hasattr(self, f.name):
                setattr(self, f.name, f)

    @property
    def name(self):
        return self._name

    @property
    def fields(self):
        return self._fields

    def create_schema_view(self, fields_or_patterns):
        """Subset view by :class:`UnischemaField` instances, field names, or
        regex patterns (full-match)."""
        if isinstance(fields_or_patterns, str):
            fields_or_patterns = [fields_or_patterns]
        view_fields = []
        for item in fields_or_patterns:
            if isinstance(item, UnischemaField):
                own = self._fields.get(item.name)
                if own is None or own != item:
                    raise SchemaError('Field {!r} does not match schema {}'.format(item, self._name))
                view_fields.append(own)
            else:
                matched = match_unischema_fields(self, [item])
                if not matched:
                    raise SchemaError('Pattern {!r} matched no fields in schema {}'.format(item, self._name))
                view_fields.extend(matched)
        seen = set()
        unique = [f for f in view_fields if not (f.name in seen or seen.add(f.name))]
        return Unischema('{}_view'.format(self._name), unique)

    def make_namedtuple(self, **kwargs):
        return self.make_namedtuple_from_dict(kwargs)

    def make_namedtuple_from_dict(self, row_dict):
        """Build a row namedtuple from a dict holding every field."""
        return self.namedtuple(*[row_dict[f] for f in self._fields])

    @property
    def namedtuple(self):
        """The cached namedtuple type for rows of this schema."""
        return _namedtuple_type(self._name, list(self._fields))

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def __repr__(self):
        lines = ['Unischema({}, ['.format(self._name)]
        lines.extend('  {!r},'.format(f) for f in self._fields.values())
        lines.append('])')
        return '\n'.join(lines)

    def to_json(self):
        return {'name': self._name, 'fields': [f.to_json() for f in self._fields.values()]}

    @classmethod
    def from_json(cls, spec):
        return cls(spec['name'], [UnischemaField.from_json(f) for f in spec['fields']])

    def as_arrow_schema(self):
        """Physical Arrow schema of the Parquet files this Unischema writes."""
        return pa.schema([pa.field(f.name, f.codec.arrow_type(f), f.nullable)
                          for f in self._fields.values()])

    @classmethod
    def from_arrow_schema(cls, arrow_schema, name='inferred', omit_unsupported_fields=True):
        """A Unischema for a plain (non-petastorm) Parquet store: scalar
        columns become scalar fields, ``list`` columns 1-D variable-length
        fields. A column of another type (``fixed_size_list``, struct, map,
        ...) is left out, or raises without ``omit_unsupported_fields``."""
        fields = []
        for arrow_field in arrow_schema:
            try:
                fields.append(_unischema_field_from_arrow(arrow_field))
            except SchemaError:
                if not omit_unsupported_fields:
                    raise
        return cls(name, fields)


_ARROW_TO_NUMPY = {
    pa.int8(): np.int8, pa.uint8(): np.uint8,
    pa.int16(): np.int16, pa.uint16(): np.uint16,
    pa.int32(): np.int32, pa.uint32(): np.uint32,
    pa.int64(): np.int64, pa.uint64(): np.uint64,
    pa.float16(): np.float16, pa.float32(): np.float32, pa.float64(): np.float64,
    pa.bool_(): np.bool_,
    pa.string(): np.str_, pa.large_string(): np.str_,
    pa.binary(): np.bytes_, pa.large_binary(): np.bytes_,
    pa.date32(): np.datetime64, pa.date64(): np.datetime64,
}


def _numpy_from_arrow_type(arrow_type):
    if arrow_type in _ARROW_TO_NUMPY:
        return _ARROW_TO_NUMPY[arrow_type]
    if pa.types.is_timestamp(arrow_type):
        return np.datetime64
    if pa.types.is_decimal(arrow_type):
        return Decimal
    if pa.types.is_dictionary(arrow_type):
        return _numpy_from_arrow_type(arrow_type.value_type)
    raise SchemaError('Cannot map Arrow type {} to numpy'.format(arrow_type))


def _unischema_field_from_arrow(arrow_field):
    t = arrow_field.type
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return UnischemaField(arrow_field.name, _numpy_from_arrow_type(t.value_type), (None,),
                              ScalarListCodec(), arrow_field.nullable)
    return UnischemaField(arrow_field.name, _numpy_from_arrow_type(t), (), ScalarCodec(),
                          arrow_field.nullable)


def encode_row(schema, row_dict):
    """Encode an in-memory row dict into the Parquet storage representation,
    validating against the schema."""
    if not isinstance(row_dict, dict):
        raise SchemaError('row must be a dict, got {}'.format(type(row_dict)))
    unknown = set(row_dict) - set(schema.fields)
    if unknown:
        raise SchemaError('Row contains fields not in schema {}: {}'.format(schema.name, sorted(unknown)))
    encoded = {}
    for field in schema:
        if field.name not in row_dict and not field.nullable:
            raise SchemaError('Field {} is not nullable but is missing from the row'.format(field.name))
        value = row_dict.get(field.name)
        if value is None:
            if not field.nullable:
                raise SchemaError('Field {} is not nullable but got None'.format(field.name))
            encoded[field.name] = None
        else:
            encoded[field.name] = field.codec.encode(field, value)
    return encoded


def decode_row(row_dict, schema):
    """Decode a storage row dict into the in-memory representation."""
    decoded = {}
    for field_name, encoded in row_dict.items():
        field = schema.fields.get(field_name)
        if field is None:
            raise SchemaError('Row contains field {!r} not present in schema {}'.format(
                field_name, schema.name))
        decoded[field_name] = None if encoded is None else field.codec.decode(field, encoded)
    return decoded


def insert_explicit_nulls(schema, row_dict):
    """Add ``None`` in place for the nullable fields ``row_dict`` lacks;
    raise :class:`SchemaError` for a missing field that is not nullable."""
    for field in schema:
        if field.name not in row_dict:
            if not field.nullable:
                raise SchemaError('Field {} is not nullable but is missing from the row'.format(
                    field.name))
            row_dict[field.name] = None


def match_unischema_fields(schema, field_regex):
    """Fields whose names fully match any of the given regex patterns."""
    if isinstance(field_regex, str):
        field_regex = [field_regex]
    compiled = [re.compile(p) for p in field_regex]
    return [f for f in schema if any(p.fullmatch(f.name) for p in compiled)]
