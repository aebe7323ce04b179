"""Built-in row-group indexers (twin of ``petastorm_tpu/etl/rowgroup_indexers.py``).

Each serializes to the same JSON as its JAX twin under the same
``indexer_type``, so an index built by either package is read by the other.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.indexer_base import RowGroupIndexerBase

_INDEXER_REGISTRY = {}


def register_indexer(cls):
    _INDEXER_REGISTRY[cls.indexer_type] = cls
    return cls


def indexer_from_json(spec):
    spec = dict(spec)
    indexer_type = spec.pop('indexer_type')
    if indexer_type not in _INDEXER_REGISTRY:
        raise PetastormTpuError('Unknown indexer type {!r}'.format(indexer_type))
    return _INDEXER_REGISTRY[indexer_type].from_json(spec)


def _json_key(value):
    """Normalize an indexed value to a JSON-stable string key."""
    if isinstance(value, bytes):
        value = value.decode('utf-8', errors='replace')
    if isinstance(value, np.generic):
        value = value.item()
    return str(value)


@register_indexer
class SingleFieldIndexer(RowGroupIndexerBase):
    """value-of-field -> set of piece indexes. Array fields index every
    element of the array."""

    indexer_type = 'single_field'

    def __init__(self, index_name, index_field, index_dict=None):
        self._index_name = index_name
        self._column_name = index_field
        self._index_dict = {k: set(v) for k, v in (index_dict or {}).items()}

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._column_name]

    @property
    def indexed_values(self):
        return list(self._index_dict.keys())

    def get_row_group_indexes(self, value_key):
        return self._index_dict.get(_json_key(value_key), set())

    def build_index(self, decoded_rows, piece_index):
        if not decoded_rows:
            raise PetastormTpuError('Cannot build index for empty rows set')
        for row in decoded_rows:
            value = row[self._column_name] if isinstance(row, dict) else getattr(row, self._column_name)
            if value is None:
                continue
            if isinstance(value, np.ndarray):
                for element in value.flat:
                    self._index_dict.setdefault(_json_key(element), set()).add(piece_index)
            else:
                self._index_dict.setdefault(_json_key(value), set()).add(piece_index)
        return self._index_dict

    def __add__(self, other):
        if not isinstance(other, SingleFieldIndexer) or other._column_name != self._column_name:
            raise PetastormTpuError('Cannot merge indexers of different fields')
        merged = SingleFieldIndexer(self._index_name, self._column_name)
        merged._index_dict = {k: set(v) for k, v in self._index_dict.items()}
        for k, v in other._index_dict.items():
            merged._index_dict.setdefault(k, set()).update(v)
        return merged

    def to_json(self):
        return {'indexer_type': self.indexer_type,
                'index_name': self._index_name,
                'index_field': self._column_name,
                'index_dict': {k: sorted(v) for k, v in self._index_dict.items()}}

    @classmethod
    def from_json(cls, spec):
        return cls(spec['index_name'], spec['index_field'], spec['index_dict'])


@register_indexer
class FieldNotNullIndexer(RowGroupIndexerBase):
    """Indexes pieces where the field is not null."""

    indexer_type = 'field_not_null'
    _KEY = 'not_null'

    def __init__(self, index_name, index_field, piece_indexes=None):
        self._index_name = index_name
        self._column_name = index_field
        self._pieces = set(piece_indexes or ())

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._column_name]

    @property
    def indexed_values(self):
        return [self._KEY]

    def get_row_group_indexes(self, value_key=None):
        return set(self._pieces)

    def build_index(self, decoded_rows, piece_index):
        if not decoded_rows:
            raise PetastormTpuError('Cannot build index for empty rows set')
        for row in decoded_rows:
            value = row[self._column_name] if isinstance(row, dict) else getattr(row, self._column_name)
            if value is not None:
                self._pieces.add(piece_index)
                break
        return self._pieces

    def __add__(self, other):
        if not isinstance(other, FieldNotNullIndexer) or other._column_name != self._column_name:
            raise PetastormTpuError('Cannot merge indexers of different fields')
        return FieldNotNullIndexer(self._index_name, self._column_name, self._pieces | other._pieces)

    def to_json(self):
        return {'indexer_type': self.indexer_type,
                'index_name': self._index_name,
                'index_field': self._column_name,
                'piece_indexes': sorted(self._pieces)}

    @classmethod
    def from_json(cls, spec):
        return cls(spec['index_name'], spec['index_field'], spec['piece_indexes'])
