"""Read stores written by the ORIGINAL petastorm library.

Twin of ``petastorm_tpu/etl/legacy.py``. The original library keeps its
Unischema pickled in ``_common_metadata`` under ``dataset-toolkit.unischema.v1``,
with its per-file row-group counts (JSON) and its row-group indexes (pickled)
under sibling keys. Its row payloads (``np.save`` cells, npz, PNG/JPEG, typed
scalars) are the port's codecs' formats already, so only the metadata needs
translating.

The pickles are decoded without petastorm or pyspark installed and without
running arbitrary code: a restricted unpickler maps the original library's
class names (and the older package names it migrates between) onto local
shims and refuses everything outside its allowlist. The shims are then
converted to the port's :class:`~petastorm_tpu_torch.unischema.Unischema`,
codecs and indexers.
"""

from __future__ import annotations

import copyreg
import importlib
import io
import json
import logging
import pickle
from collections import OrderedDict, defaultdict
from decimal import Decimal

import numpy as np

logger = logging.getLogger(__name__)

#: the metadata keys the original library writes
REF_UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'
REF_ROW_GROUPS_PER_FILE_KEY = b'dataset-toolkit.num_row_groups_per_file.v1'
REF_ROW_GROUP_INDEX_KEY = b'dataset-toolkit.rowgroups_index.v1'

#: the package names the original library's pickles may carry
_SCHEMA_MODULES = ('petastorm', 'dataset_toolkit',
                   'av.experimental.deepdrive.dataset_toolkit', 'av.ml.dataset_toolkit')


class _Shim(object):
    """An instance rebuilt from a foreign pickle: a plain attribute bag. It
    takes every reconstruction path (NEWOBJ with or without arguments,
    ``copyreg._reconstructor``, BUILD with a state dict)."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj._ctor_args = args
        obj._ctor_kwargs = kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass


class _RefUnischema(_Shim):
    pass


class _RefUnischemaField(tuple):
    """The original ``UnischemaField`` is a namedtuple (name, numpy_dtype,
    shape, codec, nullable): a tuple subclass survives both NEWOBJ and
    ``copyreg._reconstructor(cls, tuple, values)``."""

    def __new__(cls, *args):
        # NEWOBJ passes the five fields; _reconstructor one tuple of them
        if len(args) == 1 and isinstance(args[0], tuple):
            args = args[0]
        return tuple.__new__(cls, args)

    @property
    def _ctor_args(self):
        return tuple(self)


class _RefScalarCodec(_Shim):
    pass


class _RefNdarrayCodec(_Shim):
    pass


class _RefCompressedNdarrayCodec(_Shim):
    pass


class _RefCompressedImageCodec(_Shim):
    pass


class _RefSingleFieldIndexer(_Shim):
    pass


class _RefFieldNotNullIndexer(_Shim):
    pass


class _SparkTypeStub(_Shim):
    """Stands in for any ``pyspark.sql.types`` instance (pyspark need not be
    installed); the conversion looks at the class name only."""
    spark_type_name = None


_CODEC_SHIMS = {
    'ScalarCodec': _RefScalarCodec,
    'NdarrayCodec': _RefNdarrayCodec,
    'CompressedNdarrayCodec': _RefCompressedNdarrayCodec,
    'CompressedImageCodec': _RefCompressedImageCodec,
}

_NUMPY_ALLOWED = {
    'bool_', 'int8', 'int16', 'int32', 'int64', 'uint8', 'uint16', 'uint32',
    'uint64', 'float16', 'float32', 'float64', 'str_', 'unicode_', 'bytes_',
    'string_', 'object_', 'datetime64', 'timedelta64', 'dtype', 'ndarray',
}

_BUILTINS_ALLOWED = {'object': object, 'set': set, 'frozenset': frozenset}

_spark_type_stubs = {}


def _spark_type_stub(name):
    if name not in _spark_type_stubs:
        _spark_type_stubs[name] = type(name, (_SparkTypeStub,), {'spark_type_name': name})
    return _spark_type_stubs[name]


def _numpy_multiarray():
    try:
        return importlib.import_module('numpy._core.multiarray')
    except ImportError:
        return importlib.import_module('numpy.core.multiarray')


class _RestrictedUnpickler(pickle.Unpickler):
    """Only the original library's schema, codec and indexer classes,
    pyspark type names, numpy scalar types and plain containers may appear
    in the stream."""

    def find_class(self, module, name):
        for pkg in _SCHEMA_MODULES:
            if module in (pkg + '.unischema', pkg + '.sequence'):
                if name == 'Unischema':
                    return _RefUnischema
                if name == 'UnischemaField':
                    return _RefUnischemaField
            if module == pkg + '.codecs' and name in _CODEC_SHIMS:
                return _CODEC_SHIMS[name]
            if module in (pkg + '.etl.rowgroup_indexers', pkg + '.rowgroup_indexers'):
                if name == 'SingleFieldIndexer':
                    return _RefSingleFieldIndexer
                if name == 'FieldNotNullIndexer':
                    return _RefFieldNotNullIndexer
        if module == 'pyspark.sql.types':
            return _spark_type_stub(name)
        if module == 'numpy' and name in _NUMPY_ALLOWED:
            return getattr(np, name)
        if module in ('numpy.core.multiarray', 'numpy._core.multiarray') and \
                name in ('scalar', '_reconstruct'):
            return getattr(_numpy_multiarray(), name)
        if module == 'collections' and name in ('OrderedDict', 'defaultdict'):
            return {'OrderedDict': OrderedDict, 'defaultdict': defaultdict}[name]
        if module == 'decimal' and name == 'Decimal':
            return Decimal
        if module in ('copy_reg', 'copyreg') and name == '_reconstructor':
            return copyreg._reconstructor
        if module in ('__builtin__', 'builtins') and name in _BUILTINS_ALLOWED:
            return _BUILTINS_ALLOWED[name]
        raise pickle.UnpicklingError(
            'Refusing to depickle {}.{} from legacy petastorm metadata'.format(module, name))


def restricted_loads(data):
    """Unpickle ``data`` through the allowlist; anything else raises
    :class:`pickle.UnpicklingError`."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _convert_codec(shim):
    from petastorm_tpu_torch import codecs

    if shim is None:
        return None
    if isinstance(shim, _RefScalarCodec):
        return codecs.ScalarCodec()
    if isinstance(shim, _RefNdarrayCodec):
        return codecs.NdarrayCodec()
    if isinstance(shim, _RefCompressedNdarrayCodec):
        return codecs.CompressedNdarrayCodec()
    if isinstance(shim, _RefCompressedImageCodec):
        # the original stores '.png'/'.jpeg', with the dot
        state = shim.__dict__
        fmt = state.get('_image_codec', '.png').lstrip('.')
        return codecs.CompressedImageCodec(fmt, quality=state.get('_quality', 80))
    raise pickle.UnpicklingError('Unknown legacy codec shim {!r}'.format(shim))


def _convert_field(shim):
    from petastorm_tpu_torch.unischema import UnischemaField

    name, numpy_dtype, shape, codec, nullable = (tuple(shim._ctor_args) + (None, False))[:5]
    return UnischemaField(name, numpy_dtype, shape, codec=_convert_codec(codec),
                          nullable=nullable)


def convert_unischema(shim):
    """An original ``Unischema`` shim -> the port's :class:`Unischema`."""
    from petastorm_tpu_torch.unischema import Unischema

    state = shim.__dict__
    fields = [f for f in state.get('_fields', {}).values() if isinstance(f, _RefUnischemaField)]
    return Unischema(state.get('_name', 'legacy'), [_convert_field(f) for f in fields])


def load_legacy_unischema(pickled):
    """The bytes under ``dataset-toolkit.unischema.v1`` -> a Unischema."""
    shim = restricted_loads(pickled)
    if not isinstance(shim, _RefUnischema):
        raise pickle.UnpicklingError(
            'legacy unischema metadata did not contain a Unischema (got {!r})'.format(type(shim)))
    schema = convert_unischema(shim)
    logger.info('Loaded legacy petastorm unischema %r (%d fields)', schema.name,
                len(schema.fields))
    return schema


def load_legacy_row_group_counts(raw):
    """The bytes under ``dataset-toolkit.num_row_groups_per_file.v1`` (JSON,
    unlike the pickled keys) -> ``{relative file path: row-group count}``."""
    counts = json.loads(raw.decode('utf-8'))
    if not isinstance(counts, dict):
        raise ValueError('legacy row-group counts were not a dict')
    return {str(k): int(v) for k, v in counts.items()}


def load_legacy_rowgroup_indexes(pickled):
    """The bytes under ``dataset-toolkit.rowgroups_index.v1`` ->
    ``{index name: indexer}`` of the port's indexers."""
    from petastorm_tpu_torch.etl.rowgroup_indexers import (FieldNotNullIndexer,
                                                           SingleFieldIndexer, _json_key)

    raw = restricted_loads(pickled)
    if not isinstance(raw, dict):
        raise pickle.UnpicklingError('legacy rowgroup index metadata was not a dict')
    out = {}
    for name, shim in raw.items():
        state = getattr(shim, '__dict__', {})
        index_name = state.get('_index_name', name)
        column = state.get('_column_name')
        if isinstance(shim, _RefSingleFieldIndexer):
            # the original keys its values natively; the port's keys are the
            # JSON-stable strings
            data = {_json_key(k): set(v) for k, v in state.get('_index_data', {}).items()}
            out[name] = SingleFieldIndexer(index_name, column, index_dict=data)
        elif isinstance(shim, _RefFieldNotNullIndexer):
            # the original's _index_data is a plain set of piece indexes
            out[name] = FieldNotNullIndexer(index_name, column,
                                            piece_indexes=set(state.get('_index_data', ())))
        else:
            raise pickle.UnpicklingError('Unknown legacy indexer type {!r}'.format(type(shim)))
    return out
