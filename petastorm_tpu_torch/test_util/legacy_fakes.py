"""Stores of the original petastorm library, made without it.

The original library pickles its Unischema, codecs and row-group indexers
into ``_common_metadata``. :func:`reference_modules` puts modules in
``sys.modules`` whose classes have the original's names and layouts
(``petastorm.unischema``, ``petastorm.codecs``,
``petastorm.etl.rowgroup_indexers``, and the ``pyspark.sql.types`` its
``ScalarCodec`` holds), so instances pickle to the bytes the original
writes; it takes them out again on exit. :func:`write_legacy_metadata`
then gives a store a ``_common_metadata`` that carries only the original's
keys. Used by the port's CPU tests and by ``chip_smoke.py``; nothing here
imports pytest.
"""

import json
import os
import pickle
import sys
import types
from collections import OrderedDict, defaultdict, namedtuple
from contextlib import contextmanager
from decimal import Decimal

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.etl import legacy

_SPARK_TYPES = ('ByteType', 'ShortType', 'IntegerType', 'LongType', 'FloatType', 'DoubleType',
                'BooleanType', 'StringType', 'BinaryType', 'TimestampType', 'DateType')


def _install():
    """Create the modules; returns ``(namespace of their classes, names)``."""
    created = []

    def module(name):
        mod = types.ModuleType(name)
        sys.modules[name] = mod
        created.append(name)
        return mod

    pyspark = module('pyspark')
    sql = module('pyspark.sql')
    sql_types = module('pyspark.sql.types')
    pyspark.sql = sql
    sql.types = sql_types
    for tname in _SPARK_TYPES:
        setattr(sql_types, tname, type(tname, (object,), {'__module__': 'pyspark.sql.types'}))

    class DecimalType(object):
        __module__ = 'pyspark.sql.types'

        def __init__(self, precision=10, scale=0):
            self.precision = precision
            self.scale = scale
    sql_types.DecimalType = DecimalType

    petastorm = module('petastorm')
    unischema_mod = module('petastorm.unischema')
    codecs_mod = module('petastorm.codecs')
    etl_mod = module('petastorm.etl')
    indexers_mod = module('petastorm.etl.rowgroup_indexers')
    petastorm.unischema = unischema_mod
    petastorm.codecs = codecs_mod
    petastorm.etl = etl_mod
    etl_mod.rowgroup_indexers = indexers_mod

    class UnischemaField(namedtuple('UnischemaField',
                                    ['name', 'numpy_dtype', 'shape', 'codec', 'nullable'])):
        __module__ = 'petastorm.unischema'

    class Unischema(object):
        __module__ = 'petastorm.unischema'

        def __init__(self, name, fields):
            self._name = name
            self._fields = OrderedDict((f.name, f) for f in sorted(fields, key=lambda t: t.name))
            for f in fields:
                if not hasattr(self, f.name):
                    setattr(self, f.name, f)

    class ScalarCodec(object):
        __module__ = 'petastorm.codecs'

        def __init__(self, spark_type):
            self._spark_type = spark_type

    class NdarrayCodec(object):
        __module__ = 'petastorm.codecs'

    class CompressedNdarrayCodec(object):
        __module__ = 'petastorm.codecs'

    class CompressedImageCodec(object):
        __module__ = 'petastorm.codecs'

        def __init__(self, image_codec='png', quality=80):
            self._image_codec = '.' + image_codec
            self._quality = quality

    class SingleFieldIndexer(object):
        __module__ = 'petastorm.etl.rowgroup_indexers'

        def __init__(self, index_name, index_field):
            self._index_name = index_name
            self._column_name = index_field
            self._index_data = defaultdict(set)

    class FieldNotNullIndexer(object):
        __module__ = 'petastorm.etl.rowgroup_indexers'

        def __init__(self, index_name, index_field):
            self._index_name = index_name
            self._column_name = index_field
            self._index_data = set()

    unischema_mod.UnischemaField = UnischemaField
    unischema_mod.Unischema = Unischema
    codecs_mod.ScalarCodec = ScalarCodec
    codecs_mod.NdarrayCodec = NdarrayCodec
    codecs_mod.CompressedNdarrayCodec = CompressedNdarrayCodec
    codecs_mod.CompressedImageCodec = CompressedImageCodec
    indexers_mod.SingleFieldIndexer = SingleFieldIndexer
    indexers_mod.FieldNotNullIndexer = FieldNotNullIndexer
    classes = dict(UnischemaField=UnischemaField, Unischema=Unischema, ScalarCodec=ScalarCodec,
                   NdarrayCodec=NdarrayCodec, CompressedNdarrayCodec=CompressedNdarrayCodec,
                   CompressedImageCodec=CompressedImageCodec,
                   SingleFieldIndexer=SingleFieldIndexer,
                   FieldNotNullIndexer=FieldNotNullIndexer)
    # defined in a function: pickle finds them by module and qualified name
    for cls in list(classes.values()) + [DecimalType]:
        cls.__qualname__ = cls.__name__
    return dict(classes, sql_types=sql_types), created


@contextmanager
def reference_modules():
    """The original library's modules in ``sys.modules`` for the ``with``
    block; yields a namespace of their classes (and ``sql_types``)."""
    ns, created = _install()
    try:
        yield types.SimpleNamespace(**ns)
    finally:
        for name in created:
            sys.modules.pop(name, None)


def ref_schema_pickle(ref, protocol):
    """A six-field schema as the original pickles it: a scalar of each
    kind, an image, an ndarray, a nullable compressed ndarray and a
    Decimal."""
    schema = ref.Unischema('LegacySchema', [
        ref.UnischemaField('id', np.int64, (), ref.ScalarCodec(ref.sql_types.LongType()), False),
        ref.UnischemaField('name', np.str_, (), ref.ScalarCodec(ref.sql_types.StringType()),
                           False),
        ref.UnischemaField('image', np.uint8, (4, 6, 3), ref.CompressedImageCodec('jpeg', 55),
                           False),
        ref.UnischemaField('matrix', np.float32, (2, 3), ref.NdarrayCodec(), False),
        ref.UnischemaField('packed', np.uint16, (None,), ref.CompressedNdarrayCodec(), True),
        ref.UnischemaField('price', Decimal, (),
                           ref.ScalarCodec(ref.sql_types.DecimalType(10, 2)), False),
    ])
    return pickle.dumps(schema, protocol=protocol)


def write_legacy_metadata(root, schema_pickle, index_pickle=None):
    """Replace the ``_common_metadata`` of the store at the local path
    ``root`` by one that carries only the original library's keys: the
    pickled unischema, each top-level file's row-group count as JSON, and,
    when given, the pickled row-group indexes. The Arrow schema is the
    first file's."""
    files = sorted(name for name in os.listdir(root) if name.endswith('.parquet'))
    counts = {name: pq.ParquetFile(os.path.join(root, name)).metadata.num_row_groups
              for name in files}
    metadata = {legacy.REF_UNISCHEMA_KEY: schema_pickle,
                legacy.REF_ROW_GROUPS_PER_FILE_KEY: json.dumps(counts).encode('utf-8')}
    if index_pickle is not None:
        metadata[legacy.REF_ROW_GROUP_INDEX_KEY] = index_pickle
    arrow_schema = pq.ParquetFile(os.path.join(root, files[0])).schema_arrow
    pq.write_metadata(arrow_schema.with_metadata(metadata), os.path.join(root, '_common_metadata'))
