"""Port parity: stores of the original petastorm library, read by
petastorm_tpu_torch as by the JAX package.

The cases of ``tests/test_legacy_interop.py``, on the port: the original's
classes are put in ``sys.modules`` by the port's own copy of the fake
modules (:mod:`petastorm_tpu_torch.test_util.legacy_fakes`), pickled,
and decoded by the restricted unpickler, which must also refuse a foreign
class and an ``os.system`` payload. Each decoded schema and index is held to
the JAX package's decode of the same bytes, and a store whose
``_common_metadata`` carries only the original's keys must read, select
through its legacy index and copy out to a native store, equal to what the
JAX package reads."""

import pickle
import threading
import time
import types
from decimal import Decimal

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu.etl import dataset_metadata as jax_dm
from petastorm_tpu.etl import legacy as jax_legacy
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu_torch import codecs, make_reader, selectors
from petastorm_tpu_torch.etl import build_rowgroup_index, dataset_metadata, legacy
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.test_util.legacy_fakes import (ref_schema_pickle, reference_modules,
                                                        write_legacy_metadata)
from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.observability import blackbox

    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    if armed[0] is None:
        jax_blackbox.disable()
    if armed[1] is None:
        blackbox.disable()
    for module in (jax_obs, obs):
        module.get_registry().reset()
        module.get_ring().clear()
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


@pytest.fixture()
def ref():
    with reference_modules() as namespace:
        yield namespace


def test_the_keys_are_the_jax_packages():
    assert (legacy.REF_UNISCHEMA_KEY, legacy.REF_ROW_GROUPS_PER_FILE_KEY,
            legacy.REF_ROW_GROUP_INDEX_KEY) == (jax_legacy.REF_UNISCHEMA_KEY,
                                                jax_legacy.REF_ROW_GROUPS_PER_FILE_KEY,
                                                jax_legacy.REF_ROW_GROUP_INDEX_KEY)


@pytest.mark.parametrize('protocol', [0, 1])
def test_protocol_0_and_1_schemas_are_refused_as_jax_refuses_them(ref, protocol):
    """Below protocol 2 a namedtuple field is rebuilt through
    ``copyreg._reconstructor(cls, tuple, state)``, and ``builtins.tuple`` is
    not on the JAX package's allowlist: both packages refuse the pickle."""
    data = ref_schema_pickle(ref, protocol)
    with pytest.raises(pickle.UnpicklingError, match='tuple') as ours:
        legacy.load_legacy_unischema(data)
    with pytest.raises(pickle.UnpicklingError) as theirs:
        jax_legacy.load_legacy_unischema(data)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('protocol', [2, pickle.HIGHEST_PROTOCOL])
def test_legacy_unischema_decodes(ref, protocol):
    data = ref_schema_pickle(ref, protocol)
    schema = legacy.load_legacy_unischema(data)
    assert schema.name == 'LegacySchema'
    assert set(schema.fields) == {'id', 'name', 'image', 'matrix', 'packed', 'price'}
    assert schema.fields['id'].numpy_dtype is np.int64
    assert isinstance(schema.fields['id'].codec, codecs.ScalarCodec)
    img = schema.fields['image'].codec
    assert isinstance(img, codecs.CompressedImageCodec)
    assert img._format == 'jpeg' and img._quality == 55
    assert isinstance(schema.fields['matrix'].codec, codecs.NdarrayCodec)
    assert isinstance(schema.fields['packed'].codec, codecs.CompressedNdarrayCodec)
    assert schema.fields['packed'].nullable
    assert schema.fields['packed'].shape == (None,)
    assert schema.fields['price'].numpy_dtype is Decimal
    # the JAX package decodes the same bytes to the same schema
    assert schema.to_json() == jax_legacy.load_legacy_unischema(data).to_json()


def test_legacy_row_group_counts():
    import json
    data = json.dumps({'part-0.parquet': 3, 'part-1.parquet': 2}).encode('utf-8')
    counts = legacy.load_legacy_row_group_counts(data)
    assert counts == {'part-0.parquet': 3, 'part-1.parquet': 2}
    assert counts == jax_legacy.load_legacy_row_group_counts(data)
    with pytest.raises(ValueError, match='not a dict'):
        legacy.load_legacy_row_group_counts(b'[1, 2]')


def test_legacy_rowgroup_indexes(ref):
    single = ref.SingleFieldIndexer('by_name', 'name')
    single._index_data['alice'].add(0)
    single._index_data['bob'].update({1, 2})
    single._index_data[7].add(3)
    notnull = ref.FieldNotNullIndexer('has_packed', 'packed')
    notnull._index_data.update({0, 2})
    data = pickle.dumps({'by_name': single, 'has_packed': notnull}, protocol=2)

    indexes = legacy.load_legacy_rowgroup_indexes(data)
    assert indexes['by_name'].get_row_group_indexes('alice') == {0}
    assert indexes['by_name'].get_row_group_indexes('bob') == {1, 2}
    assert indexes['by_name'].get_row_group_indexes(7) == {3}
    assert set(indexes['has_packed'].get_row_group_indexes()) == {0, 2}
    theirs = jax_legacy.load_legacy_rowgroup_indexes(data)
    assert {n: ix.to_json() for n, ix in indexes.items()} == \
        {n: ix.to_json() for n, ix in theirs.items()}


@pytest.mark.parametrize('payload', [
    pytest.param(lambda: pickle.dumps(types.SimpleNamespace(x=1), protocol=2), id='class'),
    # the classic shape of a code-execution payload: GLOBAL os.system + REDUCE
    pytest.param(lambda: b"cos\nsystem\np0\n(S'true'\np1\ntp2\nRp3\n.", id='os_system'),
    pytest.param(lambda: pickle.dumps({'ix': (1).__class__}, protocol=2), id='builtin_type'),
])
def test_unpickler_refuses_what_is_not_on_the_allowlist(payload):
    data = payload()
    with pytest.raises(pickle.UnpicklingError, match='Refusing to depickle') as ours:
        legacy.restricted_loads(data)
    with pytest.raises(pickle.UnpicklingError) as theirs:
        jax_legacy.restricted_loads(data)
    assert str(ours.value) == str(theirs.value)


def test_a_pickle_of_another_type_is_refused_as_jax_refuses_it():
    for data, load, jax_load in ((pickle.dumps([1, 2]), legacy.load_legacy_unischema,
                                  jax_legacy.load_legacy_unischema),
                                 (pickle.dumps([1, 2]), legacy.load_legacy_rowgroup_indexes,
                                  jax_legacy.load_legacy_rowgroup_indexes)):
        with pytest.raises(pickle.UnpicklingError) as ours:
            load(data)
        with pytest.raises(pickle.UnpicklingError) as theirs:
            jax_load(data)
        assert str(ours.value).replace('petastorm_tpu_torch', 'petastorm_tpu') == \
            str(theirs.value)


# -- a store with only the original's keys ------------------------------------------

ROWS = 20


def _native_store(path):
    """Payload files written by the port's writer (the original's formats),
    four row groups of five rows in one file, an id index built on them."""
    schema = Unischema('LegacySchema', [
        UnischemaField('id', np.int64, (), codecs.ScalarCodec(), False),
        UnischemaField('matrix', np.float32, (2, 3), codecs.NdarrayCodec(), False),
    ])
    url = 'file://' + str(path)
    rows = [{'id': i, 'matrix': np.full((2, 3), i, dtype=np.float32)} for i in range(ROWS)]
    dataset_metadata.write_petastorm_dataset(url, schema, rows, rows_per_row_group=5)
    return url


def _legacy_store(ref, path):
    """The native store with its ``_common_metadata`` replaced by the
    original's pickled schema, JSON counts and pickled index on ``id``
    (row group = id // 5)."""
    url = _native_store(path)
    schema = ref.Unischema('LegacySchema', [
        ref.UnischemaField('id', np.int64, (), ref.ScalarCodec(ref.sql_types.LongType()), False),
        ref.UnischemaField('matrix', np.float32, (2, 3), ref.NdarrayCodec(), False),
    ])
    index = ref.SingleFieldIndexer('id_index', 'id')
    for i in range(ROWS):
        index._index_data[i].add(i // 5)
    write_legacy_metadata(str(path), pickle.dumps(schema, protocol=2),
                          pickle.dumps({'id_index': index}, protocol=2))
    return url


def _ids(reader):
    return sorted(int(r.id) for r in reader)


def test_legacy_dataset_reads_end_to_end(ref, tmp_path):
    url = _legacy_store(ref, tmp_path)
    meta = dataset_metadata.read_metadata_dict(url)
    assert dataset_metadata.UNISCHEMA_KEY not in meta
    assert dataset_metadata.ROW_GROUPS_PER_FILE_KEY not in meta
    for pool in ('dummy', 'thread'):
        with make_reader(url, shuffle_row_groups=False, reader_pool_type=pool) as reader:
            out = list(reader)
        assert len(out) == ROWS
        assert sorted(r.id for r in out) == list(range(ROWS))
        for row in out:
            np.testing.assert_array_equal(row.matrix, np.full((2, 3), row.id, dtype=np.float32))
    with jax_make_reader(url, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        theirs = [(int(r.id), r.matrix.tobytes()) for r in reader]
    with make_reader(url, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        assert [(int(r.id), r.matrix.tobytes()) for r in reader] == theirs
    # the pieces come from the original's counts: no row counts recorded
    pieces = dataset_metadata.load_row_groups(url)
    assert [(p.path, p.row_group, p.num_rows) for p in pieces] == \
        [(p.path, p.row_group, p.num_rows) for p in jax_dm.load_row_groups(url)]
    assert len(pieces) == 4 and all(p.num_rows is None for p in pieces)
    assert dataset_metadata.get_schema(url).to_json() == jax_dm.get_schema(url).to_json()
    assert dataset_metadata.infer_or_load_unischema(url).to_json() == \
        jax_dm.infer_or_load_unischema(url).to_json()


def test_legacy_index_selects_as_a_native_index(ref, tmp_path):
    url = _legacy_store(ref, tmp_path / 'legacy')
    native = _native_store(tmp_path / 'native')
    build_rowgroup_index(native, [SingleFieldIndexer('id_index', 'id')])
    legacy_indexes = get_row_group_indexes(url)
    native_indexes = get_row_group_indexes(native)
    assert {n: ix.to_json() for n, ix in legacy_indexes.items()} == \
        {n: ix.to_json() for n, ix in jax_indexing.get_row_group_indexes(url).items()}
    for values in ([3], [0, 7, 19], [12, 13]):
        selector = selectors.SingleIndexSelector('id_index', values)
        assert selector.select_row_groups(legacy_indexes) == \
            selector.select_row_groups(native_indexes)
        with make_reader(url, rowgroup_selector=selector, shuffle_row_groups=False) as reader:
            ids = _ids(reader)
        assert ids == sorted({i for v in values for i in range(v // 5 * 5, v // 5 * 5 + 5)})
        with jax_make_reader(url, rowgroup_selector=jax_selectors.SingleIndexSelector(
                'id_index', values), shuffle_row_groups=False) as reader:
            assert _ids(reader) == ids


def test_copy_tool_migrates_legacy_dataset(ref, tmp_path):
    url = _legacy_store(ref, tmp_path / 'legacy')
    target = 'file://' + str(tmp_path / 'native')
    assert copy_dataset(url, target, rows_per_row_group=10) == ROWS
    meta = dataset_metadata.read_metadata_dict(target)
    assert dataset_metadata.UNISCHEMA_KEY in meta  # the native JSON schema
    assert not {k for k in meta if k.startswith(b'dataset-toolkit')}
    with make_reader(target, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        assert _ids(reader) == list(range(ROWS))
    with jax_make_reader(target, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        assert _ids(reader) == list(range(ROWS))
    # the JAX tool's copy of the same legacy store is the same store
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy_dataset
    jax_target = 'file://' + str(tmp_path / 'jax_native')
    assert jax_copy_dataset(url, jax_target, rows_per_row_group=10) == ROWS
    assert dataset_metadata.read_metadata_dict(target) == jax_dm.read_metadata_dict(jax_target)
