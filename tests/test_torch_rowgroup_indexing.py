"""The port's row-group indexes and selectors against the JAX package's: the
index JSON the port builds is byte-equal to the JAX one on the same store,
each package reads the other's index, the selectors pick equal sets, the
metadata rewrite keeps every other key, and the seven cases of
``tests/test_rowgroup_indexing.py`` hold for the port. The store is the JAX
package's synthetic ``TestSchema`` store (100 rows, 10 per row group, 30 per
file)."""

import shutil

import pyarrow.parquet as pq
import pytest

import petastorm_tpu.selectors as jax_selectors
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.etl import dataset_metadata as jax_dataset_metadata
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu.test_util.dataset_utils import create_test_dataset
import petastorm_tpu_torch.etl as etl
from petastorm_tpu_torch import make_reader, selectors
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import (FieldNotNullIndexer, SingleFieldIndexer,
                                     build_rowgroup_index, dataset_metadata,
                                     get_row_group_indexes)


def _indexers(mod):
    return [mod.SingleFieldIndexer('id_index', 'id'),
            mod.SingleFieldIndexer('sensor_name_index', 'sensor_name'),
            mod.SingleFieldIndexer('partition_index', 'partition_key'),
            mod.FieldNotNullIndexer('matrix_nullable_index', 'matrix_nullable')]


@pytest.fixture(scope='module')
def plain_store(tmp_path_factory):
    """The synthetic store without indexes; tests index copies of it."""
    path = tmp_path_factory.mktemp('synthetic')
    create_test_dataset('file://' + str(path), build_indexes=False)
    return path


@pytest.fixture(scope='module')
def indexed(plain_store, tmp_path_factory):
    """``{'torch': url, 'jax': url}``: a copy of the store indexed by each
    package."""
    urls = {}
    for package in ('torch', 'jax'):
        path = tmp_path_factory.mktemp('indexed_' + package)
        shutil.copytree(plain_store, path, dirs_exist_ok=True)
        urls[package] = 'file://' + str(path)
    build_rowgroup_index(urls['torch'], _indexers(etl))
    jax_indexing.build_rowgroup_index(urls['jax'], _indexers(jax_indexers))
    return urls


def test_index_json_byte_equal_to_jax(indexed):
    ours = dataset_metadata.read_metadata_dict(indexed['torch'])
    theirs = jax_dataset_metadata.read_metadata_dict(indexed['jax'])
    key = dataset_metadata.ROW_GROUP_INDEX_KEY
    assert key == jax_dataset_metadata.ROW_GROUP_INDEX_KEY
    assert ours[key] == theirs[key]
    # the rewrite kept the writer's keys, byte for byte
    assert set(ours) == set(theirs)
    for k in (dataset_metadata.UNISCHEMA_KEY, dataset_metadata.ROW_GROUPS_PER_FILE_KEY):
        assert ours[k] == theirs[k]


@pytest.mark.parametrize('reader, writer', [('torch', 'jax'), ('jax', 'torch')])
def test_each_package_reads_the_others_index(indexed, reader, writer):
    get = get_row_group_indexes if reader == 'torch' else jax_indexing.get_row_group_indexes
    other = jax_indexing.get_row_group_indexes if reader == 'torch' else get_row_group_indexes
    ours, theirs = get(indexed[writer]), other(indexed[writer])
    assert set(ours) == set(theirs) == {'id_index', 'sensor_name_index', 'partition_index',
                                        'matrix_nullable_index'}
    for name in ours:
        assert ours[name].to_json() == theirs[name].to_json()


@pytest.mark.parametrize('package', ['torch', 'jax'])
def test_both_readers_open_a_store_the_other_indexed(indexed, package):
    """The rewritten ``_common_metadata`` still opens in both packages, and
    both read the same rows."""
    url = indexed[package]
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                     schema_fields=['id', 'partition_key']) as r:
        ours = [(int(row.id), row.partition_key) for row in r]
    with jax_make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         schema_fields=['id', 'partition_key']) as r:
        theirs = [(int(row.id), row.partition_key) for row in r]
    assert ours == theirs and len(ours) == 100
    assert pq.read_schema(url[len('file://'):] + '/_common_metadata').metadata


def _selector_cases(mod):
    return {
        'single-id': mod.SingleIndexSelector('id_index', [5, 17, 95, 12345]),
        'single-sensor': mod.SingleIndexSelector('sensor_name_index', ['sensor_1']),
        'single-partition': mod.SingleIndexSelector('partition_index', ['p_3', 'p_7']),
        'intersect': mod.IntersectIndexSelector([
            mod.SingleIndexSelector('id_index', list(range(0, 100, 7))),
            mod.SingleIndexSelector('id_index', list(range(40, 70)))]),
        'union': mod.UnionIndexSelector([
            mod.SingleIndexSelector('id_index', [1, 2]),
            mod.SingleIndexSelector('id_index', [88])]),
        'not-null': mod.SingleIndexSelector('matrix_nullable_index', ['anything']),
    }


@pytest.mark.parametrize('case', sorted(_selector_cases(selectors)))
def test_selectors_pick_equal_sets(indexed, case):
    ours = _selector_cases(selectors)[case]
    theirs = _selector_cases(jax_selectors)[case]
    assert ours.get_index_names() == theirs.get_index_names()
    picked = ours.select_row_groups(get_row_group_indexes(indexed['torch']))
    assert picked == theirs.select_row_groups(jax_indexing.get_row_group_indexes(indexed['jax']))
    # and the readers keep those row groups, in the same rows
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, schema_fields=['id'])
    with make_reader(indexed['torch'], rowgroup_selector=ours, **kwargs) as r:
        rows = [int(row.id) for row in r]
    with jax_make_reader(indexed['jax'], rowgroup_selector=theirs, **kwargs) as r:
        assert rows == [int(row.id) for row in r]
    assert sorted({i // 10 for i in rows}) == sorted(picked)


def test_selector_of_a_missing_index_raises(indexed):
    with pytest.raises(PetastormTpuError, match='does not exist'):
        make_reader(indexed['torch'], rowgroup_selector=selectors.SingleIndexSelector(
            'no_such_index', [1]))
    with pytest.raises(PetastormTpuError, match='not found'):
        selectors.SingleIndexSelector('no_such_index', [1]).select_row_groups({})


def test_store_without_index_and_legacy_index(plain_store, tmp_path):
    url = 'file://' + str(plain_store)
    with pytest.raises(PetastormTpuError, match='has no row-group index'):
        get_row_group_indexes(url)
    shutil.copytree(plain_store, tmp_path, dirs_exist_ok=True)
    legacy = 'file://' + str(tmp_path)
    dataset_metadata.add_dataset_metadata(legacy, b'dataset-toolkit.rowgroups_index.v1', b'x')
    # a malformed legacy index: the port raises what the JAX package raises
    with pytest.raises(Exception) as theirs:
        jax_indexing.get_row_group_indexes(legacy)
    with pytest.raises(type(theirs.value)) as ours:
        get_row_group_indexes(legacy)
    assert str(ours.value) == str(theirs.value)


# -- the cases of tests/test_rowgroup_indexing.py, on the port ------------------------

def test_indexes_loaded(indexed):
    indexes = get_row_group_indexes(indexed['torch'])
    assert set(indexes) == {'id_index', 'sensor_name_index', 'partition_index',
                            'matrix_nullable_index'}


def test_single_field_index_lookup(indexed):
    id_index = get_row_group_indexes(indexed['torch'])['id_index']
    # id=5 lives in row group 0 (rows 0-9 with 10 rows per group)
    assert id_index.get_row_group_indexes(5) == {0}
    assert id_index.get_row_group_indexes(95) == {9}
    assert id_index.get_row_group_indexes(12345) == set()


def test_sensor_name_index_covers_all_groups(indexed):
    sensors = get_row_group_indexes(indexed['torch'])['sensor_name_index']
    # each group of 10 consecutive ids holds all 4 sensor names (idx % 4)
    for s in range(4):
        assert sensors.get_row_group_indexes('sensor_{}'.format(s)) == set(range(10))
    assert sorted(sensors.indexed_values) == ['sensor_0', 'sensor_1', 'sensor_2', 'sensor_3']


def test_not_null_index(indexed):
    # matrix_nullable is null when idx % 5 == 0; every group of 10 has non-null rows
    indexes = get_row_group_indexes(indexed['torch'])
    assert indexes['matrix_nullable_index'].get_row_group_indexes() == set(range(10))


def test_indexer_merge():
    a = SingleFieldIndexer('ix', 'f')
    a.build_index([{'f': 1}, {'f': 2}], piece_index=0)
    b = SingleFieldIndexer('ix', 'f')
    b.build_index([{'f': 2}, {'f': 3}], piece_index=1)
    merged = a + b
    assert merged.get_row_group_indexes(2) == {0, 1}
    assert merged.get_row_group_indexes(1) == {0}
    with pytest.raises(PetastormTpuError):
        a + SingleFieldIndexer('ix', 'other_field')
    assert merged.to_json() == (jax_indexers.SingleFieldIndexer('ix', 'f', {
        '1': [0], '2': [0, 1], '3': [1]})).to_json()


def test_not_null_indexer_merge():
    a = FieldNotNullIndexer('ix', 'f')
    a.build_index([{'f': None}], piece_index=0)
    b = FieldNotNullIndexer('ix', 'f')
    b.build_index([{'f': 3}], piece_index=1)
    assert (a + b).get_row_group_indexes() == {1}
    with pytest.raises(PetastormTpuError, match='empty rows'):
        a.build_index([], piece_index=2)


def test_empty_indexers_raises(plain_store):
    with pytest.raises(PetastormTpuError):
        build_rowgroup_index('file://' + str(plain_store), [])
