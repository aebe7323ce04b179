"""Port parity: hive-partitioned stores and ``append`` in petastorm_tpu_torch
against the JAX package.

Each package writes the same rows (made from a seed with numpy) with
``partition_by``; the two stores must have the same relative layout and
counts, list equal pieces with equal typed keys (a value with a slash, bools,
ints), and read to equal rows on the dummy, thread and process pools, each
package reading the other's store too. Partition pruning, the worker routes
of a predicate that names a partition key, ``make_batch_reader`` over a
``pyarrow.parquet.write_to_dataset`` store, the in-place fused publish of a
process pool with a partition column (the store of
``tests/test_pagescan.py::test_partition_only_projection_keeps_rows``), the
serve daemon, the elastic reader and ``append`` are held to the JAX package
the same way. Every reader is closed through ``with``; stores live under
``tmp_path``; the module leaves no flight recorder or telemetry state behind."""

import os
import pickle
import threading
import time

import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl import dataset_metadata as jax_dm
from petastorm_tpu.reader import Reader as JaxReader
from petastorm_tpu.test_util.dataset_utils import create_scalar_dataset
from petastorm_tpu_torch import codecs, make_batch_reader, make_reader, predicates, unischema
from petastorm_tpu_torch.etl import dataset_metadata as dm
from petastorm_tpu_torch.reader import Reader
from petastorm_tpu_torch.workers import ProcessPoolOptions

PACKAGES = {
    'jax': (jax_codecs, jax_unischema, jax_dm, jax_make_reader, jax_predicates),
    'torch': (codecs, unischema, dm, make_reader, predicates),
}
TIMEOUT = {'results_timeout_s': 60}
ROWS = 24


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


def _schema(package):
    """Two partition columns of the path (a str with a slash and a space,
    an int64 day) and a bool one, beside stored scalars and an ndarray."""
    c, u = PACKAGES[package][:2]
    return u.Unischema('P', [
        u.UnischemaField('id', np.int64, (), c.ScalarCodec(), False),
        u.UnischemaField('kind', np.str_, (), c.ScalarCodec(), False),
        u.UnischemaField('day', np.int64, (), c.ScalarCodec(), False),
        u.UnischemaField('flag', np.bool_, (), c.ScalarCodec(), False),
        u.UnischemaField('value', np.float64, (), c.ScalarCodec(), False),
        u.UnischemaField('vec', np.float32, (3,), c.NdarrayCodec(), False),
    ])


def _rows(seed=0, start=0, n=ROWS):
    rng = np.random.default_rng(seed)
    kinds = ['a/b', 'c d', 'e']
    return [{'id': start + i, 'kind': kinds[int(rng.integers(0, 3))],
             'day': int(rng.integers(0, 3)), 'flag': bool(rng.integers(0, 2)),
             'value': float(rng.random()),
             'vec': rng.random(3).astype(np.float32)} for i in range(n)]


PARTITIONS = {'kind_day': ['kind', 'day'], 'flag': ['flag'], 'day': ['day']}


def _write(package, path, partition_by, rows=None, **kwargs):
    url = 'file://' + str(path)
    dmod = PACKAGES[package][2]
    dmod.write_petastorm_dataset(url, _schema(package), rows or _rows(), rows_per_row_group=4,
                                 partition_by=partition_by, **kwargs)
    return url


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """``{(writer, partitioning): url}``: the same rows written by each
    package under each partitioning."""
    out = {}
    for package in PACKAGES:
        for name, partition_by in PARTITIONS.items():
            path = tmp_path_factory.mktemp('{}_{}'.format(package, name))
            out[package, name] = _write(package, path, partition_by)
    return out


def _relfiles(url):
    root = url[len('file://'):]
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _piece_keys(pieces, url):
    root = url[len('file://'):]
    return [(os.path.relpath(p.path, root), p.row_group, p.num_rows,
             sorted((k, type(v).__name__, v) for k, v in p.partition_keys.items()))
            for p in pieces]


def _row_key(row):
    d = row._asdict() if hasattr(row, '_asdict') else row
    return tuple(sorted((k, np.asarray(v).dtype.kind, np.asarray(v).tobytes())
                        for k, v in d.items()))


def _read_rows(package, url, **kwargs):
    kwargs.setdefault('shuffle_row_groups', False)
    with PACKAGES[package][3](url, **kwargs) as reader:
        return sorted(_row_key(r) for r in reader)


# -- writing -------------------------------------------------------------------------

@pytest.mark.parametrize('partitioning', sorted(PARTITIONS))
def test_both_packages_write_the_same_layout_and_counts(stores, partitioning):
    ours, theirs = stores['torch', partitioning], stores['jax', partitioning]
    assert _relfiles(ours) == _relfiles(theirs)
    meta = dm.read_metadata_dict(ours)
    jax_meta = jax_dm.read_metadata_dict(theirs)
    assert meta[dm.ROW_GROUPS_PER_FILE_KEY] == jax_meta[jax_dm.ROW_GROUPS_PER_FILE_KEY]
    assert meta[dm.UNISCHEMA_KEY] == jax_meta[jax_dm.UNISCHEMA_KEY]
    # the partition columns live in the paths only
    root = ours[len('file://'):]
    for rel in _relfiles(ours):
        if rel.endswith('.parquet'):
            names = pq.ParquetFile(os.path.join(root, rel)).schema_arrow.names
            assert not set(names) & set(PARTITIONS[partitioning])
            assert pq.read_table(os.path.join(root, rel)).equals(
                pq.read_table(os.path.join(theirs[len('file://'):], rel)))


def test_partition_by_a_field_not_in_the_schema_raises(tmp_path):
    from petastorm_tpu_torch.errors import PetastormTpuError
    with pytest.raises(PetastormTpuError, match='not in schema'):
        dm.DatasetWriter('file://' + str(tmp_path), _schema('torch'), partition_by=['nope'])


# -- listing -------------------------------------------------------------------------

@pytest.mark.parametrize('partitioning', sorted(PARTITIONS))
@pytest.mark.parametrize('writer', sorted(PACKAGES))
def test_pieces_and_typed_keys_equal_jax(stores, writer, partitioning):
    url = stores[writer, partitioning]
    ours = dm.load_row_groups(url)
    theirs = jax_dm.load_row_groups(url)
    assert _piece_keys(ours, url) == _piece_keys(theirs, url)
    assert all(set(p.partition_keys) == set(PARTITIONS[partitioning]) for p in ours)
    if partitioning == 'kind_day':
        assert {p.partition_keys['kind'] for p in ours} == {'a/b', 'c d', 'e'}
    if partitioning == 'flag':
        assert {p.partition_keys['flag'] for p in ours} == {True, False}
        assert all(isinstance(p.partition_keys['flag'], bool) for p in ours)


def test_untyped_keys_and_relpath_parsing_equal_jax():
    for relpath in ('a=1/b=x%2Fy/part-00000.parquet', 'a=-3/part.parquet', 'plain/f.parquet',
                    'a=1.5/b=/f.parquet', 'a=01/f.parquet'):
        assert dm._partition_keys_from_relpath(relpath) == \
            jax_dm._partition_keys_from_relpath(relpath)
    for value, dtype in (('True', np.bool_), ('0', np.bool_), ('7', np.int32), ('2.5', np.float64),
                         ('x/y', np.str_)):
        ours = dm._parse_partition_value(value, dtype)
        theirs = jax_dm._parse_partition_value(value, dtype)
        assert (type(ours), ours) == (type(theirs), theirs)


def test_pieces_pickle_with_their_keys(stores):
    pieces = dm.load_row_groups(stores['torch', 'kind_day'])
    restored = pickle.loads(pickle.dumps(pieces))
    assert [(p.path, p.row_group, p.num_rows, p.partition_keys) for p in restored] == \
        [(p.path, p.row_group, p.num_rows, p.partition_keys) for p in pieces]


# -- reading -------------------------------------------------------------------------

@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
@pytest.mark.parametrize('writer', sorted(PACKAGES))
def test_rows_equal_jax_on_every_pool(stores, writer, pool):
    url = stores[writer, 'kind_day']
    kwargs = ({'workers_count': 2, 'reader_pool_type': ProcessPoolOptions(**TIMEOUT)}
              if pool == 'process' else {'reader_pool_type': pool})
    ours = _read_rows('torch', url, **kwargs)
    assert ours == _read_rows('jax', url, reader_pool_type='dummy')
    assert len(ours) == ROWS


@pytest.mark.parametrize('partitioning', ['flag', 'day'])
def test_columnar_blocks_type_the_partition_columns_as_jax(stores, partitioning):
    url = stores['torch', partitioning]
    blocks = {}
    for package, factory in (('torch', make_reader), ('jax', jax_make_reader)):
        with factory(url, output='columnar', reader_pool_type='dummy',
                     shuffle_row_groups=False) as reader:
            blocks[package] = [b._asdict() for b in reader]
    assert len(blocks['torch']) == len(blocks['jax'])
    for ours, theirs in zip(blocks['torch'], blocks['jax']):
        assert sorted(ours) == sorted(theirs)
        for name in ours:
            assert np.asarray(ours[name]).dtype == np.asarray(theirs[name]).dtype, name
            np.testing.assert_array_equal(ours[name], theirs[name])


def test_partition_pruning_equals_jax(stores):
    url = stores['torch', 'kind_day']
    pieces = dm.load_row_groups(url)
    jax_pieces = jax_dm.load_row_groups(url)
    for ours_pred, theirs_pred in (
            (predicates.in_set(['a/b', 'e'], 'kind'), jax_predicates.in_set(['a/b', 'e'], 'kind')),
            (predicates.in_lambda(['kind', 'day'], lambda v: v['day'] > 0 and v['kind'] != 'e'),
             jax_predicates.in_lambda(['kind', 'day'],
                                      lambda v: v['day'] > 0 and v['kind'] != 'e'))):
        kept, left = Reader._apply_predicate_to_pieces(pieces, ours_pred)
        jax_kept, jax_left = JaxReader._apply_predicate_to_pieces(jax_pieces, theirs_pred)
        assert left is None and jax_left is None
        assert _piece_keys(kept, url) == _piece_keys(jax_kept, url)
        assert 0 < len(kept) < len(pieces)
        ours = _read_rows('torch', url, predicate=ours_pred)
        assert ours == _read_rows('jax', url, predicate=theirs_pred)
        assert len(ours) == sum(p.num_rows for p in kept)


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_predicate_on_a_partition_key_and_a_stored_column_filters_in_the_workers(stores, pool):
    url = stores['torch', 'kind_day']
    ours = predicates.in_lambda(['kind', 'id'], lambda v: v['kind'] == 'a/b' and v['id'] % 2 == 0)
    theirs = jax_predicates.in_lambda(['kind', 'id'],
                                      lambda v: v['kind'] == 'a/b' and v['id'] % 2 == 0)
    assert Reader._apply_predicate_to_pieces(dm.load_row_groups(url), ours)[1] is ours
    rows = _read_rows('torch', url, predicate=ours, reader_pool_type=pool)
    assert rows and rows == _read_rows('jax', url, predicate=theirs)
    # a native predicate on a stored column, with partition columns to fill in
    rows = _read_rows('torch', url, predicate=predicates.in_set([1, 2, 3, 20], 'id'),
                      reader_pool_type=pool)
    assert rows == _read_rows('jax', url, predicate=jax_predicates.in_set([1, 2, 3, 20], 'id'))
    assert len(rows) == 4
    # ... and with only partition columns left after the predicate's
    rows = _read_rows('torch', url, predicate=predicates.in_set([1, 2, 3, 20], 'id'),
                      schema_fields=['id', 'kind', 'day'], reader_pool_type=pool)
    assert rows == _read_rows('jax', url, predicate=jax_predicates.in_set([1, 2, 3, 20], 'id'),
                              schema_fields=['id', 'kind', 'day'])
    assert len(rows) == 4


def test_row_drop_partitions_and_projections_equal_jax(stores):
    url = stores['torch', 'kind_day']
    for kwargs in ({'shuffle_row_drop_partitions': 2}, {'schema_fields': ['kind', 'day']},
                   {'schema_fields': ['kind', 'vec']}):
        ours = _read_rows('torch', url, **kwargs)
        assert ours == _read_rows('jax', url, **kwargs)
        assert len(ours) == ROWS


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
@pytest.mark.parametrize('case', ['row_drop', 'python_predicate', 'fused_predicate'])
def test_partition_columns_alone_keep_the_rows_of_a_row_subset(stores, case, pool):
    """A read whose stored columns are all consumed before the row subset is
    taken (a row-drop partition of a partition-only projection, or a
    predicate that leaves only partition columns to read) still delivers
    each kept row: Arrow's ``take`` of a table with no column keeps no row,
    and the JAX package delivers none here (``ROADMAP.md`` §3), so the rows
    are held to the rows written."""
    url = stores['torch', 'kind_day']
    written = _rows()
    if case == 'row_drop':
        kwargs = {'shuffle_row_drop_partitions': 2, 'schema_fields': ['kind', 'day']}
        expected = [{'kind': r['kind'], 'day': r['day']} for r in written]
    else:
        predicate = (predicates.in_lambda(['id'], lambda v: v['id'] % 2 == 0)
                     if case == 'python_predicate' else predicates.in_set(range(0, ROWS, 2), 'id'))
        kwargs = {'predicate': predicate, 'schema_fields': ['id', 'kind', 'day']}
        expected = [{'id': r['id'], 'kind': r['kind'], 'day': r['day']}
                    for r in written if r['id'] % 2 == 0]
    rows = _read_rows('torch', url, reader_pool_type=pool, **kwargs)
    assert rows == sorted(_row_key({k: np.int64(v) if k != 'kind' else v for k, v in r.items()})
                          for r in expected)


def test_partition_only_projection_keeps_rows(tmp_path):
    """``tests/test_pagescan.py``'s store: a partition column read with no
    stored column still has each row group's rows."""
    schema = unischema.Unischema('P', [
        unischema.UnischemaField('pk', np.str_, (), codecs.ScalarCodec(), False),
        unischema.UnischemaField('x', np.float32, (2,), codecs.RawTensorCodec(), False)])
    url = 'file://' + str(tmp_path / 'raw')
    dm.write_petastorm_dataset(
        url, schema, ({'pk': 'p{}'.format(i % 2), 'x': np.full(2, i, np.float32)}
                      for i in range(8)),
        rows_per_row_group=2, partition_by=['pk'], compression='none')
    with make_reader(url, reader_pool_type='dummy', schema_fields=['pk'],
                     shuffle_row_groups=False) as reader:
        vals = sorted(row.pk for row in reader)
    assert vals == ['p0'] * 4 + ['p1'] * 4


def _pagescan_store(package, path):
    c, u, dmod = PACKAGES[package][:3]
    schema = u.Unischema('P', [
        u.UnischemaField('pk', np.str_, (), c.ScalarCodec(), False),
        u.UnischemaField('day', np.int64, (), c.ScalarCodec(), False),
        u.UnischemaField('x', np.float32, (2,), c.RawTensorCodec(), False)])
    url = 'file://' + str(path)
    dmod.write_petastorm_dataset(
        url, schema, ({'pk': 'p{}'.format(i % 2), 'day': i % 3, 'x': np.full(2, i, np.float32)}
                      for i in range(24)),
        rows_per_row_group=2, partition_by=['pk', 'day'], compression='none')
    return url


def test_inplace_fused_publish_with_partition_columns(tmp_path):
    """A process pool with ``zero_copy=True``: each row group's stored
    column is decoded by the fused call into the ring slot and the
    partition columns (a str, an int64) framed after it in the same slot."""
    url = _pagescan_store('torch', tmp_path / 'ours')
    with make_reader(url, reader_pool_type=ProcessPoolOptions(**TIMEOUT), workers_count=2,
                     output='columnar', shuffle_row_groups=False, zero_copy=True) as reader:
        blocks = [b._asdict() for b in reader]
        inplace = reader.diagnostics['fused_inplace_batches_total']
    assert inplace == len(blocks) == 12
    for block in blocks:
        assert block['pk'].dtype == np.dtype('<U2') and block['day'].dtype == np.int64
    rows = sorted(_row_key(r) for b in blocks for r in _block_rows(b))
    jax_url = _pagescan_store('jax', tmp_path / 'theirs')
    assert rows == _read_rows('jax', jax_url)
    assert rows == _read_rows('torch', url, reader_pool_type='thread')


def _block_rows(block):
    n = len(next(iter(block.values())))
    return [{k: v[i] for k, v in block.items()} for i in range(n)]


def test_batch_reader_on_a_write_to_dataset_store_equals_jax(tmp_path):
    url = 'file://' + str(tmp_path / 'plain')
    create_scalar_dataset(url, num_rows=40, rows_per_row_group=5, partition_by=['string2'])
    schema = dm.infer_or_load_unischema(url)
    jax_schema = jax_dm.infer_or_load_unischema(url)
    assert schema.to_json() == jax_schema.to_json()
    assert 'string2' in schema.fields and schema.fields['string2'].numpy_dtype is np.str_
    batches = {}
    for package, factory in (('torch', make_batch_reader), ('jax', jax_make_batch_reader)):
        with factory(url, reader_pool_type='thread', workers_count=2,
                     shuffle_row_groups=False) as reader:
            rows = []
            for batch in reader:
                rows.extend(_block_rows(batch._asdict()))
            batches[package] = sorted(_row_key(r) for r in rows)
    assert batches['torch'] == batches['jax']
    assert len(batches['torch']) == 40
    # pruning on the inferred partition column
    with make_batch_reader(url, predicate=predicates.in_set(['world_1'], 'string2'),
                           shuffle_row_groups=False) as reader:
        kept = [s for batch in reader for s in batch.string2]
    assert kept and set(kept) == {'world_1'}


def test_served_reader_carries_the_keys_to_the_daemon(stores, tmp_path):
    from petastorm_tpu_torch.serve import ReaderService

    url = stores['torch', 'kind_day']
    svc = ReaderService(str(tmp_path / 'svc'), pool_type='thread', workers_count=2,
                        idle_timeout_s=None, ring_bytes=4 << 20)
    svc.start()
    try:
        ours = _read_rows('torch', url, serve=svc.service_dir)
    finally:
        svc.shutdown()
    assert ours == _read_rows('jax', url)


def test_elastic_reader_reads_every_partitioned_row_once(stores, tmp_path):
    from petastorm_tpu_torch.elastic import ElasticConfig

    url = stores['torch', 'kind_day']
    cfg = ElasticConfig(coord_dir=str(tmp_path / 'coord'), host_id='h0')
    ours = _read_rows('torch', url, elastic=cfg, workers_count=2, seed=3)
    assert ours == _read_rows('jax', url)


# -- append --------------------------------------------------------------------------

@pytest.mark.parametrize('partition_by', [None, ['day']])
def test_append_equals_jax(tmp_path, partition_by):
    first, second = _rows(seed=1), _rows(seed=2, start=ROWS, n=12)
    urls = {}
    for package in PACKAGES:
        path = tmp_path / package
        urls[package] = _write(package, path, partition_by, rows=first)
        _write(package, path, partition_by, rows=second, append=True)
    assert _relfiles(urls['torch']) == _relfiles(urls['jax'])
    meta = dm.read_metadata_dict(urls['torch'])
    assert meta[dm.ROW_GROUPS_PER_FILE_KEY] == \
        jax_dm.read_metadata_dict(urls['jax'])[jax_dm.ROW_GROUPS_PER_FILE_KEY]
    pieces = dm.load_row_groups(urls['torch'])
    assert _piece_keys(pieces, urls['torch']) == \
        _piece_keys(jax_dm.load_row_groups(urls['jax']), urls['jax'])
    assert sum(p.num_rows for p in pieces) == len(first) + len(second)
    ours = _read_rows('torch', urls['torch'])
    assert ours == _read_rows('jax', urls['jax'])
    assert len(ours) == len(first) + len(second)


def test_append_grows_the_other_packages_store(tmp_path):
    url = _write('jax', tmp_path / 's', ['day'], rows=_rows(seed=1))
    before = set(_relfiles(url))
    _write('torch', tmp_path / 's', ['day'], rows=_rows(seed=2, start=ROWS, n=12), append=True)
    assert before < set(_relfiles(url))
    rows = _read_rows('jax', url)
    assert rows == _read_rows('torch', url) and len(rows) == ROWS + 12
