"""The port's row filtering against the JAX package's, on the CPU.

``NativeParquetFile.read_fused_predicate`` (the fused native predicate
pushdown: clause evaluation, page-stat skipping and the decode of only the
surviving rows in one call) equals the JAX one on the clause shapes of
``tests/test_fused_decode.py`` across the four codecs: blocks, selection,
counts and pages skipped, and the fallback reasons of the clauses the kernel
declines. The ``FusedPred`` ctypes mirror passes the JAX package's
PT900-PT902 rules. ``make_reader(predicate=..., rowgroup_selector=...,
shuffle_row_drop_partitions=...)`` delivers the JAX package's rows in the
JAX package's order (dummy pool, seed 7) on stores written by either
package, through the native and the Python pushdown; the thread and process
pools (copy and zero-copy) deliver the same multiset per epoch, items that
keep no row included. The refusals are the JAX package's."""

import collections
import gc
import os
import pickle
import shutil
import threading
import time

import numpy as np
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu.predicates as jax_predicates
import petastorm_tpu.selectors as jax_selectors
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import native as jax_native
from petastorm_tpu import observability as obs
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
import petastorm_tpu_torch.codecs as codecs
import petastorm_tpu_torch.predicates as predicates
import petastorm_tpu_torch.selectors as selectors
from petastorm_tpu_torch import NoDataAvailableError, make_reader, native
from petastorm_tpu_torch.etl import (SingleFieldIndexer, build_rowgroup_index,
                                     get_row_group_indexes, materialize_dataset)
from petastorm_tpu_torch.native import fused
from petastorm_tpu_torch.native.lifetime import registry
from petastorm_tpu_torch.row_worker import select_row_drop_indices
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

import cv2  # noqa: F401,E402  (both packages encode PNG cells through it)


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
    # every reader was closed: none of their threads is left running
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {'jax': (jax_materialize_dataset, JaxField, JaxUnischema, jax_codecs),
            'torch': (materialize_dataset, UnischemaField, Unischema, codecs)}
COMPRESSIONS = ['snappy', 'zstd', 'lz4', 'none']
SCALAR_DTYPES = (np.int32, np.int64, np.float32, np.float64)
TIMEOUT = {'results_timeout_s': 60}


def _parquet_path(url):
    root = url[len('file://'):]
    return os.path.join(root, sorted(f for f in os.listdir(root) if f.endswith('.parquet'))[0])


def _routes():
    return {k: v for k, v in native.read_routes.snapshot().items() if v}


def _jax_counters():
    return {k: v for k, v in obs.snapshot().get('counters', {}).items() if v}


# -- read_fused_predicate against the JAX kernel binding -------------------------

def _write_scalar_store(url, compression, package='torch'):
    """``tests/test_fused_decode.py``'s scalar store (values ``i * 7 + 1`` in
    four numeric columns, 16 rows per row group) plus a string column the
    fused read leaves to Arrow."""
    materialize, field_cls, schema_cls, cm = PACKAGES[package]
    schema = schema_cls('S', [field_cls('c_{}'.format(np.dtype(dt).name), dt, (),
                                        cm.ScalarCodec(dt), False) for dt in SCALAR_DTYPES]
                        + [field_cls('c_str', np.str_, (), cm.ScalarCodec(), False)])
    rows = []
    with materialize(url, schema, rows_per_row_group=16, compression=compression) as w:
        for i in range(64):
            row = {'c_{}'.format(np.dtype(dt).name): np.dtype(dt).type(i * 7 + 1)
                   for dt in SCALAR_DTYPES}
            row['c_str'] = 's{}'.format(i % 5)
            w.write(row)
            rows.append(row)
    return schema, rows


def _pred_cases(mod):
    """The clause shapes of ``tests/test_fused_decode.py`` (every one the
    kernel evaluates), and one whose bound excludes whole row groups by
    their page statistics."""
    return {
        'range': mod.in_range('c_int64', lo=100, hi=300),
        'range-exclusive': mod.in_range('c_int64', lo=106, hi=302, lo_inclusive=False,
                                        hi_inclusive=False),
        'in': mod.in_set([1, 106, 441, 9999], 'c_int64'),
        'not-in': mod.in_negate(mod.in_set([1, 106, 442], 'c_int64')),
        'and': mod.in_reduce([mod.in_range('c_int64', lo=50),
                              mod.in_range('c_float64', hi=200.0)], all),
        'float-range': mod.in_range('c_float64', lo=33.5),
        'page-skip': mod.in_range('c_int64', hi=100),
        'int32-set': mod.in_set([8, 15, 99, 2 ** 40], 'c_int32'),
    }


@pytest.fixture(scope='module')
def scalar_stores(tmp_path_factory):
    stores = {}
    for compression in COMPRESSIONS:
        url = 'file://' + str(tmp_path_factory.mktemp('scalar_' + compression))
        stores[compression] = (url,) + _write_scalar_store(url, compression)
    return stores


@pytest.fixture(autouse=True, scope='module')
def _libraries_loaded():
    assert jax_native.is_available() and native.is_available()


def _assert_block_equal(actual, expected):
    assert set(actual) == set(expected)
    for name in expected:
        a, e = np.asarray(actual[name]), np.asarray(expected[name])
        assert a.dtype == e.dtype and a.shape == e.shape, (name, a.dtype, e.dtype)
        np.testing.assert_array_equal(a, e, err_msg=name)


@pytest.mark.parametrize('case', sorted(_pred_cases(predicates)))
@pytest.mark.parametrize('compression', COMPRESSIONS)
def test_read_fused_predicate_equals_jax(scalar_stores, compression, case):
    url, schema, rows = scalar_stores[compression]
    path = _parquet_path(url)
    ours, theirs = native.NativeParquetFile(path), jax_native.NativeParquetFile(path)
    pred, jax_pred = _pred_cases(predicates)[case], _pred_cases(jax_predicates)[case]
    clauses = pred.native_clauses()
    assert clauses == jax_pred.native_clauses() and clauses is not None
    fields = sorted(pred.get_fields())
    cols = list(schema.fields)
    native.read_routes.reset()
    kept, skipped = [], 0
    for rg in range(pq.read_metadata(path).num_row_groups):
        got = ours.read_fused_predicate(rg, cols, fields, clauses, schema.fields)
        want = theirs.read_fused_predicate(rg, cols, fields, clauses, schema.fields)
        assert got is not None and want is not None
        block, rest, sel_mask, n_selected, pages_skipped = got
        _assert_block_equal(block, want[0])
        assert rest == want[1] == ['c_str']
        np.testing.assert_array_equal(sel_mask, want[2])
        assert (n_selected, pages_skipped) == (want[3], want[4])
        assert int(sel_mask.sum()) == n_selected == len(block['c_int64'])
        kept.extend(int(v) for v in block['c_int64'])
        skipped += pages_skipped
    # the rows the predicate's own do_include keeps
    assert kept == [int(r['c_int64']) for r in rows
                    if pred.do_include({f: r[f] for f in pred.get_fields()})]
    routes = _routes()
    assert routes['fused_pred_batches_total'] == 4
    assert routes.get('fused_pred_pages_skipped_total', 0) == skipped
    assert routes.get('fused_pred_rows_selected', 0) == len(kept)
    assert not any(':predicate' in k for k in routes), routes
    if case == 'page-skip':
        assert skipped > 0
    ours.close()
    theirs.close()


def _declined_cases(mod):
    """Predicates with native clauses the kernel cannot evaluate on this
    store: a numeric set over a string column, a bound no int64 equals."""
    return {'string-column': mod.in_set([1, 2], 'c_str'),
            'fractional-bound': mod.in_range('c_int64', lo=2.5),
            'and-with-string': mod.in_reduce([mod.in_range('c_int64', lo=10),
                                              mod.in_set([3], 'c_str')], all)}


@pytest.mark.parametrize('case', sorted(_declined_cases(predicates)))
def test_declined_clauses_count_the_jax_reasons(scalar_stores, case):
    url, schema, _rows = scalar_stores['snappy']
    path = _parquet_path(url)
    ours, theirs = native.NativeParquetFile(path), jax_native.NativeParquetFile(path)
    pred = _declined_cases(predicates)[case]
    clauses = pred.native_clauses()
    assert clauses == _declined_cases(jax_predicates)[case].native_clauses() is not None
    fields = sorted(pred.get_fields())
    native.read_routes.reset()
    obs.configure('counters')
    obs.get_registry().reset()
    assert ours.read_fused_predicate(0, list(schema.fields), fields, clauses,
                                     schema.fields) is None
    assert theirs.read_fused_predicate(0, list(schema.fields), fields, clauses,
                                       schema.fields) is None
    reasons = {k: v for k, v in _routes().items() if k.startswith('fused_fallback_')}
    assert reasons == {k: v for k, v in _jax_counters().items()
                       if k.startswith('fused_fallback_')}
    assert {k for k in reasons if k.startswith('fused_fallback_column:')} == {
        'fused_fallback_column:{}:predicate'.format(f) for f in fields}
    ours.close()
    theirs.close()


def test_one_native_call_per_filtered_batch(scalar_stores, monkeypatch):
    url, schema, _rows = scalar_stores['snappy']
    pf = native.NativeParquetFile(_parquet_path(url))
    pred_calls, unfiltered = [], []
    real = fused._invoke_read_fused_pred
    monkeypatch.setattr(fused, '_invoke_read_fused_pred',
                        lambda *a: (pred_calls.append(a), real(*a))[1])
    monkeypatch.setattr(fused, '_invoke_read_fused', lambda *a: unfiltered.append(a))
    pred = predicates.in_range('c_int64', lo=100, hi=300)
    res = pf.read_fused_predicate(0, list(schema.fields), ['c_int64'], pred.native_clauses(),
                                  schema.fields)
    assert res is not None and res[3] > 0
    assert len(pred_calls) == 1 and not unfiltered
    pf.close()


def test_fused_pred_mirror_under_the_jax_packages_abi_rules(tmp_path):
    """PT900 catches a widened ``FusedPred`` field and PT901 a dropped
    argument of ``pstpu_read_fused_pred`` in copies of the port's bindings
    (the unmutated bindings pass both: see test_torch_native_reader.py)."""
    from petastorm_tpu.analysis import run_analysis

    port = os.path.join(REPO, 'petastorm_tpu_torch', 'native')
    assert run_analysis([port], select=['PT9']) == []
    for mutation, code in (
            (('rowgroup_reader.cpp', '  int32_t pages_skipped;', '  int64_t pages_skipped;'),
             'PT900'),
            (('fused.py', "        ctypes.POINTER(ctypes.c_longlong), "
                          "ctypes.POINTER(ctypes.c_longlong)]",
              "        ctypes.POINTER(ctypes.c_longlong)]"), 'PT901')):
        mutant = tmp_path / code / 'native'
        mutant.mkdir(parents=True)
        for name in ('__init__.py', 'fused.py', 'pagescan.py', 'rowgroup_reader.cpp'):
            with open(os.path.join(port, name)) as f:
                text = f.read()
            if name == mutation[0]:
                assert mutation[1] in text
                text = text.replace(mutation[1], mutation[2], 1)
            (mutant / name).write_text(text)
        codes = {f.code for f in run_analysis([str(mutant.parent)], select=['PT9'])}
        assert code in codes, (code, codes)


# -- make_reader against the JAX reader ---------------------------------------------

SYNSETS = 6
ROWS = 96
ROWS_PER_RG = 8
SIZE = 8


def _photo(rng):
    return rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)


def _write_image_store(url, package):
    """An image store: a synset id, a label (``i % 10``) and a fixed-shape PNG,
    8 rows per row group, indexed by synset (by the writing package)."""
    materialize, field_cls, schema_cls, cm = PACKAGES[package]
    schema = schema_cls('Filtered', [
        field_cls('noun_id', np.str_, (), cm.ScalarCodec(), False),
        field_cls('label', np.int64, (), cm.ScalarCodec(np.int64), False),
        field_cls('image', np.uint8, (SIZE, SIZE, 3), cm.CompressedImageCodec('png'), False)])
    rng = np.random.default_rng(11)
    with materialize(url, schema, rows_per_row_group=ROWS_PER_RG) as w:
        for i in range(ROWS):
            w.write({'noun_id': 'n{:08d}'.format(i * SYNSETS // ROWS), 'label': np.int64(i % 10),
                     'image': _photo(rng)})
    if package == 'torch':
        build_rowgroup_index(url, [SingleFieldIndexer('noun_id_idx', 'noun_id')])
    else:
        jax_indexing.build_rowgroup_index(url, [jax_indexers.SingleFieldIndexer('noun_id_idx',
                                                                                'noun_id')])


@pytest.fixture(scope='module')
def image_stores(tmp_path_factory):
    urls = {}
    for package in ('torch', 'jax'):
        urls[package] = 'file://' + str(tmp_path_factory.mktemp('filtered_' + package))
        _write_image_store(urls[package], package)
    return urls


def _config(mod, sel_mod, name):
    """make_reader filtering arguments, built from either package."""
    return {
        'native-set': {'predicate': mod.in_set(list(range(0, 10, 3)), 'label')},
        'native-range': {'predicate': mod.in_range('label', lo=2, hi=6)},
        'native-negate': {'predicate': mod.in_negate(mod.in_set([0, 1, 2], 'label'))},
        'python-strings': {'predicate': mod.in_set(['n00000001', 'n00000004'], 'noun_id')},
        'python-split': {'predicate': mod.in_pseudorandom_split([0.6, 0.4], 1, 'noun_id')},
        'none-survive': {'predicate': mod.in_range('label', lo=100)},
        'selector': {'rowgroup_selector': sel_mod.SingleIndexSelector(
            'noun_id_idx', ['n00000000', 'n00000003', 'n00000005'])},
        'row-drop-2': {'shuffle_row_drop_partitions': 2},
        'row-drop-3': {'shuffle_row_drop_partitions': 3},
        'set-row-drop-3': {'predicate': mod.in_set([1, 4, 7, 8], 'label'),
                           'shuffle_row_drop_partitions': 3},
        'python-row-drop-2': {'predicate': mod.in_set(['n00000002'], 'noun_id'),
                              'shuffle_row_drop_partitions': 2},
        'all-three': {'rowgroup_selector': sel_mod.SingleIndexSelector(
            'noun_id_idx', ['n00000001', 'n00000002', 'n00000004']),
            'predicate': mod.in_reduce([mod.in_range('label', lo=1),
                                        mod.in_negate(mod.in_set([5], 'label'))], all),
            'shuffle_row_drop_partitions': 2},
    }[name]


CONFIGS = ['native-set', 'native-range', 'native-negate', 'python-strings', 'python-split',
           'none-survive', 'selector', 'row-drop-2', 'row-drop-3', 'set-row-drop-3',
           'python-row-drop-2', 'all-three']


def _rows_of(factory, url, output='rows', **kwargs):
    with factory(url, reader_pool_type='dummy', seed=7, output=output, **kwargs) as reader:
        if output == 'rows':
            return [(r.noun_id, int(r.label), r.image.tobytes()) for r in reader]
        return [(tuple(b.noun_id), b.label.tolist(), b.image.tobytes()) for b in reader]


def _expected(cfg, url):
    """The rows a configuration keeps, in store order, from the store as
    written."""
    table = pq.read_table(url[len('file://'):], columns=['noun_id', 'label'])
    rows = list(zip(table.column('noun_id').to_pylist(), table.column('label').to_pylist()))
    keep = np.ones(len(rows), bool)
    if 'predicate' in cfg:
        keep &= [bool(cfg['predicate'].do_include({'noun_id': n, 'label': np.int64(lab)}))
                 for n, lab in rows]
    if 'rowgroup_selector' in cfg:
        picked = cfg['rowgroup_selector'].select_row_groups(get_row_group_indexes(url))
        keep &= np.isin(np.arange(len(rows)) // ROWS_PER_RG, sorted(picked))
    return sorted((n, lab) for (n, lab), k in zip(rows, keep) if k)


@pytest.mark.parametrize('writer', ['torch', 'jax'])
@pytest.mark.parametrize('name', CONFIGS)
def test_make_reader_rows_and_order_equal_jax(image_stores, name, writer):
    url = image_stores[writer]
    cfg = _config(predicates, selectors, name)
    jax_cfg = _config(jax_predicates, jax_selectors, name)
    expected = _rows_of(jax_make_reader, url, **jax_cfg)
    native.read_routes.reset()
    got = _rows_of(make_reader, url, **cfg)
    assert got == expected
    assert sorted((n, lab) for n, lab, _ in got) == _expected(cfg, url)
    routes = _routes()
    pred = cfg.get('predicate')
    if pred is not None and pred.native_clauses() is not None:
        # every filtered row group through the fused predicate call
        assert routes['fused_pred_batches_total'] > 0
        # only the string column, through Arrow for the surviving rows
        assert {k for k in routes if k.startswith('fused_fallback_column:')} <= {
            'fused_fallback_column:noun_id:codec'}, routes
        assert routes.get('arrow_fallback_columns_total', 0) <= routes['fused_pred_batches_total']
    elif pred is not None:
        assert not routes.get('fused_pred_batches_total')
    # column blocks too, and the Python pushdown with the fused read off
    assert (_rows_of(make_reader, url, output='columnar', **cfg)
            == _rows_of(jax_make_reader, url, output='columnar', **jax_cfg))
    os.environ['PSTPU_DISABLE_FUSED'] = '1'
    try:
        assert _rows_of(make_reader, url, **cfg) == expected
    finally:
        del os.environ['PSTPU_DISABLE_FUSED']


@pytest.mark.parametrize('name', ['native-set', 'row-drop-3', 'all-three'])
def test_loader_batches_equal_jax(image_stores, name):
    from petastorm_tpu.jax import JaxDataLoader

    url = image_stores['torch']
    with make_reader(url, reader_pool_type='dummy', seed=7, output='columnar',
                     **_config(predicates, selectors, name)) as reader:
        ours = [{k: np.asarray(v) for k, v in b.items()}
                for b in TorchDataLoader(reader, 4, shuffling_queue_capacity=16, seed=7)]
    with jax_make_reader(url, reader_pool_type='dummy', seed=7, output='columnar',
                         **_config(jax_predicates, jax_selectors, name)) as reader:
        theirs = [{k: np.asarray(v) for k, v in b.items()}
                  for b in JaxDataLoader(reader, 4, shuffling_queue_capacity=16, seed=7)]
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        _assert_block_equal(a, b)


def _multiset(url, pool_type, epochs, **kwargs):
    pool_kwargs = {'pool_kwargs': TIMEOUT} if pool_type == 'process' else {}
    with make_reader(url, reader_pool_type=pool_type, workers_count=2, seed=3,
                     num_epochs=epochs, output='columnar', **pool_kwargs, **kwargs) as reader:
        rows = collections.Counter()
        for block in reader:
            for n, lab, img in zip(block.noun_id, block.label, block.image):
                rows[(n, int(lab), img.tobytes())] += 1
        diagnostics = reader.diagnostics
    return rows, diagnostics


@pytest.mark.parametrize('pool', ['thread', 'process-copy', 'process-zero-copy'])
@pytest.mark.parametrize('name', ['set-row-drop-3', 'all-three', 'none-survive',
                                  'python-row-drop-2'])
def test_pools_deliver_the_dummy_pools_multiset(image_stores, pool, name):
    url = image_stores['torch']
    cfg = _config(predicates, selectors, name)
    epochs = 2
    expected, _ = _multiset(url, 'dummy', epochs, **cfg)
    pool_type = pool.split('-')[0]
    extra = {'zero_copy': True} if pool == 'process-zero-copy' else {}
    live = registry().counters()['lifetime_live_borrows']
    got, diagnostics = _multiset(url, pool_type, epochs, **cfg, **extra)
    assert got == expected
    assert sum(expected.values()) == epochs * len(_expected(cfg, url))
    # every item completed, those that kept no row included
    assert diagnostics['items_completed'] == diagnostics['items_ventilated']
    assert diagnostics['items_quarantined'] == 0
    if pool_type == 'process':
        assert diagnostics['worker_restarts'] == 0
        gc.collect()
        assert registry().counters()['lifetime_live_borrows'] == live
        assert not [f for f in os.listdir('/dev/shm')
                    if f.startswith(('pstpu_{}_'.format(os.getpid()),
                                     'pstpu_blobs_{}_'.format(os.getpid())))]


def test_process_pool_counts_the_workers_filtered_reads(image_stores):
    native.read_routes.reset()
    cfg = _config(predicates, selectors, 'native-set')
    rows, _ = _multiset(image_stores['torch'], 'process', 1, **cfg)
    routes = _routes()
    assert sum(rows.values()) == len(_expected(cfg, image_stores['torch']))
    # the MSG_METRICS piggyback carries the workers' filtered-read counts
    assert routes['fused_pred_batches_total'] == ROWS // ROWS_PER_RG
    assert routes['fused_pred_rows_selected'] == sum(rows.values())


def test_unpicklable_predicate_fails_loudly_on_the_process_pool(image_stores):
    pred = predicates.in_lambda(['label'], lambda v: v['label'] > 3)
    with pytest.raises(pickle.PicklingError, match='process pool'):
        make_reader(image_stores['torch'], reader_pool_type='process', workers_count=1,
                    predicate=pred, pool_kwargs=TIMEOUT)
    # threads share the object: the lambda is fine there
    with make_reader(image_stores['torch'], reader_pool_type='thread', workers_count=2,
                     predicate=pred) as reader:
        assert sorted(int(r.label) for r in reader) == sorted(
            lab for _, lab in _expected({'predicate': pred}, image_stores['torch']))


# -- refusals -----------------------------------------------------------------------

def test_no_data_available_when_the_selector_keeps_nothing(image_stores):
    url = image_stores['torch']
    with pytest.raises(NoDataAvailableError) as ours:
        make_reader(url, rowgroup_selector=selectors.SingleIndexSelector('noun_id_idx',
                                                                         ['nope']))
    with pytest.raises(Exception) as theirs:
        jax_make_reader(url, rowgroup_selector=jax_selectors.SingleIndexSelector(
            'noun_id_idx', ['nope']))
    assert str(ours.value) == str(theirs.value)
    assert 'Check predicate/selector' in str(ours.value)


def test_unknown_predicate_field_raises_the_jax_error(image_stores):
    url = image_stores['torch']
    with pytest.raises(ValueError) as ours:
        with make_reader(url, reader_pool_type='dummy',
                         predicate=predicates.in_set([1], 'no_such_field')) as reader:
            next(reader)
    with pytest.raises(ValueError) as theirs:
        with jax_make_reader(url, reader_pool_type='dummy',
                             predicate=jax_predicates.in_set([1], 'no_such_field')) as reader:
            next(reader)
    assert str(ours.value) == str(theirs.value)


def test_bad_row_drop_partitions_and_ngram_refused(image_stores):
    # NGram windows are ported: what is refused is what the JAX package
    # refuses, with its messages
    from petastorm_tpu.jax import JaxDataLoader
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.sequence import CollateSpec, PadSpec

    url = image_stores['torch']
    with pytest.raises(ValueError, match='shuffle_row_drop_partitions must be >= 1'):
        make_reader(url, shuffle_row_drop_partitions=0)
    for ngram_cls, factory in ((NGram, make_reader), (JaxNGram, jax_make_reader)):
        no_overlap = ngram_cls({0: ['label'], 1: ['label']}, 1, 'label', timestamp_overlap=False)
        with pytest.raises(NotImplementedError, match='timestamp_overlap=False'):
            factory(url, ngram=no_overlap, shuffle_row_drop_partitions=2)
        with pytest.raises(ValueError, match='batch_size rebatching is not supported with ngram'):
            factory(url, ngram=ngram_cls({0: ['label']}, 1, 'label'), output='columnar',
                    batch_size=4)

    class NgramReader(object):
        ngram = object()
        batched_output = False

    for loader_cls in (TorchDataLoader, JaxDataLoader):
        with pytest.raises(ValueError, match='collate_spec is not supported with ngram'):
            loader_cls(NgramReader(), 4, collate_spec=CollateSpec({'label': PadSpec()}))


@pytest.mark.parametrize('num_rows, parts', [(16, 1), (16, 2), (16, 3), (7, 3), (2, 3), (0, 2)])
def test_row_drop_indices_equal_jax(num_rows, parts):
    from petastorm_tpu.row_worker import select_row_drop_indices as jax_select

    covered = []
    for part in range(parts):
        spec = (part, parts) if parts > 1 else None
        ours = select_row_drop_indices(num_rows, spec)
        np.testing.assert_array_equal(ours, jax_select(num_rows, spec))
        covered.extend(ours.tolist())
    # each row in exactly one partition
    assert sorted(covered) == list(range(num_rows))


def test_work_items_and_their_order_equal_jax():
    from petastorm_tpu.serve.plan import build_work_items as jax_build
    from petastorm_tpu_torch.reader import build_work_items

    pred = predicates.in_set([1], 'label')
    for parts in (1, 2, 3):
        ours = build_work_items(5, parts, pred)
        theirs = jax_build(5, parts, pred)
        assert ours == theirs
    assert build_work_items(2, 1, None) == [{'piece_index': 0}, {'piece_index': 1}]


def test_selector_store_copy_keeps_the_writers_keys(image_stores, tmp_path):
    """An index built over a store keeps it readable by both packages (the
    metadata rewrite drops no key)."""
    shutil.copytree(image_stores['jax'][len('file://'):], tmp_path, dirs_exist_ok=True)
    url = 'file://' + str(tmp_path)
    build_rowgroup_index(url, [SingleFieldIndexer('label_idx', 'label')])
    sel = selectors.SingleIndexSelector('label_idx', [3])
    jax_sel = jax_selectors.SingleIndexSelector('label_idx', [3])
    assert (_rows_of(make_reader, url, rowgroup_selector=sel)
            == _rows_of(jax_make_reader, url, rowgroup_selector=jax_sel))
