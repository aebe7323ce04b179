"""The DataFrame converter and the Spark adapters of the port against the
JAX package: the same frames give the same cache keys, the same stored
files and the same batches (the port's ``make_torch_loader`` on the CPU
beside JAX's ``make_jax_loader``). The pyspark surfaces run against
``petastorm_tpu/test_util/minispark.py`` installed as ``pyspark`` for one
test at a time, as the JAX package's own tests run them."""

import os
import pickle
import sys
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import observability as jax_obs
from petastorm_tpu.spark import dataset_converter as jax_dc
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.spark import (DatasetConverter, make_converter, make_spark_converter,
                                       register_delete_dir_handler)
from petastorm_tpu_torch.spark import dataset_converter as dc
from petastorm_tpu_torch.spark_utils import dataset_as_dataframe, dataset_as_rdd


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu.observability import blackbox as jax_blackbox
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


class _AtExit(object):
    """Stands in for the converter modules' ``atexit``: records the
    deletions a conversion registers instead of leaving them in the
    interpreter."""

    def __init__(self):
        self.registered = []

    def register(self, fn, *args):
        self.registered.append((fn, args))


@pytest.fixture(autouse=True)
def _converter_state(monkeypatch):
    """The converters' module-level state: both packages' dedup entries
    emptied before and after, the delete handlers restored, and the atexit
    registrations kept in a recorder per package."""
    recorders = {}
    for name, module in (('torch', dc), ('jax', jax_dc)):
        recorders[name] = _AtExit()
        monkeypatch.setattr(module, 'atexit', recorders[name])
        monkeypatch.setattr(module, '_delete_dir_handler', module._delete_dir_handler)
        with module._cache_lock:
            module._cache_entries.clear()
    yield recorders
    for module in (dc, jax_dc):
        with module._cache_lock:
            module._cache_entries.clear()


@pytest.fixture
def cache_dir(tmp_path):
    d = tmp_path / 'converter_cache'
    d.mkdir()
    return 'file://' + str(d)


def _df(n=100):
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        'id': np.arange(n, dtype=np.int64),
        'value': rng.random(n),  # float64 on purpose (precision)
        'label': (np.arange(n) % 3).astype(np.int32),
    })


def _array_df():
    return pd.DataFrame({'id': np.arange(4, dtype=np.int64),
                         'feat': [np.full(3, float(i), dtype=np.float32) for i in range(4)]})


def _numpy(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


def _torch_batches(conv, **kwargs):
    kwargs.setdefault('device', 'cpu')
    with conv.make_torch_loader(reader_pool_type='dummy', shuffle_row_groups=False,
                                **kwargs) as loader:
        return [_numpy(b) for b in loader]


def _jax_batches(url, **kwargs):
    conv = jax_dc.DatasetConverter(url, 0)
    with conv.make_jax_loader(reader_pool_type='dummy', shuffle_row_groups=False,
                              **kwargs) as loader:
        return [_numpy({k: np.asarray(v) for k, v in b.items()}) for b in loader]


def _assert_batches_equal(batches, jax_batches):
    assert len(batches) == len(jax_batches)
    for b, j in zip(batches, jax_batches):
        assert sorted(b) == sorted(j)
        for k in b:
            assert b[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(b[k], j[k], err_msg=k)


def _frames():
    table = pa.table({'id': np.arange(10, dtype=np.int64), 'x': np.linspace(0, 1, 10)})
    return {'pandas': pa.Table.from_pandas(_df(), preserve_index=False),
            'arrays': pa.Table.from_pandas(_array_df(), preserve_index=False),
            'arrow': table}


@pytest.mark.parametrize('frame', ['pandas', 'arrays', 'arrow'])
@pytest.mark.parametrize('options', [
    ('file:///a', dc.DEFAULT_ROW_GROUP_SIZE_BYTES, None, 'float32'),
    ('file:///b', 1024, 'zstd', 'float64')])
def test_fingerprint_is_the_jax_packages(frame, options):
    table = _frames()[frame]
    assert dc._fingerprint(table, *options) == jax_dc._fingerprint(table, *options)
    assert dc._fingerprint(table, *options).startswith('local:')


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_fingerprint_refuses_a_frame_not_converted(pkg):
    module = dc if pkg == 'torch' else jax_dc
    with pytest.raises(TypeError):
        module._fingerprint(_df(), 'file:///a', 1, None, 'float32')


@pytest.mark.parametrize('precision,row_group_bytes', [('float32', dc.DEFAULT_ROW_GROUP_SIZE_BYTES),
                                                        ('float64', 1024)])
def test_stored_files_and_batches_match_jax(tmp_path, precision, row_group_bytes):
    convs = {}
    for pkg, module in (('torch', dc), ('jax', jax_dc)):
        (tmp_path / pkg).mkdir()
        convs[pkg] = module.make_converter(_df(), parent_cache_dir_url='file://' + str(
            tmp_path / pkg), precision=precision, parquet_row_group_size_bytes=row_group_bytes)
    tables = {pkg: pq.read_table(os.path.join(conv.cache_dir_url[len('file://'):],
                                              'part-00000.parquet'))
              for pkg, conv in convs.items()}
    assert tables['torch'].equals(tables['jax'])
    assert tables['torch'].schema.field('value').type == pa.from_numpy_dtype(np.dtype(precision))
    rows_per_group = dc.rows_per_row_group_for_bytes(tables['torch'], row_group_bytes)
    assert pq.ParquetFile(os.path.join(convs['torch'].cache_dir_url[len('file://'):],
                                       'part-00000.parquet')).num_row_groups == \
        -(-100 // rows_per_group) == (1 if row_group_bytes > 1 << 20 else 2)
    batches = _torch_batches(convs['torch'], batch_size=10, num_epochs=1)
    _assert_batches_equal(batches, _jax_batches(convs['torch'].cache_dir_url, batch_size=10,
                                                num_epochs=1))
    assert sum(len(b['id']) for b in batches) == 100
    assert batches[0]['value'].dtype == np.dtype(precision)


def test_converter_roundtrip(cache_dir):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    assert len(conv) == 100
    batches = _torch_batches(conv, batch_size=10, num_epochs=1)
    assert sorted(i for b in batches for i in b['id'].tolist()) == list(range(100))
    assert batches[0]['value'].dtype == np.float32  # the default precision


def test_torch_loader_stages_onto_the_device_it_is_given(cache_dir):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    with conv.make_torch_loader(batch_size=25, num_epochs=1, to_device=torch.device('cpu'),
                                reader_pool_type='dummy') as loader:
        batch = next(iter(loader))
    assert isinstance(batch['id'], torch.Tensor) and batch['id'].device.type == 'cpu'
    with pytest.raises(ValueError, match='not both'):
        conv.make_torch_loader(device='cpu', to_device='cpu')


@pytest.mark.skipif(torch.cuda.is_available(), reason='the refusal is of a host without CUDA')
def test_torch_loader_runs_on_the_card_unless_asked_for_the_cpu(cache_dir):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv.make_torch_loader(batch_size=10)


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_invalid_precision(cache_dir, pkg):
    module = dc if pkg == 'torch' else jax_dc
    with pytest.raises(ValueError, match='precision'):
        module.make_converter(_df(), parent_cache_dir_url=cache_dir, precision='float16')


def test_dedups_same_content(cache_dir):
    conv1 = make_converter(_df(), parent_cache_dir_url=cache_dir)
    conv2 = make_converter(_df(), parent_cache_dir_url=cache_dir)  # re-created, equal
    assert conv1.cache_dir_url == conv2.cache_dir_url
    assert len(os.listdir(cache_dir[len('file://'):])) == 1


def test_distinct_content_not_deduped(cache_dir):
    conv1 = make_converter(_df(), parent_cache_dir_url=cache_dir)
    df2 = _df()
    df2['value'] = df2['value'] + 1.0
    assert make_converter(df2, parent_cache_dir_url=cache_dir).cache_dir_url != \
        conv1.cache_dir_url


def test_distinct_options_not_deduped(cache_dir):
    conv1 = make_converter(_df(), parent_cache_dir_url=cache_dir)
    conv2 = make_converter(_df(), parent_cache_dir_url=cache_dir, precision='float64')
    assert conv1.cache_dir_url != conv2.cache_dir_url


def test_array_columns(cache_dir):
    conv = make_converter(_array_df(), parent_cache_dir_url=cache_dir)
    assert make_converter(_array_df().copy(), parent_cache_dir_url=cache_dir).cache_dir_url == \
        conv.cache_dir_url
    batches = _torch_batches(conv, batch_size=4, num_epochs=1)
    _assert_batches_equal(batches, _jax_batches(conv.cache_dir_url, batch_size=4, num_epochs=1))
    assert batches[0]['feat'].shape == (4, 3) and batches[0]['feat'][2][0] == 2.0


def test_new_parent_dir_rematerializes(tmp_path):
    for name in 'ab':
        (tmp_path / name).mkdir()
    conv_a = make_converter(_df(), parent_cache_dir_url='file://' + str(tmp_path / 'a'))
    conv_b = make_converter(_df(), parent_cache_dir_url='file://' + str(tmp_path / 'b'))
    assert conv_a.cache_dir_url.startswith('file://' + str(tmp_path / 'a'))
    assert conv_b.cache_dir_url.startswith('file://' + str(tmp_path / 'b'))


def test_accepts_an_arrow_table(cache_dir):
    table = pa.table({'id': np.arange(10, dtype=np.int64), 'x': np.linspace(0, 1, 10)})
    conv = make_converter(table, parent_cache_dir_url=cache_dir)
    assert len(conv) == 10
    batch = _torch_batches(conv, batch_size=5, num_epochs=1)[0]
    assert batch['x'].dtype == np.float32


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_rejects_an_unsupported_type(cache_dir, pkg):
    module = dc if pkg == 'torch' else jax_dc
    with pytest.raises(TypeError):
        module.make_converter([1, 2, 3], parent_cache_dir_url=cache_dir)


def test_requires_a_cache_dir(monkeypatch):
    monkeypatch.delenv(dc.CACHE_DIR_ENV_VAR, raising=False)
    with pytest.raises(ValueError, match='cache dir'):
        make_converter(_df())
    assert dc.CACHE_DIR_ENV_VAR == jax_dc.CACHE_DIR_ENV_VAR


def test_env_var_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(dc.CACHE_DIR_ENV_VAR, 'file://' + str(tmp_path))
    assert make_converter(_df()).cache_dir_url.startswith('file://' + str(tmp_path))


def test_delete_and_the_atexit_deletion(cache_dir, _converter_state):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    local_path = conv.cache_dir_url[len('file://'):]
    assert os.path.exists(local_path)
    assert _converter_state['torch'].registered == [(dc._delete_cache_data_atexit,
                                                     (conv.cache_dir_url,))]
    conv.delete()
    assert not os.path.exists(local_path)
    # the exit-time deletion of a directory already deleted is quiet
    fn, args = _converter_state['torch'].registered[0]
    fn(*args)
    # delete() took it out of the dedup entries: converting again materializes
    conv2 = make_converter(_df(), parent_cache_dir_url=cache_dir)
    assert conv2.cache_dir_url != conv.cache_dir_url
    fn, args = _converter_state['torch'].registered[1]
    fn(*args)
    assert not os.path.exists(conv2.cache_dir_url[len('file://'):])


def test_register_delete_dir_handler(cache_dir):
    calls = []
    register_delete_dir_handler(calls.append)
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    conv.delete()
    assert calls == [conv.cache_dir_url]
    assert os.path.exists(conv.cache_dir_url[len('file://'):])
    register_delete_dir_handler(None)
    assert dc._delete_dir_handler is dc._default_delete_dir_handler


def test_a_failing_exit_deletion_warns(cache_dir):
    register_delete_dir_handler(lambda url: 1 / 0)
    with pytest.warns(UserWarning, match='delete cache data'):
        dc._delete_cache_data_atexit(cache_dir)


def test_converter_pickles(cache_dir):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    restored = pickle.loads(pickle.dumps(conv))
    assert (restored.cache_dir_url, len(restored)) == (conv.cache_dir_url, len(conv))
    # the JAX package's converter opens the same cache
    jax_conv = jax_dc.DatasetConverter(conv.cache_dir_url, len(conv))
    assert pickle.loads(pickle.dumps(jax_conv)).cache_dir_url == conv.cache_dir_url


def test_torch_dataloader(cache_dir):
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    with conv.make_torch_dataloader(batch_size=20, num_epochs=1) as loader:
        ids = sorted(i for batch in loader for i in batch['id'].tolist())
    assert ids == list(range(100))
    with jax_dc.DatasetConverter(conv.cache_dir_url, 100).make_torch_dataloader(
            batch_size=20, num_epochs=1, reader_pool_type='dummy',
            shuffle_row_groups=False) as jax_loader, \
            conv.make_torch_dataloader(batch_size=20, num_epochs=1, reader_pool_type='dummy',
                                       shuffle_row_groups=False) as loader:
        for a, b in zip(loader, jax_loader):
            for k in a:
                assert torch.equal(a[k], b[k]), k


def test_tf_dataset(cache_dir):
    tf = pytest.importorskip('tensorflow')
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir)
    with conv.make_tf_dataset(batch_size=25, num_epochs=1, reader_pool_type='dummy',
                              shuffle_row_groups=False) as dataset:
        batches = list(dataset)
    with jax_dc.DatasetConverter(conv.cache_dir_url, 100).make_tf_dataset(
            batch_size=25, num_epochs=1, reader_pool_type='dummy',
            shuffle_row_groups=False) as jax_dataset:
        jax_batches = list(jax_dataset)
    assert sum(int(b.id.shape[0]) for b in batches) == 100
    assert batches[0].value.dtype == tf.float32
    for a, b in zip(batches, jax_batches):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())


@pytest.mark.parametrize('shards', [2, 3])
def test_sharded_loaders(cache_dir, shards):
    # 16 rows of 16 bytes a row group: 7 row groups
    conv = make_converter(_df(), parent_cache_dir_url=cache_dir,
                          parquet_row_group_size_bytes=256)
    seen = []
    for shard in range(shards):
        batches = _torch_batches(conv, batch_size=10, num_epochs=1, drop_last=False,
                                 cur_shard=shard, shard_count=shards)
        _assert_batches_equal(batches, _jax_batches(
            conv.cache_dir_url, batch_size=10, num_epochs=1, drop_last=False,
            cur_shard=shard, shard_count=shards))
        seen.extend(i for b in batches for i in b['id'].tolist())
    assert sorted(seen) == list(range(100))


def test_make_torch_loader_is_make_jax_loader_renamed():
    import inspect
    params = list(inspect.signature(DatasetConverter.make_torch_loader).parameters)
    jax_params = list(inspect.signature(jax_dc.DatasetConverter.make_jax_loader).parameters)
    assert [p for p in params if p != 'device'] == jax_params


def test_aliases():
    assert make_spark_converter is make_converter
    assert DatasetConverter is dc.SparkDatasetConverter


def test_dataset_as_dataframe(tmp_path):
    from petastorm_tpu.spark_utils import dataset_as_dataframe as jax_dataset_as_dataframe
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_petastorm_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(), False)])
    url = 'file://' + str(tmp_path / 'ds')
    write_petastorm_dataset(url, schema, ({'id': i} for i in range(30)), rows_per_row_group=10)
    frame = dataset_as_dataframe(url)
    assert sorted(frame['id'].tolist()) == list(range(30))
    jax_frame = jax_dataset_as_dataframe(url)
    assert sorted(frame['id'].tolist()) == sorted(jax_frame['id'].tolist())


def test_dataset_as_rdd_refuses_a_non_session():
    with pytest.raises(TypeError, match='sparkContext'):
        dataset_as_rdd('file:///nowhere', object())


# -- the pyspark surfaces, through minispark ------------------------------------------

@pytest.fixture()
def spark(monkeypatch):
    """A SparkSession: real pyspark when it is importable, else the JAX
    package's minispark stand-in registered for this test only."""
    try:
        import pyspark  # noqa: F401
    except ImportError:
        from petastorm_tpu.test_util import minispark
        scoped = {}
        minispark.install(scoped)
        for name, mod in scoped.items():
            monkeypatch.setitem(sys.modules, name, mod)
    from pyspark.sql import SparkSession
    session = SparkSession.builder.master('local[3]').appName('pstpu-torch-test').getOrCreate()
    yield session
    session.stop()


@pytest.fixture()
def petastorm_store(tmp_path):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_petastorm_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(), False),
                             UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'store')
    rng = np.random.default_rng(7)
    rows = {i: rng.random(4).astype(np.float32) for i in range(60)}
    write_petastorm_dataset(url, schema, ({'id': i, 'vec': rows[i]} for i in range(60)),
                            rows_per_row_group=15)
    return url, rows


def test_dataset_as_rdd_executes(spark, petastorm_store):
    from petastorm_tpu.spark_utils import dataset_as_rdd as jax_dataset_as_rdd

    url, rows = petastorm_store
    rdd = dataset_as_rdd(url, spark)
    collected = rdd.collect()
    assert sorted(int(r.id) for r in collected) == list(range(60))
    for r in collected:
        np.testing.assert_array_equal(np.asarray(r.vec), rows[int(r.id)])
    assert rdd.getNumPartitions() == spark.sparkContext.defaultParallelism
    jax_rows = jax_dataset_as_rdd(url, spark).collect()
    assert sorted((int(r.id), r.vec.tobytes()) for r in collected) == \
        sorted((int(r.id), r.vec.tobytes()) for r in jax_rows)


def test_dataset_as_rdd_schema_fields_subset(spark, petastorm_store):
    url, _ = petastorm_store
    collected = dataset_as_rdd(url, spark, schema_fields=['id']).collect()
    assert sorted(int(r.id) for r in collected) == list(range(60))
    assert not hasattr(collected[0], 'vec')


def test_dataset_as_rdd_more_partitions_than_row_groups(spark, tmp_path):
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_petastorm_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(), False)])
    url = 'file://' + str(tmp_path / 'tiny')
    # one row group, a local[3] session: two partitions come back empty
    write_petastorm_dataset(url, schema, ({'id': i} for i in range(5)), rows_per_row_group=5)
    assert sorted(r.id for r in dataset_as_rdd(url, spark).collect()) == list(range(5))


def _spark_pdf():
    # plain-list array cells: real pyspark cannot infer np.ndarray field types
    return pd.DataFrame({
        'idx': np.arange(20, dtype=np.int64),
        'feature': np.linspace(0.0, 1.0, 20).astype(np.float64),
        'emb': [list(np.arange(3, dtype=np.float64) + i) for i in range(20)],
    })


def test_spark_converter_roundtrip(spark, tmp_path):
    import pyarrow.fs as pafs

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.fs import FilesystemResolver

    df = spark.createDataFrame(_spark_pdf())
    cache = 'file://' + str(tmp_path / 'cache')
    converter = make_spark_converter(df, parent_cache_dir_url=cache)
    assert len(converter) == 20
    # the plan's key is the JAX package's
    assert dc._fingerprint(df, cache, 1, None, 'float32') == \
        jax_dc._fingerprint(df, cache, 1, None, 'float32')
    assert dc._fingerprint(df, cache, 1, None, 'float32').startswith('spark:')
    with make_batch_reader(converter.cache_dir_url, reader_pool_type='dummy') as reader:
        blocks = list(reader)
    idx = np.concatenate([np.asarray(b.idx) for b in blocks])
    feat = np.concatenate([np.asarray(b.feature) for b in blocks])
    assert sorted(idx.tolist()) == list(range(20))
    assert feat.dtype == np.float32  # the precision cast of withColumn
    resolver = FilesystemResolver(converter.cache_dir_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    part = [i.path for i in fs.get_file_info(pafs.FileSelector(root))
            if i.path.endswith('.parquet')][0]
    assert pq.read_schema(fs.open_input_file(part)).field('emb').type == pa.list_(pa.float32())
    # the same frame: the same plan, a cache hit
    assert make_spark_converter(df, parent_cache_dir_url=cache).cache_dir_url == \
        converter.cache_dir_url
    converter.delete()
    assert fs.get_file_info(root).type == pafs.FileType.NotFound


def test_spark_converter_torch_loader(spark, tmp_path):
    pdf = pd.DataFrame({'x': np.arange(32, dtype=np.int64),
                        'y': np.arange(32).astype(np.float64) / 8.0})
    converter = make_spark_converter(spark.createDataFrame(pdf),
                                     parent_cache_dir_url='file://' + str(tmp_path / 'c'))
    batches = _torch_batches(converter, batch_size=8, num_epochs=1)
    assert all(b['y'].dtype == np.float32 for b in batches)
    assert sorted(i for b in batches for i in b['x'].tolist()) == list(range(32))
    _assert_batches_equal(batches, _jax_batches(converter.cache_dir_url, batch_size=8,
                                                num_epochs=1))
