"""Port parity: the host read path of petastorm_tpu_torch (materialize_dataset,
make_reader, TorchDataLoader) against the JAX package's, on raw-tensor stores
made with numpy from a seed. Both packages read each other's stores, and for
one seed they give the same row groups in the same order and the same
shuffled batches."""

import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import RawTensorCodec as JaxRawTensorCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.etl import get_schema, materialize_dataset
from petastorm_tpu_torch.torch import TorchDataLoader


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


IMAGE_SHAPE = (8, 8, 3)
NUM_ROWS = 100
ROWS_PER_ROW_GROUP = 10


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return [{'image': rng.integers(0, 256, IMAGE_SHAPE, dtype=np.uint8), 'label': np.int64(i % 7)}
            for i in range(NUM_ROWS)]


def _write(url, materialize, schema):
    with materialize(url, schema, rows_per_row_group=ROWS_PER_ROW_GROUP, rows_per_file=30) as w:
        for row in _rows():
            w.write(row)


@pytest.fixture(scope='module')
def jax_store(tmp_path_factory):
    """A raw store written by the JAX package's writer."""
    url = 'file://' + str(tmp_path_factory.mktemp('jax_raw_store'))
    schema = JaxUnischema('RawStore', [
        JaxUnischemaField('image', np.uint8, IMAGE_SHAPE, JaxRawTensorCodec(), False),
        JaxUnischemaField('label', np.int64, (), JaxScalarCodec(np.int64), False)])
    _write(url, jax_materialize_dataset, schema)
    return url


@pytest.fixture(scope='module')
def torch_store(tmp_path_factory):
    """The same rows written by the port's writer."""
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path_factory.mktemp('torch_raw_store'))
    schema = Unischema('RawStore', [
        UnischemaField('image', np.uint8, IMAGE_SHAPE, RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    _write(url, materialize_dataset, schema)
    return url


def _blocks(reader_factory, url, **kwargs):
    with reader_factory(url, output='columnar', reader_pool_type='dummy', **kwargs) as reader:
        return [{name: np.asarray(col) for name, col in block._asdict().items()}
                for block in reader]


def _assert_blocks_equal(actual, expected):
    assert len(actual) == len(expected)
    for a, e in zip(actual, expected):
        assert set(a) == set(e)
        for name in e:
            assert a[name].dtype == e[name].dtype, name
            np.testing.assert_array_equal(a[name], e[name], err_msg=name)


@pytest.mark.parametrize('store', ['jax_store', 'torch_store'])
@pytest.mark.parametrize('num_epochs', [1, 2])
def test_columnar_blocks_match_jax_reader(store, num_epochs, request):
    url = request.getfixturevalue(store)
    kwargs = dict(seed=7, shuffle_row_groups=True, num_epochs=num_epochs)
    expected = _blocks(jax_make_reader, url, **kwargs)
    actual = _blocks(make_reader, url, **kwargs)
    assert len(actual) == num_epochs * NUM_ROWS // ROWS_PER_ROW_GROUP
    _assert_blocks_equal(actual, expected)
    # the seed decides the order: another seed gives another one
    other = _blocks(make_reader, url, seed=8, shuffle_row_groups=True, num_epochs=num_epochs)
    assert [b['image'].tobytes() for b in other] != [b['image'].tobytes() for b in actual]


def test_sharded_schema_fields_match_jax_reader(jax_store):
    kwargs = dict(seed=7, cur_shard=1, shard_count=3, schema_fields=['label'])
    expected = _blocks(jax_make_reader, jax_store, **kwargs)
    actual = _blocks(make_reader, jax_store, **kwargs)
    assert all(set(b) == {'label'} for b in actual)
    _assert_blocks_equal(actual, expected)


def _batches(reader_factory, loader_cls, url, output, **loader_kwargs):
    with reader_factory(url, output=output, reader_pool_type='dummy', seed=7) as reader:
        return [{k: np.asarray(v) for k, v in batch.items()}
                for batch in loader_cls(reader, 8, **loader_kwargs)]


@pytest.mark.parametrize('output', ['columnar', 'rows'])
@pytest.mark.parametrize('loader_kwargs', [
    dict(shuffling_queue_capacity=64, seed=7),
    dict(shuffling_queue_capacity=0, drop_last=False),
], ids=['shuffled', 'fifo'])
def test_loader_batches_match_jax_loader(jax_store, output, loader_kwargs):
    expected = _batches(jax_make_reader, JaxDataLoader, jax_store, output, **loader_kwargs)
    actual = _batches(make_reader, TorchDataLoader, jax_store, output, **loader_kwargs)
    assert len(actual) == len(expected) > 1
    _assert_blocks_equal(actual, expected)


def test_port_store_reads_back_in_jax_package(jax_store, torch_store):
    # same metadata: the JAX package loads the port's schema and rows
    from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
    assert jax_get_schema(torch_store).to_json() == jax_get_schema(jax_store).to_json()
    assert get_schema(jax_store).to_json() == jax_get_schema(jax_store).to_json()
    with jax_make_reader(torch_store, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        rows = list(r)
    expected = _rows()
    assert len(rows) == NUM_ROWS
    for row, exp in zip(rows, expected):
        np.testing.assert_array_equal(row.image, exp['image'])
        assert row.label == exp['label']


@pytest.mark.parametrize('output', ['columnar', 'rows'])
def test_thread_pool_delivers_every_row(jax_store, output):
    with make_reader(jax_store, reader_pool_type='thread', workers_count=3, seed=7,
                     output=output) as r:
        items = list(r)
    if output == 'columnar':
        rows = [(int(label), image.tobytes()) for b in items for label, image in zip(b.label, b.image)]
    else:
        rows = [(int(r.label), r.image.tobytes()) for r in items]
    assert sorted(rows) == sorted((int(r['label']), r['image'].tobytes()) for r in _rows())


def test_thread_pool_stress_loses_and_repeats_nothing(jax_store):
    # more workers than cores and a short switch interval: a lost update in
    # the pool's or the ventilator's counters would drop or repeat a row
    # group, or hang the end-of-data check
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with make_reader(jax_store, output='columnar', reader_pool_type='thread',
                         workers_count=16, results_queue_size=2, seed=3, num_epochs=3) as r:
            blocks = list(r)
    finally:
        sys.setswitchinterval(interval)
    rows = sorted(image.tobytes() for b in blocks for image in b.image)
    assert rows == sorted(r['image'].tobytes() for r in _rows() for _ in range(3))


def test_a_consumer_waiting_on_a_stopped_thread_pool_gets_empty_result():
    """A thread still waiting in ``get_results`` when the pool stops, with
    items ventilated that will never complete, is released."""
    import threading

    from petastorm_tpu_torch.errors import EmptyResultError
    from petastorm_tpu_torch.workers import ThreadPool

    class Blocked(object):
        def __init__(self, worker_id, publish_func, args):
            self._release = args

        def process(self, **kwargs):
            self._release.wait(30)

        def shutdown(self):
            pass

    release = threading.Event()
    pool = ThreadPool(1)
    pool.start(Blocked, release)
    pool.ventilate(piece_index=0)
    outcome = []
    consumer = threading.Thread(target=lambda: outcome.append(_result_or_error(pool)))
    consumer.start()
    pool.stop()
    consumer.join(timeout=10)
    assert not consumer.is_alive() and outcome == [EmptyResultError]
    release.set()
    pool.join()


def _result_or_error(pool):
    try:
        return pool.get_results()
    except Exception as e:  # noqa: BLE001 - the test compares the type
        return type(e)


def test_unported_arguments_and_codecs_raise(jax_store, tmp_path):
    # ngram is ported: a bad NGram fails as the JAX reader's does
    from petastorm_tpu_torch.errors import PetastormTpuError
    from petastorm_tpu_torch.ngram import NGram
    with pytest.raises(PetastormTpuError, match='matched no fields'):
        make_reader(jax_store, ngram=NGram({0: ['no_such_field']}, 1, 'no_such_field'))
    # the protocol monitor is ported: it attaches to the pool, and the
    # factory's signature is the JAX one
    with make_reader(jax_store, reader_pool_type='dummy', protocol_monitor=True) as reader:
        assert reader._pool.protocol_monitor is not None
        assert len(list(reader)) == 100
        assert reader._pool.protocol_monitor.snapshot['in_flight'] == []
    import inspect
    from petastorm_tpu import make_reader as jax_make_reader
    assert inspect.signature(make_reader) == inspect.signature(jax_make_reader)
    # remote stores are ported: a local file:// store ignores chunk_cache,
    # as the JAX reader does (no chunk_cache_* counters, no cache directory)
    with make_reader(jax_store, reader_pool_type='dummy',
                     chunk_cache=str(tmp_path / 'chunks')) as reader:
        next(iter(reader))
        assert reader.chunk_cache_config is None
        assert not any(k.startswith('chunk_cache') for k in reader.diagnostics)
    assert not (tmp_path / 'chunks').exists()
    # serve is ported: a combination the JAX reader refuses is refused before
    # any daemon is spawned
    with pytest.raises(ValueError, match='resume_state'):
        make_reader(jax_store, serve=str(tmp_path / 'svc'), resume_state={'version': 2})
    assert not (tmp_path / 'svc').exists()
    # elastic is ported: a value other than True or an ElasticConfig is
    # refused with the JAX reader's error
    with pytest.raises(ValueError, match='must be True or an ElasticConfig'):
        make_reader(jax_store, elastic=object())
    with pytest.raises(TypeError, match='unexpected keyword'):
        make_reader(jax_store, no_such_argument=1)
    with pytest.raises(ValueError, match='requires cache_location'):
        make_reader(jax_store, cache_type='local-disk')
    # every codec id of the JAX package is ported now: a store with an image
    # codec opens, and a codec id neither package knows fails on open
    from petastorm_tpu.codecs import CompressedImageCodec
    url = 'file://' + str(tmp_path)
    schema = JaxUnischema('Png', [
        JaxUnischemaField('image', np.uint8, IMAGE_SHAPE, CompressedImageCodec('png'), False)])
    with jax_materialize_dataset(url, schema, rows_per_row_group=2) as w:
        w.write({'image': _rows()[0]['image']})
    assert get_schema(url).fields['image'].codec.image_codec == 'png'
    from petastorm_tpu_torch.codecs import codec_from_json
    with pytest.raises(SchemaError, match='Unknown codec id'):
        codec_from_json({'codec_id': 'no_such_codec'})
