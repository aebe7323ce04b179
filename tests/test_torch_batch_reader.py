"""Port parity: ``make_batch_reader`` of petastorm_tpu_torch against the JAX
package's: the inferred schema, the raw column blocks on plain stores of
every column type (the reference's conversions kept, ``list<uint8>`` to int64
and ``fixed_size_list`` columns dropped among them), blocks of a petastorm
store, blocks through every pool, reader-side rebatching on both readers,
the predicate and row-drop routes, stores written by either package, and two
train steps of ``chip_smoke.py``'s ``plain_batch`` slice at small width."""

import datetime
import inspect
import pickle
import threading
import time
from decimal import Decimal

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
import petastorm_tpu.predicates as jax_predicates
from petastorm_tpu import TransformSpec as JaxTransformSpec
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.dataset_metadata import infer_or_load_unischema as jax_infer
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.native import image_codec as jax_image_codec
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
import petastorm_tpu_torch.predicates as predicates
from petastorm_tpu_torch import TransformSpec, make_batch_reader, make_reader, native
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.etl.dataset_metadata import infer_or_load_unischema
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import ProcessPoolOptions


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


ROWS = 96
ROWS_PER_ROW_GROUP = 16
SIZE = 32
NUM_CLASSES = 10
BATCH = 8
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def plain_store(tmp_path_factory):
    """A plain Parquet store (pyarrow, no petastorm metadata) with a column
    of each type a plain dump holds, made from a seed."""
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('plain_types'))
    n = ROWS
    lengths = rng.integers(1, 6, n)
    table = pa.table({
        'id': pa.array(np.arange(n, dtype=np.int64)),
        'label': pa.array(rng.integers(0, 7, n).astype(np.int32)),
        'score': pa.array(rng.random(n).astype(np.float32)),
        'flag': pa.array(rng.random(n) < 0.5),
        'name': pa.array(['row_{}'.format(i) for i in range(n)]),
        'maybe': pa.array([None if i % 5 == 0 else 's{}'.format(i) for i in range(n)]),
        'blob': pa.array([bytes(rng.integers(0, 256, 7 + i % 3, dtype=np.uint8))
                          for i in range(n)], pa.binary()),
        'pixels': pa.array([list(rng.integers(0, 256, 6, dtype=np.uint8)) for _ in range(n)],
                           pa.list_(pa.uint8())),
        'ragged': pa.array([list(rng.random(k)) for k in lengths], pa.list_(pa.float64())),
        'fixed': pa.array([[i, i + 1, i + 2] for i in range(n)], pa.list_(pa.int32(), 3)),
        'when': pa.array([datetime.datetime(2021, 1, 1) + datetime.timedelta(seconds=int(i))
                          for i in range(n)], pa.timestamp('us')),
        'day': pa.array([datetime.date(2020, 1, 1 + i % 28) for i in range(n)], pa.date32()),
        'price': pa.array([Decimal('{}.{:02d}'.format(i, i % 100)) for i in range(n)],
                          pa.decimal128(9, 2)),
    })
    path = url[len('file://'):]
    pq.write_table(table, path + '/part-00000.parquet', row_group_size=ROWS_PER_ROW_GROUP)
    return url


def _cell_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _assert_blocks_equal(actual, expected):
    assert len(actual) == len(expected)
    for a, b in zip(actual, expected):
        a, b = a._asdict(), b._asdict()
        assert list(a) == list(b)
        for name in a:
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
            if a[name].dtype == object:
                assert all(_cell_equal(x, y) for x, y in zip(a[name], b[name])), name
            else:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _blocks(make, url, **kwargs):
    with make(url, **kwargs) as reader:
        return list(reader)


def test_inferred_schema_matches_jax(plain_store):
    schema = infer_or_load_unischema(plain_store)
    assert schema.to_json() == jax_infer(plain_store).to_json()
    assert schema.name == 'inferred'
    # the reference drops fixed_size_list columns from the inferred schema
    assert 'fixed' not in schema.fields and 'pixels' in schema.fields
    with pytest.raises(Exception, match='Cannot map'):
        Unischema.from_arrow_schema(pq.read_schema(plain_store[len('file://'):]
                                                   + '/part-00000.parquet'),
                                    omit_unsupported_fields=False)


def test_plain_blocks_equal_jax(plain_store):
    kwargs = dict(reader_pool_type='dummy', seed=5)
    blocks = _blocks(make_batch_reader, plain_store, **kwargs)
    _assert_blocks_equal(blocks, _blocks(jax_make_batch_reader, plain_store, **kwargs))
    assert len(blocks) == ROWS // ROWS_PER_ROW_GROUP
    first = blocks[0]
    # the reference's conversions: list<uint8> through to_pylist comes out
    # int64, fixed_size_list is not read, binary cells are bytes
    assert first.pixels.dtype == np.int64 and first.pixels.shape == (ROWS_PER_ROW_GROUP, 6)
    assert 'fixed' not in first._fields
    assert first.blob.dtype == object and isinstance(first.blob[0], bytes)
    assert first.ragged.dtype == object and first.name.dtype.kind == 'U'
    assert first.price.dtype == object and isinstance(first.price[0], Decimal)


@pytest.mark.parametrize('pool', ['thread', 'process'])
def test_plain_blocks_through_pools_as_multisets(plain_store, pool):
    fields = ['id', 'label', 'name', 'blob', 'pixels', 'price']
    expected = _blocks(jax_make_batch_reader, plain_store, reader_pool_type='dummy', seed=5,
                       schema_fields=fields)
    pool_type = ProcessPoolOptions(results_timeout_s=60) if pool == 'process' else pool
    actual = _blocks(make_batch_reader, plain_store, reader_pool_type=pool_type,
                     workers_count=2, seed=5, schema_fields=fields)
    _assert_blocks_equal(sorted(actual, key=lambda b: b.id[0]),
                         sorted(expected, key=lambda b: b.id[0]))


def test_petastorm_store_blocks_equal_jax(synthetic_dataset):
    # a petastorm store's stored Unischema is loaded, its columns read raw
    fields = ['id', 'id_float', 'python_primitive_uint8', 'image_png', 'decimal',
              'sensor_name', 'matrix_nullable']
    kwargs = dict(reader_pool_type='dummy', seed=3, schema_fields=fields)
    blocks = _blocks(make_batch_reader, synthetic_dataset.url, **kwargs)
    _assert_blocks_equal(blocks, _blocks(jax_make_batch_reader, synthetic_dataset.url, **kwargs))
    assert sorted(i for b in blocks for i in b.id) == list(range(100))
    assert isinstance(blocks[0].image_png[0], bytes)


@pytest.fixture(scope='module')
def written_stores(tmp_path_factory):
    """The same rows as a petastorm store written by each package."""
    out = {}
    for name, materialize, schema in (
            ('jax', jax_materialize_dataset, JaxUnischema('S', [
                JaxField('id', np.int64, (), JaxScalarCodec(np.int64), False),
                JaxField('x', np.float32, (), JaxScalarCodec(np.float32), False)])),
            ('torch', materialize_dataset, Unischema('S', [
                UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
                UnischemaField('x', np.float32, (), ScalarCodec(np.float32), False)]))):
        url = 'file://' + str(tmp_path_factory.mktemp('written_' + name))
        with materialize(url, schema, rows_per_row_group=10) as writer:
            for i in range(75):
                writer.write({'id': np.int64(i), 'x': np.float32(i) / 4})
        out[name] = url
    return out


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('batch_size,drop_last', [(None, False), (16, False), (16, True),
                                                  (7, False)])
def test_rebatching_equals_jax_on_both_readers(written_stores, writer, batch_size, drop_last):
    url = written_stores[writer]
    kwargs = dict(reader_pool_type='dummy', seed=9, batch_size=batch_size, drop_last=drop_last)
    batch = _blocks(make_batch_reader, url, **kwargs)
    _assert_blocks_equal(batch, _blocks(jax_make_batch_reader, url, **kwargs))
    columnar = _blocks(make_reader, url, output='columnar', **kwargs)
    _assert_blocks_equal(columnar, _blocks(jax_make_reader, url, output='columnar', **kwargs))
    sizes = [len(b.id) for b in batch]
    if batch_size is None:
        assert sorted(sizes) == [5] + [10] * 7  # one block per row group, shuffled
    else:
        full = [batch_size] * (75 // batch_size)
        assert sizes == (full if drop_last or 75 % batch_size == 0 else full + [75 % batch_size])


def test_rebatching_arguments_are_checked(written_stores):
    url = written_stores['torch']
    with pytest.raises(ValueError, match='drop_last requires batch_size'):
        make_batch_reader(url, drop_last=True)
    with pytest.raises(ValueError, match="batch_size requires output='columnar'"):
        make_reader(url, batch_size=8)
    with pytest.raises(TypeError, match='unexpected keyword'):
        make_batch_reader(url, ngram=object())
    # the protocol monitor is ported: it attaches to the pool, and the
    # factory's signature is the JAX one
    with make_batch_reader(url, reader_pool_type='thread', workers_count=2,
                           protocol_monitor=True) as reader:
        monitor = reader._pool.protocol_monitor
        assert sum(len(b.id) for b in reader) == 75
    snap = monitor.snapshot
    assert snap['ventilated'] == snap['completed'] > 0 and snap['in_flight'] == []
    assert inspect.signature(make_batch_reader) == inspect.signature(jax_make_batch_reader)


def test_make_reader_refuses_a_plain_store(plain_store):
    with pytest.raises(PetastormTpuError, match='use make_batch_reader'):
        make_reader(plain_store)


@pytest.mark.parametrize('route', ['native', 'python', 'row_drop', 'native_row_drop'])
def test_predicate_and_row_drop_routes_equal_jax(plain_store, route):
    def kwargs(pred_module):
        out = dict(reader_pool_type='dummy', seed=21, schema_fields=['id', 'name', 'pixels'])
        if route in ('native', 'native_row_drop'):
            out['predicate'] = pred_module.in_set([1, 4, 5], 'label')
        elif route == 'python':
            out['predicate'] = pred_module.in_lambda(['id'], lambda v: v['id'] % 3 == 0)
        if route in ('row_drop', 'native_row_drop'):
            out['shuffle_row_drop_partitions'] = 3
        return out

    native.read_routes.reset()
    blocks = _blocks(make_batch_reader, plain_store, **kwargs(predicates))
    routes = native.read_routes.snapshot()
    _assert_blocks_equal(blocks, _blocks(jax_make_batch_reader, plain_store,
                                         **kwargs(jax_predicates)))
    if route == 'native':
        assert routes.get('fused_pred_batches_total', 0) == ROWS // ROWS_PER_ROW_GROUP
    else:
        assert not routes.get('fused_pred_batches_total')
    if route == 'row_drop':
        assert sorted(i for b in blocks for i in b.id) == list(range(ROWS))


class _DoubleScore(object):
    def __call__(self, block):
        block['score'] = block['score'] * 2
        return block


def test_batched_transform_runs_on_the_column_block(plain_store):
    kwargs = dict(reader_pool_type='dummy', seed=2, schema_fields=['id', 'score', 'blob'])
    blocks = _blocks(make_batch_reader, plain_store, **kwargs,
                     transform_spec=TransformSpec(_DoubleScore(), removed_fields=['blob']))
    _assert_blocks_equal(blocks, _blocks(
        jax_make_batch_reader, plain_store, **kwargs,
        transform_spec=JaxTransformSpec(_DoubleScore(), removed_fields=['blob'])))
    assert blocks[0]._fields == ('id', 'score')


# -- the plain_batch slice at small width --------------------------------------

@pytest.fixture(scope='module')
def png_plain_store(tmp_path_factory):
    """``chip_smoke.build_plain_store`` at small size: 96 photo-like 32 px
    images as PNG bytes in a binary column, int64 labels."""
    url = 'file://' + str(tmp_path_factory.mktemp('plain_png'))
    images = [chip_smoke._photo(np.random.default_rng([5, i]), SIZE, SIZE) for i in range(ROWS)]
    chip_smoke.build_plain_store(url, rows=ROWS, image=images.__getitem__)
    return url, images


class _JaxDecodePng(object):
    def __call__(self, block):
        block['image'] = np.stack(jax_image_codec.decode_images(list(block['image'])))
        return block


def _jax_losses(url, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=chip_smoke.NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    spec = JaxTransformSpec(_JaxDecodePng(),
                            edit_fields=[JaxField('image', np.uint8, (SIZE, SIZE, 3), None, False)])
    losses, batches = [], []
    with jax_make_batch_reader(url, reader_pool_type='dummy', seed=7, batch_size=BATCH,
                               transform_spec=spec) as reader:
        it = iter(jax_prefetch_to_device(
            JaxDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7), size=2))
        for _ in range(steps):
            batch = next(it)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
            batches.append(np.asarray(batch['image']))
        it.close()
    return losses, batches


def _torch_losses(url, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=chip_smoke.NUM_CLASSES,
                   num_filters=8, dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, mask: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses, batches = [], []
    native.read_routes.reset()
    with make_batch_reader(url, reader_pool_type='dummy', seed=7, batch_size=BATCH,
                           transform_spec=chip_smoke.plain_transform(SIZE)) as reader:
        assert reader.schema.name == 'inferred'
        it = iter(prefetch_to_device(
            TorchDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7), 'cpu', size=2))
        for _ in range(steps):
            batch = next(it)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(metrics['loss'].item())
            batches.append(batch['image'].numpy())
        it.close()
    return losses, batches, native.read_routes.snapshot()


def test_two_train_steps_match_jax_plain_batch_slice(png_plain_store):
    url, images = png_plain_store
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=chip_smoke.NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
                                          train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    expected, jax_batches = _jax_losses(url, variables, steps=2)
    actual, batches, routes = _torch_losses(url, variables, steps=2)
    for a, b in zip(batches, jax_batches):
        np.testing.assert_array_equal(a, b)
    written = {img.tobytes() for img in images}
    assert all(img.tobytes() in written for b in batches for img in b)
    # the image column is binary, not a fixed-width numeric one: Arrow reads
    # it; the label is served natively
    assert routes.get('arrow_fallback_columns_total', 0) > 0
    assert all(np.isfinite(actual)) and actual[0] != actual[1]
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)


# -- the block queue and the rebatching reader, case for case with
# -- tests/test_rebatch.py ------------------------------------------------------

def _queues():
    from petastorm_tpu.columnar import BatchingColumnQueue as JaxQueue
    from petastorm_tpu_torch.columnar import BatchingColumnQueue
    return {'jax': JaxQueue, 'torch': BatchingColumnQueue}


def _segment(start, n):
    return {'id': np.arange(start, start + n),
            'x': np.arange(start, start + n, dtype=np.float32) * 2.0}


def _ragged(values):
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


QUEUE_CASES = {
    # name: (batch_size, segments, operations); an operation is 'get',
    # 'drain' or ('take', n)
    'basic_rechunk': (4, [_segment(0, 10)], ['get', 'get', 'drain']),
    'spans_segments': (7, [_segment(0, 3), _segment(3, 3), _segment(6, 5)], ['get', 'drain']),
    'empty_put_and_drain': (4, [_segment(0, 0), _segment(0, 3)], ['drain', 'drain']),
    'exact_multiple': (5, [_segment(0, 10)], ['get', 'get', 'drain']),
    'object_columns': (3, [{'s': _ragged([b'a', b'bb', None, b'dddd'])},
                           {'s': _ragged([b'e', None, b'ff', b'g'])}], ['get', 'get', 'drain']),
    'mixed_uniform_and_ragged': (5, [{'v': np.arange(6, dtype=np.float32).reshape(3, 2)},
                                     {'v': _ragged([np.asarray([1.0]),
                                                    np.asarray([2.0, 3.0, 4.0]), None])}],
                                 ['get', 'drain']),
    'mismatched_inner_width': (4, [{'v': np.zeros((2, 3), dtype=np.float32)},
                                   {'v': np.ones((2, 5), dtype=np.float32)}], ['get', 'drain']),
    'tags_and_take': (4, [_segment(0, 3), _segment(3, 0), _segment(3, 6)],
                      [('take', 2), 'get', 'drain']),
}


def _run_queue(cls, batch_size, segments, operations):
    q = cls(batch_size)
    for tag, segment in enumerate(segments):
        q.put(segment, tag=tag)
    out = []
    for op in operations:
        if op == 'get':
            if q.empty():
                out.append(('empty', len(q)))
                continue
            got = q.get()
        elif op == 'drain':
            got = q.drain()
        else:
            got = q.take(op[1])
        out.append((None if got is None else {k: list(v) for k, v in got.items()},
                    len(q), q.pop_drained_tags(), q.snapshot_rows()))
    return out


@pytest.mark.parametrize('case', sorted(QUEUE_CASES))
def test_batching_column_queue_equals_jax(case):
    queues = _queues()
    batch_size, segments, operations = QUEUE_CASES[case]
    expected = _run_queue(queues['jax'], batch_size, segments, operations)
    actual = _run_queue(queues['torch'], batch_size, segments, operations)
    # pickled: equal dtypes, shapes and cells, None and nested arrays included
    assert pickle.dumps(actual) == pickle.dumps(expected)


def test_batching_column_queue_refuses_ragged_blocks():
    with pytest.raises(ValueError, match='ragged'):
        _queues()['torch'](2).put({'a': np.arange(3), 'b': np.arange(4)})
    with pytest.raises(ValueError, match='batch_size'):
        _queues()['torch'](0)


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
@pytest.mark.parametrize('batch_size,drop_last', [(32, False), (32, True), (30, False),
                                                  (64, False)])
def test_batch_reader_rebatch_across_reset(scalar_dataset, pool, batch_size, drop_last):
    # two passes through reset(): the same sizes each pass, no row of the
    # first pass's dropped tail leaking into the second, every row once a
    # pass without drop_last (tests/test_rebatch.py's reset cases)
    def passes(make):
        reader = make(scalar_dataset.url, batch_size=batch_size, drop_last=drop_last,
                      reader_pool_type=pool, workers_count=2, shuffle_row_groups=False)
        try:
            first = [b.id for b in reader]
            reader.reset()
            second = [b.id for b in reader]
        finally:
            reader.stop()
            reader.join()
        return first, second

    first, second = passes(make_batch_reader)
    all_ids = sorted(r['id'] for r in scalar_dataset.data)
    for ids in (first, second):
        sizes = [len(b) for b in ids]
        full = [batch_size] * (100 // batch_size)
        assert sizes == (full if drop_last or 100 % batch_size == 0
                         else full + [100 % batch_size])
        if not drop_last:
            assert sorted(np.concatenate(ids).tolist()) == all_ids
    if pool == 'dummy':
        j_first, j_second = passes(jax_make_batch_reader)
        assert [b.tolist() for b in first + second] == [b.tolist() for b in j_first + j_second]
        assert first[0][0] == second[0][0] == min(all_ids)
