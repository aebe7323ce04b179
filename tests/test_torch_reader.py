"""Port parity: the host read path of petastorm_tpu_torch (materialize_dataset,
make_reader, TorchDataLoader) against the JAX package's, on raw-tensor stores
made with numpy from a seed. Both packages read each other's stores, and for
one seed they give the same row groups in the same order and the same
shuffled batches."""

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


def test_unported_arguments_and_codecs_raise(jax_store, tmp_path):
    with pytest.raises(NotImplementedError, match='predicates/selectors/ngram'):
        make_reader(jax_store, predicate=lambda row: True)
    with pytest.raises(NotImplementedError, match='process pool'):
        make_reader(jax_store, reader_pool_type='process')
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
