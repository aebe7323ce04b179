"""The port's second slice end to end on the CPU, against the JAX package:
an ImageNet-shaped PNG or JPEG store (written by either package) ->
``make_reader(transform_spec=TransformSpec(image_resize=...))`` with a
batched label transform, optionally through the local-disk cache ->
``TorchDataLoader`` -> a ResNet train step. Blocks, batches and cached
blocks are held to the JAX package's exactly; two train steps to 1e-3.
Stores with ``ndarray``, ``compressed_ndarray`` and ``scalar_list`` columns
read back the same in both packages."""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu_torch.codecs as codecs
from petastorm_tpu import TransformSpec as JaxTransformSpec
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.row_worker import _cache_key as jax_cache_key
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import TransformSpec, make_reader
from petastorm_tpu_torch.codecs import image_routes
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.row_worker import _cache_key
from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

SIZE = 32
NUM_CLASSES = 5
BATCH = 8
SYNSETS, PER_SYNSET, ROWS_PER_ROW_GROUP = 3, 16, 8
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class LabelFromNounId(object):
    """The batched label transform of the ImageNet example: crc32 of the
    synset id (module level, so it pickles)."""

    def __call__(self, block):
        labels = np.fromiter((zlib.crc32(str(n).encode()) % NUM_CLASSES for n in block['noun_id']),
                             dtype=np.int64, count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


def _transform(spec_cls, field_cls, resize=(SIZE, SIZE), hints=None):
    return spec_cls(LabelFromNounId(),
                    edit_fields=[field_cls('image', np.uint8, resize + (3,), None, False),
                                 field_cls('label', np.int64, (), None, False)],
                    removed_fields=['noun_id', 'text'], batched=True,
                    image_resize={'image': resize}, image_decode_hints=hints)


def _photo(rng, h, w):
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _write_image_store(url, package, fmt):
    """ImagenetSchema-shaped rows: noun_id, text and a variable-size image."""
    materialize, field_cls, schema_cls, codec_mod = {
        'jax': (jax_materialize_dataset, JaxField, JaxUnischema, jax_codecs),
        'torch': (materialize_dataset, UnischemaField, Unischema, codecs)}[package]
    schema = schema_cls('ImagenetSchema', [
        field_cls('noun_id', np.str_, (), codec_mod.ScalarCodec(), False),
        field_cls('text', np.str_, (), codec_mod.ScalarCodec(), False),
        field_cls('image', np.uint8, (None, None, 3), codec_mod.CompressedImageCodec(fmt), False)])
    rng = np.random.default_rng(0)
    dims = (20, 64) if fmt == 'png' else (70, 130)
    with materialize(url, schema, rows_per_row_group=ROWS_PER_ROW_GROUP) as writer:
        for s in range(SYNSETS):
            for _ in range(PER_SYNSET):
                writer.write({'noun_id': 'n{:08d}'.format(s), 'text': 'synset {}'.format(s),
                              'image': _photo(rng, int(rng.integers(*dims)),
                                              int(rng.integers(*dims)))})


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    urls = {}
    for package in ('jax', 'torch'):
        for fmt in ('png', 'jpeg'):
            url = 'file://' + str(tmp_path_factory.mktemp('{}_{}'.format(package, fmt)))
            _write_image_store(url, package, fmt)
            urls[package, fmt] = url
    return urls


@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
def test_image_columns_are_written_uncompressed_like_jax(stores, fmt):
    import pyarrow.parquet as pq

    def compression(url):
        path = os.path.join(url[len('file://'):], 'part-00000.parquet')
        group = pq.ParquetFile(path).metadata.row_group(0)
        return {group.column(i).path_in_schema: group.column(i).compression
                for i in range(group.num_columns)}

    ours = compression(stores['torch', fmt])
    assert ours == compression(stores['jax', fmt])
    assert ours['image'] == 'UNCOMPRESSED' and ours['noun_id'] == 'SNAPPY'


def _blocks(factory, url, **kwargs):
    with factory(url, output='columnar', reader_pool_type='dummy', seed=7, **kwargs) as reader:
        return [{k: v for k, v in block._asdict().items()} for block in reader]


def _assert_blocks_equal(actual, expected):
    assert len(actual) == len(expected) > 0
    for a, e in zip(actual, expected):
        assert set(a) == set(e)
        for name in e:
            if e[name].dtype == object:  # variable-size images or strings
                assert a[name].dtype == object and len(a[name]) == len(e[name])
                for x, y in zip(a[name], e[name]):
                    np.testing.assert_array_equal(x, y)
            else:
                assert a[name].dtype == e[name].dtype and a[name].shape == e[name].shape, name
                np.testing.assert_array_equal(a[name], e[name], err_msg=name)


def _hide_cv2(monkeypatch):
    def no_cv2():
        raise ImportError('cv2 hidden by the test')
    monkeypatch.setattr(codecs, '_import_cv2', no_cv2)
    monkeypatch.setattr(jax_codecs, '_import_cv2', no_cv2)


@pytest.mark.parametrize('route', ['cv2', 'native'])
@pytest.mark.parametrize('store', [('jax', 'png'), ('torch', 'png'), ('jax', 'jpeg'),
                                   ('torch', 'jpeg')], ids='-'.join)
def test_image_resize_blocks_match_jax(stores, store, route, monkeypatch):
    if route == 'native':  # decode+resize fused in one native call per column
        _hide_cv2(monkeypatch)
    url = stores[store]
    image_routes.reset()
    actual = _blocks(make_reader, url, transform_spec=_transform(TransformSpec, UnischemaField))
    expected = _blocks(jax_make_reader, url,
                       transform_spec=_transform(JaxTransformSpec, JaxField))
    _assert_blocks_equal(actual, expected)
    assert actual[0]['image'].shape == (ROWS_PER_ROW_GROUP, SIZE, SIZE, 3)
    counts = image_routes.snapshot()
    assert counts['decode_native'] == SYNSETS * PER_SYNSET
    assert counts['resize_' + route] == SYNSETS * PER_SYNSET
    assert counts['decode_cv2'] == counts['decode_fallback'] == 0


@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
def test_variable_size_blocks_and_rows_match_jax(stores, fmt):
    # no resize: variable-size images travel as object columns
    url = stores['torch', fmt]
    actual = _blocks(make_reader, url)
    _assert_blocks_equal(actual, _blocks(jax_make_reader, url))
    assert actual[0]['image'].dtype == object
    spec = lambda cls, f: _transform(cls, f, resize=(24, 40))  # noqa: E731
    with make_reader(url, reader_pool_type='dummy', seed=7,
                     transform_spec=spec(TransformSpec, UnischemaField)) as reader:
        rows = list(reader)
    with jax_make_reader(url, reader_pool_type='dummy', seed=7,
                         transform_spec=spec(JaxTransformSpec, JaxField)) as reader:
        expected = list(reader)
    assert len(rows) == len(expected) == SYNSETS * PER_SYNSET
    for a, e in zip(rows, expected):
        assert a.image.shape == (24, 40, 3) and a.label == e.label
        np.testing.assert_array_equal(a.image, e.image)


def test_jpeg_decode_hints_match_jax(stores):
    url = stores['jax', 'jpeg']
    kwargs = dict(image_decode_hints={'image': (20, 20)})
    actual = _blocks(make_reader, url, transform_spec=TransformSpec(**kwargs))
    _assert_blocks_equal(actual, _blocks(jax_make_reader, url,
                                         transform_spec=JaxTransformSpec(**kwargs)))
    # the scaled DCT decode came out smaller than the stored photos
    assert max(img.shape[0] for b in actual for img in b['image']) < 70


@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
def test_loader_batches_match_jax_loader(stores, fmt):
    url = stores['jax', fmt]
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     transform_spec=_transform(TransformSpec, UnischemaField)) as reader:
        actual = [{k: np.asarray(v) for k, v in b.items()}
                  for b in TorchDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7)]
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                         transform_spec=_transform(JaxTransformSpec, JaxField)) as reader:
        expected = [{k: np.asarray(v) for k, v in b.items()}
                    for b in JaxDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7)]
    assert len(actual) == SYNSETS * PER_SYNSET // BATCH
    _assert_blocks_equal(actual, expected)


def test_second_pass_from_the_cache_equals_the_first(stores, tmp_path):
    url = stores['torch', 'png']
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'cache'),
                 cache_size_limit=1 << 30, cache_row_size_estimate=4096)
    spec = _transform(TransformSpec, UnischemaField)
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7, **cache) as reader:
        first = [b._asdict() for b in reader]
        assert reader.cache.stats() == {'hits': 0, 'misses': 6}
    image_routes.reset()
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     transform_spec=spec, **cache) as reader:
        resized = [b._asdict() for b in reader]
        assert reader.cache.stats() == {'hits': 0, 'misses': 6}  # the key holds the resize
    with make_reader(url, output='columnar', reader_pool_type='thread', workers_count=3, seed=7,
                     transform_spec=spec, **cache) as reader:
        cached = [b._asdict() for b in reader]
        assert reader.cache.stats() == {'hits': 6, 'misses': 0}
    assert image_routes.snapshot()['decode_native'] == SYNSETS * PER_SYNSET  # one decode pass
    key = lambda b: b['label'].tobytes() + b['image'].tobytes()  # noqa: E731
    assert sorted(map(key, cached)) == sorted(map(key, resized))
    _assert_blocks_equal(resized, _blocks(jax_make_reader, url, transform_spec=_transform(
        JaxTransformSpec, JaxField)))
    assert all(b['image'].dtype == object for b in first)


def test_cache_key_distinguishes_resize_and_hints():
    class Piece:
        path = 'p.parquet'
        row_group = 0
    args = [('/d', Piece, ['image']),
            ('/d', Piece, ['image'], {'image': (32, 32)}),
            ('/d', Piece, ['image'], {'image': (32, 32)}, {'image': (32, 32)}),
            ('/d', Piece, ['image'], {'image': (64, 64)}, {'image': (32, 32)}),
            ('/d', Piece, ['image'], {'image': (32, 32)}, {'image': (16, 16)})]
    keys = [_cache_key(*a) for a in args]
    assert len(set(keys)) == len(keys)
    assert keys == [jax_cache_key(*a) for a in args]


def test_local_disk_cache_evicts_least_recently_used(tmp_path):
    cache = LocalDiskCache(str(tmp_path), size_limit_bytes=3000)
    blob = b'x' * 900
    for i in range(3):
        assert cache.get('k{}'.format(i), lambda: blob) == blob
        os.utime(cache._entry_path('k{}'.format(i)), (i, i))  # k0 is the oldest
    assert cache.get('k3', lambda: blob) == blob  # over the limit: k0 goes
    assert not os.path.exists(cache._entry_path('k0'))
    assert cache.get('k1', lambda: pytest.fail('k1 should be cached')) == blob
    assert cache.stats() == {'hits': 1, 'misses': 4}
    assert cache.get('huge', lambda: b'y' * 5000) == b'y' * 5000  # served, never stored
    assert not os.path.exists(cache._entry_path('huge'))
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs if f.endswith('.tmp')]


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_tensor_codec_stores_read_the_same(writer, tmp_path):
    """``ndarray`` (the default for a non-scalar field), ``compressed_ndarray``
    and ``scalar_list`` columns, written by either package."""
    url = 'file://' + str(tmp_path)
    materialize, field_cls, schema_cls, codec_mod = {
        'jax': (jax_materialize_dataset, JaxField, JaxUnischema, jax_codecs),
        'torch': (materialize_dataset, UnischemaField, Unischema, codecs)}[writer]
    schema = schema_cls('Tensors', [
        field_cls('id', np.int64, (), None, False),
        field_cls('matrix', np.float32, (3, 4), None, False),
        field_cls('ragged', np.int16, (None,), codec_mod.NdarrayCodec(), False),
        field_cls('packed', np.float64, (2, None), codec_mod.CompressedNdarrayCodec(), False),
        field_cls('ids', np.int32, (None,), codec_mod.ScalarListCodec(), False)])
    rng = np.random.default_rng(12)
    with materialize(url, schema, rows_per_row_group=4) as w:
        for i in range(12):
            w.write({'id': np.int64(i), 'matrix': rng.standard_normal((3, 4)).astype(np.float32),
                     'ragged': rng.integers(0, 99, i % 3 + 1).astype(np.int16),
                     'packed': rng.standard_normal((2, i % 2 + 1)),
                     'ids': rng.integers(0, 9, 3 if i < 8 else i % 4).astype(np.int32)})
    actual = _blocks(make_reader, url)
    _assert_blocks_equal(actual, _blocks(jax_make_reader, url))
    assert actual[0]['matrix'].shape == (4, 3, 4)


def _jax_losses(url, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    losses = []
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                         transform_spec=_transform(JaxTransformSpec, JaxField)) as reader:
        batches = iter(JaxDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
    return losses


def _torch_losses(url, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses = []
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     transform_spec=_transform(TransformSpec, UnischemaField)) as reader:
        batches = iter(TorchDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, torch.from_numpy(batch['image']),
                                  torch.from_numpy(batch['label']))
            losses.append(metrics['loss'].item())
    return losses


def test_two_train_steps_match_jax_decode_slice(stores):
    # the same PNG store, resize, label transform, shuffle seed and weights in
    # both packages; 1e-3 covers float32 sums in another order through a
    # forward, a backward and one SGD update
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1),
                                          jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    url = stores['jax', 'png']
    expected = _jax_losses(url, variables, steps=2)
    actual = _torch_losses(url, variables, steps=2)
    assert all(np.isfinite(actual)) and actual[0] != actual[1]
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)


def test_cached_duty_cycle_reads_nothing_past_the_cache(stores, tmp_path):
    """The ``png_cached`` path of the smoke run at a small size: one epoch
    fills the cache, then the measured run decodes nothing."""
    url = stores['torch', 'png']
    kwargs = dict(transform_spec=_transform(TransformSpec, UnischemaField), seed=7,
                  workers_count=2, cache_type='local-disk', cache_location=str(tmp_path))
    with make_reader(url, num_epochs=1, **kwargs) as reader:
        assert sum(len(row.label.shape) == 0 for row in reader) == SYNSETS * PER_SYNSET
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=4)
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, g: normalize_images(x, MEAN, STD,
                                                                      out_dtype=torch.float32))
    image_routes.reset()
    result = pipeline_duty_cycle(url, lambda x, y: step(state, x, y), lambda b: (b['image'],
                                                                                 b['label']),
                                 batch_size=BATCH, steps=4, warmup_steps=1, device='cpu',
                                 reader_kwargs=kwargs,
                                 loader_kwargs={'shuffling_queue_capacity': 16, 'seed': 7})
    assert result.extra['cache']['misses'] == 0 and result.extra['cache']['hits'] > 0
    assert not any(image_routes.snapshot().values())
