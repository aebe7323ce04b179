"""The two filtered slices of ``chip_smoke.py`` at small size, on the CPU:
two train steps of ``png_fixed_pred`` (a predicate on the fixed-shape PNG
store's label) and of ``png_select`` (a row-group selector with
shuffle-row-drop partitions and the image transform on the ImageNet-shaped
PNG store) against the JAX slices at 1e-3, and each path's read routes and
label checks on small twins of its store."""

import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu.predicates as jax_predicates
import petastorm_tpu.selectors as jax_selectors
from petastorm_tpu import TransformSpec as JaxTransformSpec
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
import petastorm_tpu_torch.predicates as predicates
import petastorm_tpu_torch.selectors as selectors
from petastorm_tpu_torch import TransformSpec, make_reader, native
from petastorm_tpu_torch.codecs import image_routes
from petastorm_tpu_torch.etl import SingleFieldIndexer, build_rowgroup_index
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import UnischemaField

import cv2  # noqa: F401,E402  (the JAX writer encodes PNG cells through it)


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


SIZE = 32
NUM_CLASSES = 10
BATCH = 8
SYNSETS = 6
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
KEEP = [1, 3, 4, 8]
SELECTED = ['n{:08d}'.format(s) for s in (0, 2, 3)]


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _photo(rng, h, w):
    return chip_smoke._photo(rng, h, w)


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """A fixed-shape PNG store (labels ``i % 10``, 8 rows per row group) and
    an ImageNet-shaped PNG store (6 synsets of 16 images, 8 rows per row
    group) indexed by synset, both written by the JAX package."""
    rng = np.random.default_rng(3)
    fixed = 'file://' + str(tmp_path_factory.mktemp('png_fixed'))
    schema = JaxUnischema('PngFixed', [
        JaxField('image', np.uint8, (SIZE, SIZE, 3), jax_codecs.CompressedImageCodec('png'),
                 False),
        JaxField('label', np.int64, (), jax_codecs.ScalarCodec(np.int64), False)])
    with jax_materialize_dataset(fixed, schema, rows_per_row_group=8) as w:
        for i in range(96):
            w.write({'image': _photo(rng, SIZE, SIZE), 'label': np.int64(i % NUM_CLASSES)})
    png = 'file://' + str(tmp_path_factory.mktemp('png'))
    schema = JaxUnischema('ImagenetSchema', [
        JaxField('noun_id', np.str_, (), jax_codecs.ScalarCodec(), False),
        JaxField('text', np.str_, (), jax_codecs.ScalarCodec(), False),
        JaxField('image', np.uint8, (None, None, 3), jax_codecs.CompressedImageCodec('png'),
                 False)])
    with jax_materialize_dataset(png, schema, rows_per_row_group=8) as w:
        for i in range(SYNSETS * 16):
            w.write({'noun_id': 'n{:08d}'.format(i // 16), 'text': 'synset {}'.format(i // 16),
                     'image': _photo(rng, int(rng.integers(20, 48)), int(rng.integers(20, 48)))})
    jax_indexing.build_rowgroup_index(png, [jax_indexers.SingleFieldIndexer('noun_id_idx',
                                                                            'noun_id')])
    return {'png_fixed': fixed, 'png': png}


class LabelFromNounId(object):
    def __call__(self, block):
        labels = np.fromiter((zlib.crc32(str(n).encode()) % NUM_CLASSES for n in block['noun_id']),
                             dtype=np.int64, count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


def _transform(spec_cls, field_cls):
    return spec_cls(LabelFromNounId(),
                    edit_fields=[field_cls('image', np.uint8, (SIZE, SIZE, 3), None, False),
                                 field_cls('label', np.int64, (), None, False)],
                    removed_fields=['noun_id', 'text'], batched=True,
                    image_resize={'image': (SIZE, SIZE)})


def _reader_kwargs(path, package):
    """The path's filtering arguments, built from either package."""
    if package == 'jax':
        pred, sel, spec = jax_predicates, jax_selectors, _transform(JaxTransformSpec, JaxField)
    else:
        pred, sel, spec = predicates, selectors, _transform(TransformSpec, UnischemaField)
    if path == 'png_fixed_pred':
        return {'predicate': pred.in_set(KEEP, 'label')}
    return {'transform_spec': spec, 'shuffle_row_drop_partitions': 2,
            'rowgroup_selector': sel.SingleIndexSelector('noun_id_idx', SELECTED)}


def _jax_losses(url, path, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    losses, labels = [], []
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                         **_reader_kwargs(path, 'jax')) as reader:
        batches = iter(JaxDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
            labels.append(np.asarray(batch['label']))
    return losses, labels


def _torch_losses(url, path, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses, labels = [], []
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     **_reader_kwargs(path, 'torch')) as reader:
        batches = iter(TorchDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, torch.from_numpy(batch['image']),
                                  torch.from_numpy(batch['label']))
            losses.append(metrics['loss'].item())
            labels.append(batch['label'])
    return losses, labels


@pytest.mark.parametrize('path', ['png_fixed_pred', 'png_select'])
def test_two_train_steps_match_jax_filtered_slice(stores, path):
    # the same store, filter, shuffle seed and weights in both packages; 1e-3
    # covers float32 sums in another order through a forward, a backward and
    # one SGD update
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
                                          train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    url = stores['png_fixed' if path == 'png_fixed_pred' else 'png']
    expected, jax_labels = _jax_losses(url, path, variables, steps=2)
    native.read_routes.reset()
    actual, labels = _torch_losses(url, path, variables, steps=2)
    for a, b in zip(labels, jax_labels):
        np.testing.assert_array_equal(a, b)
    routes = native.read_routes.snapshot()
    if path == 'png_fixed_pred':
        assert set(np.concatenate(labels)) <= set(KEEP)
        assert routes['fused_pred_batches_total'] > 0
    else:
        assert set(np.concatenate(labels)) <= {zlib.crc32(s.encode()) % NUM_CLASSES
                                               for s in SELECTED}
        assert routes['arrow_fallback_columns_total'] > 0 and not routes['fused_batches_total']
    assert all(np.isfinite(actual)) and actual[0] != actual[1]
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)


@pytest.fixture(scope='module')
def smoke_twins(tmp_path_factory):
    """Small twins of the smoke's stores, written by the port, for the
    paths' route and label checks."""
    fixed = 'file://' + str(tmp_path_factory.mktemp('twin_fixed'))
    png_codec = chip_smoke._image_codec('png', 'cv2')
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema
    schema = Unischema('PngFixed', [
        UnischemaField('image', np.uint8, (SIZE, SIZE, 3), png_codec, False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(5)
    with materialize_dataset(fixed, schema, rows_per_row_group=16) as w:
        # labels i % 1000 as in the smoke's store: row groups 0-6 hold the
        # kept labels, the others none
        for i in range(256):
            w.write({'image': _photo(rng, SIZE, SIZE), 'label': np.int64(i % 1000)})
    png = 'file://' + str(tmp_path_factory.mktemp('twin_png'))
    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(), False),
        UnischemaField('text', np.str_, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3), png_codec, False)])
    with materialize_dataset(png, schema, rows_per_row_group=8) as w:
        for i in range(64):
            w.write({'noun_id': 'n{:08d}'.format(i // 16), 'text': 't',
                     'image': _photo(rng, int(rng.integers(20, 48)), int(rng.integers(20, 48)))})
    build_rowgroup_index(png, [SingleFieldIndexer('noun_id_idx', 'noun_id')])
    return {'png_fixed_pred': fixed, 'png_select': png}


@pytest.mark.parametrize('path', ['png_fixed_pred', 'png_select'])
def test_smoke_filtered_paths_read_through_their_routes(smoke_twins, path):
    url = smoke_twins[path]
    kwargs = {'seed': 7, 'workers_count': 2}
    if path == 'png_fixed_pred':
        kwargs['predicate'] = chip_smoke.filter_predicates()['in_set']
        check = chip_smoke.check_labels('below 100', lambda v: v < chip_smoke.PRED_CLASSES)
    else:
        synsets = ['n00000000', 'n00000002']
        kwargs.update(transform_spec=chip_smoke.image_transform(),
                      shuffle_row_drop_partitions=chip_smoke.ROW_DROP_PARTITIONS,
                      rowgroup_selector=selectors.SingleIndexSelector('noun_id_idx', synsets))
        labels = sorted({chip_smoke.label_of(s) for s in synsets})
        check = chip_smoke.check_labels('selected', lambda v: np.isin(v, labels))
    seen = []
    image_routes.reset()
    result = pipeline_duty_cycle(url, lambda images, labels: seen.append(labels),
                                 lambda b: (b['image'], b['label']), batch_size=BATCH, steps=6,
                                 warmup_steps=1, device='cpu', reader_kwargs=kwargs,
                                 loader_kwargs={'shuffling_queue_capacity': 16, 'seed': 7})
    check(torch.cat(seen).numpy())
    chip_smoke.check_read_routes(path, result.extra['read_routes'])
    if path == 'png_select':
        counts = image_routes.snapshot()
        assert counts['decode_native'] > 0 and counts['resize_cv2'] == counts['decode_native']
    # the checks refuse another path's routes and a label outside the filter
    other = 'png_select' if path == 'png_fixed_pred' else 'png_fixed_pred'
    with pytest.raises(AssertionError, match='unexpected routes'):
        chip_smoke.check_read_routes(other, result.extra['read_routes'])
    with pytest.raises(AssertionError, match='not'):
        check(np.array([999, 998]))
