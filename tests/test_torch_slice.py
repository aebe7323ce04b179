"""The port's first slice end to end on the CPU, against the JAX package:
a raw-tensor store -> make_reader(output='columnar') -> loader with a seeded
shuffle -> prefetch_to_device -> a ResNet train step with normalize inside
it, with the same weights in both packages. Also: the port imports nothing of
JAX, and its entry points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
NUM_CLASSES = 5
BATCH = 8
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """These models are tiny: two intra-op threads lose nothing, and keep
    this file from crowding out the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def raw_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('slice_store'))
    schema = Unischema('ImagenetRaw', [
        UnischemaField('image', np.uint8, (SIZE, SIZE, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    with materialize_dataset(url, schema, rows_per_row_group=16) as writer:
        for i in range(64):
            writer.write({'image': rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
                          'label': np.int64(i % NUM_CLASSES)})
    return url


def _jax_losses(url, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    # on the CPU the JAX op takes its plain path (the Pallas kernel runs in
    # interpret mode in test_torch_normalize.py)
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    losses = []
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7) as reader:
        batches = iter(jax_prefetch_to_device(
            JaxDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7), size=2))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
        batches.close()
    return losses


def _torch_losses(url, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses = []
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7) as reader:
        batches = iter(prefetch_to_device(
            TorchDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7), 'cpu', size=2))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(metrics['loss'].item())
        batches.close()
    return losses


def test_two_train_steps_match_jax_slice(raw_store):
    # the same store, shuffle seed, weights and normalize in both packages;
    # 1e-3 covers float32 sums taken in another order through a forward,
    # a backward and one SGD update
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1),
                                          jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    expected = _jax_losses(raw_store, variables, steps=2)
    actual = _torch_losses(raw_store, variables, steps=2)
    assert all(np.isfinite(actual))
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)
    assert actual[0] != actual[1]


def test_pipeline_duty_cycle_on_cpu(raw_store):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, g: normalize_images(x, MEAN, STD,
                                                                      out_dtype=torch.float32))
    losses = []

    def step_fn(images, labels):
        losses.append(step(state, images, labels)[1]['loss'].item())

    result = pipeline_duty_cycle(raw_store, step_fn, lambda b: (b['image'], b['label']),
                                 batch_size=BATCH, steps=3, warmup_steps=1, device='cpu',
                                 reader_kwargs={'seed': 7, 'workers_count': 2},
                                 loader_kwargs={'shuffling_queue_capacity': 32, 'seed': 7})
    assert result.samples == 3 * BATCH and state.step == 4 and len(losses) == 4
    assert 0.0 <= result.input_stall_fraction <= 1.0 and result.samples_per_second > 0
    assert all(np.isfinite(losses))


def test_port_imports_nothing_of_jax():
    # every module of the port, and chip_smoke.py, in a fresh interpreter
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import petastorm_tpu_torch',
        'for m in pkgutil.walk_packages(petastorm_tpu_torch.__path__, "petastorm_tpu_torch."):',
        '    importlib.import_module(m.name)',
        'import chip_smoke',
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in',
        '             ("jax", "jaxlib", "flax", "optax", "petastorm_tpu"))',
        'assert not bad, bad',
        # the decode slice's modules, the native decoder's bindings and build among them
        'for m in ("native.image_codec", "native.build", "codecs", "local_disk_cache", "cache"):',
        '    assert "petastorm_tpu_torch." + m in sys.modules, m',
        'print(len([m for m in sys.modules if m.startswith("petastorm_tpu_torch")]))',
    ])
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 37


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(prefetch_to_device(iter([]))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline_duty_cycle('file:///nonexistent', None, None)


def test_chip_smoke_fails_without_cuda(tmp_path):
    # on a host without a card the smoke run ends non-zero and reports no result
    out = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # nor does it run from a directory that holds only the script
    lone = tmp_path / 'chip_smoke.py'
    lone.write_text(open(os.path.join(REPO, 'chip_smoke.py')).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
