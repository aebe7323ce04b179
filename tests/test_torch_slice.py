"""The port's first slice end to end on the CPU, against the JAX package:
a raw-tensor store -> make_reader(output='columnar') -> loader with a seeded
shuffle -> prefetch_to_device -> a ResNet train step with normalize inside
it, with the same weights in both packages. Also: the port imports nothing of
JAX, and its entry points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys
import threading
import time

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
from petastorm_tpu_torch.entry import dryrun_multichip, entry
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.parallel import make_mesh
from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


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


def test_pipeline_duty_cycle_leaves_no_prefetch_thread(raw_store):
    # the prefetcher is closed before the reader stops: its pump thread ends
    # with the run, on success and when a step raises
    import threading

    def prefetch_threads():
        return {t for t in threading.enumerate() if t.name == 'pstpu-torch-prefetch'}

    before = prefetch_threads()
    pipeline_duty_cycle(raw_store, lambda images, labels: None, lambda b: (b['image'], b['label']),
                        batch_size=BATCH, steps=2, warmup_steps=1, device='cpu',
                        reader_kwargs={'seed': 7, 'workers_count': 2})

    def failing_step(images, labels):
        raise KeyError('step failed')

    with pytest.raises(KeyError, match='step failed'):
        pipeline_duty_cycle(raw_store, failing_step, lambda b: (b['image'], b['label']),
                            batch_size=BATCH, steps=2, warmup_steps=1, device='cpu',
                            reader_kwargs={'seed': 7, 'workers_count': 2})
    assert not {t for t in prefetch_threads() - before if t.is_alive()}


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
        # the decode slice's modules, the native decoder's bindings and build
        # among them, and the native read path's
        'for m in ("native.image_codec", "native.build", "codecs", "local_disk_cache", "cache",',
        '          "native", "native.fused", "native.pagescan", "row_worker",',
        # the row filtering slice's
        '          "predicates", "selectors", "etl.indexer_base", "etl.rowgroup_indexers",',
        '          "etl.rowgroup_indexing",',
        # the batch reader and checkpoint slice's
        '          "batch_worker", "rebatch", "torch.loader", "workers.ventilator",',
        # the telemetry, flight recorder, autotuner and sequence slice's
        '          "observability", "observability.metrics", "observability.trace",',
        '          "observability.report", "observability.critical_path",',
        '          "observability.exporters", "observability.history", "observability.blackbox",',
        '          "autotune", "autotune.controller", "sequence", "sequence.collate",',
        '          "sequence.bucket", "sequence.packing",',
        # the mesh slice's
        '          "parallel", "parallel.mesh", "parallel.collectives", "parallel.launch",',
        '          "entry", "test_util.dist_workers",',
        # the long-context slice's
        '          "ngram", "models.transformer", "ops.ring_attention",',
        '          "ops.ulysses_attention", "models.convert",',
        # the shared reader service's
        '          "serve", "serve.worker", "serve.plan", "serve.service", "serve.client",',
        '          "serve.__main__", "native.shm_ring", "workers.protocol",',
        # the elastic slice's
        '          "retry", "faults", "elastic", "elastic.shardmap", "elastic.membership",',
        '          "elastic.coordinator", "elastic._hostproc",',
        # the expert- and pipeline-parallel slice's
        '          "models.moe", "parallel.pipeline"):',
        '    assert "petastorm_tpu_torch." + m in sys.modules, m',
        # importing builds nothing: the libraries are built at first use
        'from petastorm_tpu_torch import native',
        'assert native._lib is None and not native._load_failed',
        'assert native.image_codec._lib is None',

        'print(len([m for m in sys.modules if m.startswith("petastorm_tpu_torch")]))',
    ])
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 86


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(prefetch_to_device(iter([]))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline_duty_cycle('file:///nonexistent', None, None)
    # the mesh slice's entry points
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(1)


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
