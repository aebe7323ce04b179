"""Port parity: the torch twins of ``examples/`` (``petastorm_tpu_torch.examples``)
against the JAX examples, on the CPU at a small size.

Each generator writes the rows the JAX one writes; each example twin runs
with ``device='cpu'`` and ``graphed=False``; the MNIST twin's losses match a
JAX run of the same steps on the same batches from the same weights
(within 1e-5), the reference-API twin trains the JAX package's torch
example's model exactly, the resume twin's resumed stream equals the
uninterrupted one row for row, the hello worlds read what the JAX adapters
read, and every twin refuses to fall back to the CPU when CUDA is absent.
Every reader is closed through ``with``."""

import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from examples.hello_world.external_dataset.generate_external_dataset import \
    generate_external_dataset as jax_generate_external_dataset
from examples.hello_world.petastorm_dataset.generate_petastorm_dataset import \
    generate_petastorm_dataset as jax_generate_petastorm_dataset
from examples.imagenet.generate_petastorm_imagenet import \
    generate_synthetic_imagenet as jax_generate_synthetic_imagenet
from examples.mnist.generate_petastorm_mnist import \
    mnist_data_to_petastorm_dataset as jax_mnist_data_to_petastorm_dataset
from examples.mnist.jax_example import TRANSFORM as JAX_MNIST_TRANSFORM
from examples.sequence.generate_petastorm_sequence import \
    generate_sequence_dataset as jax_generate_sequence_dataset
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.models import MnistCNN as JaxMnistCNN
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_eval_step as jax_make_eval_step
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.torch_utils import DataLoader as JaxTorchDataLoader
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.examples.hello_world.external_dataset import \
    generate_external_dataset as ext_generate
from petastorm_tpu_torch.examples.hello_world.external_dataset import \
    python_hello_world as ext_python
from petastorm_tpu_torch.examples.hello_world.external_dataset import \
    pytorch_hello_world as ext_pytorch
from petastorm_tpu_torch.examples.hello_world.external_dataset import \
    torch_hello_world as ext_torch
from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import \
    generate_petastorm_dataset as hw_generate
from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import \
    python_hello_world as hw_python
from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import \
    pytorch_hello_world as hw_pytorch
from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import \
    torch_hello_world as hw_torch
from petastorm_tpu_torch.examples.imagenet import torch_resnet_example
from petastorm_tpu_torch.examples.imagenet.generate_petastorm_imagenet import \
    generate_synthetic_imagenet
from petastorm_tpu_torch.examples.mnist import pytorch_example, resume_example, torch_example
from petastorm_tpu_torch.examples.mnist.generate_petastorm_mnist import \
    mnist_data_to_petastorm_dataset
from petastorm_tpu_torch.examples.sequence import torch_sequence_example
from petastorm_tpu_torch.examples.sequence.generate_petastorm_sequence import \
    generate_sequence_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
#: every module of the twins, each runnable with ``python -m``
EXAMPLE_MODULES = [
    'petastorm_tpu_torch.examples.' + name for name in (
        'mnist.generate_petastorm_mnist', 'mnist.torch_example', 'mnist.pytorch_example',
        'mnist.resume_example', 'imagenet.generate_petastorm_imagenet',
        'imagenet.torch_resnet_example', 'sequence.generate_petastorm_sequence',
        'sequence.torch_sequence_example',
        'hello_world.petastorm_dataset.generate_petastorm_dataset',
        'hello_world.petastorm_dataset.python_hello_world',
        'hello_world.petastorm_dataset.torch_hello_world',
        'hello_world.petastorm_dataset.pytorch_hello_world',
        'hello_world.external_dataset.generate_external_dataset',
        'hello_world.external_dataset.python_hello_world',
        'hello_world.external_dataset.torch_hello_world',
        'hello_world.external_dataset.pytorch_hello_world')]


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


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def mnist_url(tmp_path_factory):
    """The twin's MNIST store: 96 train rows in one row group (one read
    order whatever the pool), 32 test rows."""
    url = 'file://' + str(tmp_path_factory.mktemp('mnist'))
    mnist_data_to_petastorm_dataset(url, train_rows=96, test_rows=32, rows_per_row_group=96)
    return url


def _rows(url, factory=make_reader, **kwargs):
    with factory(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs) as reader:
        return [row._asdict() for row in reader]


def _assert_rows_equal(got, expected):
    assert len(got) == len(expected) > 0
    for g, e in zip(got, expected):
        assert list(g) == list(e)
        for name in e:
            np.testing.assert_array_equal(np.asarray(g[name]), np.asarray(e[name]), err_msg=name)


@pytest.mark.parametrize('which', ['mnist', 'imagenet', 'sequence', 'hello_world'])
def test_generators_write_the_jax_generators_rows(tmp_path, which):
    port_url, jax_url = ('file://' + str(tmp_path / name) for name in ('port', 'jax'))
    groups = ['']
    if which == 'mnist':
        mnist_data_to_petastorm_dataset(port_url, train_rows=40, test_rows=12,
                                        rows_per_row_group=16)
        jax_mnist_data_to_petastorm_dataset(jax_url, train_rows=40, test_rows=12,
                                            rows_per_row_group=16)
        groups = ['/train', '/test']
    elif which == 'imagenet':
        generate_synthetic_imagenet(port_url, num_synsets=2, images_per_synset=3)
        jax_generate_synthetic_imagenet(jax_url, num_synsets=2, images_per_synset=3)
    elif which == 'sequence':
        generate_sequence_dataset(port_url, rows=300, rows_per_row_group=64)
        jax_generate_sequence_dataset(jax_url, rows=300, rows_per_row_group=64)
    else:
        hw_generate.generate_petastorm_dataset(port_url, rows_count=5)
        jax_generate_petastorm_dataset(jax_url, rows_count=5)
    for group in groups:
        # each store read by both packages' readers: the same rows
        expected = _rows(jax_url + group, jax_make_reader)
        _assert_rows_equal(_rows(port_url + group), expected)
        _assert_rows_equal(_rows(port_url + group, jax_make_reader), expected)


def test_external_generator_writes_the_jax_table(tmp_path):
    ext_generate.generate_external_dataset('file://' + str(tmp_path / 'port'), rows_count=50)
    jax_generate_external_dataset('file://' + str(tmp_path / 'jax'), rows_count=50)
    assert pq.read_table(str(tmp_path / 'port')).equals(pq.read_table(str(tmp_path / 'jax')))


def _torch_to_flax(state_dict):
    """``MnistCNN`` torch ``state_dict`` -> flax ``params`` (the inverse of
    ``flax_to_torch``: OIHW -> HWIO, dense weights transposed)."""
    params = {}
    for key, value in state_dict.items():
        module, name = key.split('.')
        value = value.detach().numpy()
        if name == 'weight':
            name, value = 'kernel', value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
        params.setdefault(module, {})[name] = jnp.asarray(value)
    return params


def test_mnist_twin_matches_a_jax_run_of_the_same_steps(mnist_url):
    state, losses, accuracy = torch_example.train_and_test(mnist_url, batch_size=16,
                                                           device='cpu', graphed=False)
    assert len(losses) == 96 // 16 and state.step == len(losses)
    # the JAX run: the twin's initial weights, the JAX example's reader,
    # transform and loader arguments on the same store
    params = _torch_to_flax(torch_example.new_mnist_state(0, 0.05, 'cpu').module.state_dict())
    jax_state = jax_create_train_state(JaxMnistCNN(), jax.random.PRNGKey(0),
                                       jnp.zeros((1, 28, 28)), learning_rate=0.05)
    jax_state = jax_state.replace(params=params)
    step = jax_make_train_step(donate=False)
    jax_losses = []
    with jax_make_reader(mnist_url + '/train', num_epochs=1, seed=0,
                         transform_spec=JAX_MNIST_TRANSFORM) as reader:
        for batch in JaxDataLoader(reader, 16, shuffling_queue_capacity=256, seed=0):
            jax_state, metrics = step(jax_state, batch['image'], batch['digit'])
            jax_losses.append(float(metrics['loss']))
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    correct = total = 0
    with jax_make_reader(mnist_url + '/test', num_epochs=1,
                         transform_spec=JAX_MNIST_TRANSFORM) as reader:
        for batch in JaxDataLoader(reader, 16, drop_last=False):
            n = int(batch['digit'].shape[0])
            correct += round(float(jax_make_eval_step()(jax_state, batch['image'],
                                                        batch['digit'])['accuracy']) * n)
            total += n
    assert accuracy == pytest.approx(correct / total, abs=1 / total)


def test_reference_api_twin_trains_the_jax_packages_torch_example(mnist_url):
    from examples.mnist.pytorch_example import train_and_test as jax_pytorch_example

    model, losses, accuracy = pytorch_example.train_and_test(mnist_url, batch_size=16,
                                                             device='cpu')
    assert len(losses) == 6 and all(np.isfinite(losses)) and 0 <= accuracy <= 1
    # the same network, seed, batches and SGD through the JAX package's
    # adapter: the same weights, exactly
    expected = jax_pytorch_example(mnist_url, batch_size=16)
    for (name, value), (_, ref) in zip(model.state_dict().items(),
                                       expected.state_dict().items()):
        assert torch.equal(value, ref), name


def test_resume_twin_replays_the_uninterrupted_stream(mnist_url, tmp_path):
    checkpoints = str(tmp_path / 'ckpt')
    runs = {}

    def record(run):
        def on_step(step, batch, metrics):
            runs.setdefault(run, {})[step] = (batch['image'].clone(), batch['digit'].clone(),
                                              float(metrics['loss']))
        return on_step

    kwargs = dict(total_steps=8, checkpoint_every=4, batch_size=16, reader_pool_type='dummy',
                  device='cpu', graphed=False)
    state = resume_example.train_with_checkpointing(mnist_url, checkpoints,
                                                    on_step=record('whole'), **kwargs)
    assert state.step == 8
    assert sorted(os.listdir(checkpoints)) == ['step_00000004', 'step_00000008']
    # the last checkpoint lost, and a half-written one of the same step left
    shutil.rmtree(os.path.join(checkpoints, 'step_00000008'))
    os.makedirs(os.path.join(checkpoints, 'step_00000008'))
    resumed = resume_example.train_with_checkpointing(mnist_url, checkpoints,
                                                      on_step=record('resumed'), **kwargs)
    assert resumed.step == 8 and sorted(runs['resumed']) == [5, 6, 7, 8]
    assert os.path.exists(os.path.join(checkpoints, 'step_00000008', 'DONE'))
    for step, (images, digits, loss) in runs['resumed'].items():
        whole_images, whole_digits, whole_loss = runs['whole'][step]
        assert torch.equal(images, whole_images) and torch.equal(digits, whole_digits), step
        assert loss == pytest.approx(whole_loss, abs=LOSS_TOL)
    for name, value in resumed.module.state_dict().items():
        torch.testing.assert_close(value, state.module.state_dict()[name], rtol=0,
                                   atol=LOSS_TOL)
    # a finished run resumes to nothing
    assert resume_example.train_with_checkpointing(mnist_url, checkpoints, **kwargs).step == 8


def test_imagenet_twin_trains(tmp_path):
    url = 'file://' + str(tmp_path / 'imagenet')
    generate_synthetic_imagenet(url, num_synsets=2, images_per_synset=4)
    state, losses = torch_resnet_example.train(url, batch_size=4, steps=2, image_size=32,
                                               num_classes=16, device='cpu', graphed=False)
    assert state.step == 2 and len(losses) == 2 and all(np.isfinite(losses))
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3),
                                                                dtype=np.uint8))
    mask = torch.tensor([True, False])
    out = torch_resnet_example.device_preprocess(images, mask)
    assert out.dtype == torch.bfloat16
    expected = ((images.flip(2)[0].float() - torch.from_numpy(torch_resnet_example.IMAGENET_MEAN))
                / torch.from_numpy(torch_resnet_example.IMAGENET_STD))
    torch.testing.assert_close(out[0].float(), expected, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('context', ['ring', 'ulysses'])
def test_sequence_twin_trains(tmp_path, context):
    url = 'file://' + str(tmp_path / 'seq')
    generate_sequence_dataset(url, rows=512, rows_per_row_group=64)
    waits = []
    state, losses = torch_sequence_example.train(
        url, steps=4, batch_size=8, window=4, context=context, device='cpu', graphed=False,
        on_step=lambda i, metrics, wait_s: waits.append((i, wait_s)))
    assert state.step == 4 and len(losses) == 4 and all(np.isfinite(losses))
    assert [i for i, _ in waits] == [0, 1, 2, 3] and all(w >= 0 for _, w in waits)


def test_sequence_twin_stages_only_features_and_labels(tmp_path):
    """The example's own flow: the window stacked on the host, two tensors
    staged, the labels the window's first sensor id modulo the classes."""
    from petastorm_tpu_torch.parallel import DataSharding
    url = 'file://' + str(tmp_path / 'seq')
    generate_sequence_dataset(url, rows=128, rows_per_row_group=64)
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.torch import TorchDataLoader
    ngram = NGram({i: ['timestamp', 'features', 'sensor_id'] for i in range(4)},
                  delta_threshold=1, timestamp_field='timestamp')
    with make_reader(url, output='columnar', ngram=ngram, reader_pool_type='dummy') as reader:
        batch = next(iter(TorchDataLoader(reader, batch_size=8)))
    sharding = DataSharding(None, ('data',), torch.device('cpu'), 0, 1)
    x, labels = torch_sequence_example.stage_windows(batch, sharding, sharding, 3)
    assert tuple(x.shape) == (8, 4, 64) and x.dtype == torch.float32
    np.testing.assert_array_equal(x[:, 1].numpy(), batch[1]['features'])
    np.testing.assert_array_equal(labels.numpy(), batch[0]['sensor_id'] % 3)


def test_hello_worlds_read_what_the_jax_adapters_read(tmp_path):
    hw_url = 'file://' + str(tmp_path / 'hw')
    ext_url = 'file://' + str(tmp_path / 'ext')
    hw_generate.generate_petastorm_dataset(hw_url)
    ext_generate.generate_external_dataset(ext_url)

    rows = hw_python.python_hello_world(hw_url)
    assert [int(r.id) for r in rows] == list(range(10))
    batches = hw_torch.torch_hello_world(hw_url, device='cpu')
    with jax_make_reader(hw_url, schema_fields=['id', 'image1']) as reader:
        expected = list(JaxDataLoader(reader, batch_size=4, drop_last=False))
    assert len(batches) == len(expected) == 3
    for got, exp in zip(batches, expected):
        for name in ('id', 'image1'):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(exp[name]))
    sample = hw_pytorch.pytorch_hello_world(hw_url)
    with JaxTorchDataLoader(jax_make_reader(hw_url)) as loader:
        jax_sample = next(iter(loader))
    assert list(sample) == list(jax_sample)
    for name in sample:
        assert torch.equal(sample[name], jax_sample[name]), name

    blocks = ext_python.python_hello_world(ext_url)
    assert sum(len(b.id) for b in blocks) == 100
    batches = ext_torch.torch_hello_world(ext_url, device='cpu')
    with jax_make_batch_reader(ext_url) as reader:
        expected = list(JaxDataLoader(reader, batch_size=16))
    assert len(batches) == len(expected) == 6
    for got, exp in zip(batches, expected):
        for name in exp:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(exp[name]))
    sample = ext_pytorch.pytorch_hello_world(ext_url)
    with JaxTorchDataLoader(jax_make_batch_reader(ext_url)) as loader:
        jax_sample = next(iter(loader))
    assert {k: v.tolist() for k, v in sample.items()} == {
        k: v.tolist() for k, v in jax_sample.items()}


def test_twins_refuse_the_cpu_unless_asked(mnist_url, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    hw_url = 'file://' + str(tmp_path / 'hw')
    calls = [
        lambda: torch_example.train_and_test(mnist_url),
        lambda: pytorch_example.train_and_test(mnist_url),
        lambda: resume_example.train_with_checkpointing(mnist_url, str(tmp_path / 'ck')),
        lambda: torch_resnet_example.train(hw_url),
        lambda: torch_sequence_example.train(hw_url),
        lambda: hw_torch.torch_hello_world(hw_url),
        lambda: ext_torch.torch_hello_world(hw_url),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            call()
    # the graphed step (the default) is CUDA's: the CPU run asks for eager
    with pytest.raises(RuntimeError, match='CUDA'):
        torch_example.train_and_test(mnist_url, device='cpu')
    assert not os.path.exists(str(tmp_path / 'ck'))


def test_every_twin_runs_as_a_module():
    """``python -m <twin> --help`` for every twin, in one fresh interpreter
    that must not load JAX; importing every twin first prints nothing."""
    code = '\n'.join([
        'import importlib, runpy, sys',
        'names = sys.argv[1:]',
        'for name in names:',
        '    importlib.import_module(name)',
        'print("IMPORTED", flush=True)',
        'for name in names:',
        '    sys.modules.pop(name)',
        '    sys.argv = [name, "--help"]',
        '    try:',
        '        runpy.run_module(name, run_name="__main__", alter_sys=True)',
        '    except SystemExit as exit:',
        '        assert exit.code == 0, (name, exit.code)',
        '    else:',
        '        raise AssertionError(name + " did not parse --help")',
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in',
        '             ("jax", "jaxlib", "flax", "optax", "petastorm_tpu"))',
        'assert not bad, bad',
    ])
    out = subprocess.run([sys.executable, '-c', code] + EXAMPLE_MODULES, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith('IMPORTED\n')
    assert out.stdout.count('usage:') == len(EXAMPLE_MODULES)
