"""Port parity: the mesh helpers of ``petastorm_tpu_torch.parallel`` against
``petastorm_tpu.parallel`` (twin of ``tests/test_jax_loader.py``'s mesh
tests). The JAX side runs on the suite's 8 virtual CPU devices; the port's
on a gloo world: of one rank in this process (created by ``make_mesh``,
destroyed after each test), or of four spawned ranks on a ``(2, 2)`` mesh.
Shapes, shards and batch sizes are exact; staged values are exact."""

import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.parallel import data_sharding as jax_data_sharding
from petastorm_tpu.parallel import make_global_batch as jax_make_global_batch
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu.parallel import process_local_batch_size as jax_process_local_batch_size
from petastorm_tpu.parallel import reader_shard_for_process as jax_reader_shard_for_process
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.parallel import (DataSharding, data_sharding, make_global_batch,
                                          make_mesh, process_local_batch_size,
                                          reader_shard_for_process)
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.parallel.mesh import mesh_shape
from petastorm_tpu_torch.test_util import dist_workers
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


SIZE = 16


@pytest.fixture
def world_one():
    """The world of one that ``make_mesh`` creates when no group exists."""
    assert not dist.is_initialized()
    mesh = make_mesh(('data',), device='cpu')
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows of 16x16x3 uint8 images, 8 per row group."""
    url = 'file://' + str(tmp_path_factory.mktemp('mesh_store'))
    schema = Unischema('MeshStore', [
        UnischemaField('image', np.uint8, (SIZE, SIZE, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    with materialize_dataset(url, schema, rows_per_row_group=8) as writer:
        for i in range(64):
            writer.write({'image': rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
                          'label': np.int64(i % 8)})
    return url


MESH_CASES = [
    (('data',), None, 8),
    (('data', 'model'), None, 8),
    (('data', 'model'), (-1, 2), 8),
    (('data', 'model'), (None, 4), 8),
    (('data', 'model'), {'model': 2}, 8),
    (('data', 'model'), {'data': 2, 'model': 2}, 4),
    (('data', 'model'), (2, 2), 4),
    (('data', 'model', 'seq'), (2, -1, 2), 8),
]

BAD_MESH_CASES = [
    (('data', 'model'), (3, 2), 8),           # does not use all devices
    (('data',), {'bogus': 2}, 8),             # unknown axis
    (('data', 'model'), (-1, -1), 8),         # two wildcards
    (('data', 'model'), (8,), 8),             # lengths differ
    (('data', 'model'), (-1, 3), 8),          # not divisible
]


@pytest.mark.parametrize('names,shapes,n', MESH_CASES)
def test_mesh_shape_rules_match_jax(names, shapes, n):
    expected = jax_make_mesh(names, axis_shapes=shapes, devices=jax.devices()[:n]).devices.shape
    assert tuple(mesh_shape(names, shapes, n)) == expected


@pytest.mark.parametrize('names,shapes,n', BAD_MESH_CASES)
def test_bad_mesh_shapes_raise_like_jax(names, shapes, n):
    with pytest.raises(ValueError):
        jax_make_mesh(names, axis_shapes=shapes, devices=jax.devices()[:n])
    with pytest.raises(ValueError):
        mesh_shape(names, shapes, n)


def test_make_mesh_creates_a_world_of_one(world_one):
    assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'
    assert world_one.mesh_dim_names == ('data',) and tuple(world_one.shape) == (1,)
    # a single process in both packages: shard 0 of 1, the whole batch
    assert reader_shard_for_process(world_one) == reader_shard_for_process() == \
        jax_reader_shard_for_process() == (0, 1)
    assert process_local_batch_size(64, world_one) == jax_process_local_batch_size(64) == 64
    sharding = data_sharding(world_one)
    assert sharding == DataSharding(world_one, ('data',), torch.device('cpu'), 0, 1, None)
    # a mesh that does not use the world is refused, naming the cause
    with pytest.raises(ValueError, match='does not use all 1 ranks'):
        make_mesh(('data', 'model'), axis_shapes=(1, 2), device='cpu')


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert not dist.is_initialized()


def test_make_global_batch_matches_jax(world_one):
    local = {'x': np.arange(16, dtype=np.float32), 's': np.array(['a'] * 16, dtype=object),
             'ts': np.array(['2024-01-01'] * 16, dtype='datetime64[ns]'),
             'nested': {'y': np.arange(16, dtype=np.int64)}}
    expected = jax_make_global_batch(local, jax_data_sharding(jax_make_mesh(('data',))))
    out = make_global_batch(local, data_sharding(world_one))
    assert isinstance(expected['x'], jax.Array) and isinstance(out['x'], torch.Tensor)
    np.testing.assert_array_equal(out['x'].numpy(), np.asarray(expected['x']))
    np.testing.assert_array_equal(out['nested']['y'].numpy(), np.asarray(expected['nested']['y']))
    # strings and datetimes stay host-side numpy in both
    for key in ('s', 'ts'):
        assert isinstance(expected[key], np.ndarray) and isinstance(out[key], np.ndarray)
        np.testing.assert_array_equal(out[key], expected[key])


def test_prefetch_and_loader_to_sharding_match_jax(world_one, store):
    # the same store, seed and shuffle through both packages' loaders onto a
    # data sharding, by the loader's to_device and by prefetch_to_device
    def jax_batches(**kwargs):
        with jax_make_reader(store, output='columnar', reader_pool_type='dummy',
                             seed=3) as reader:
            loader = JaxDataLoader(reader, 8, shuffling_queue_capacity=32, seed=3, **kwargs)
            return [{k: np.asarray(v) for k, v in b.items()} for b in loader]

    def torch_batches(prefetch, **kwargs):
        with make_reader(store, output='columnar', reader_pool_type='dummy', seed=3) as reader:
            loader = TorchDataLoader(reader, 8, shuffling_queue_capacity=32, seed=3, **kwargs)
            batches = prefetch_to_device(loader, sharding, size=2) if prefetch else loader
            return [{k: v.numpy() for k, v in b.items()} for b in batches]

    sharding = data_sharding(world_one)
    jax_sharding = jax_data_sharding(jax_make_mesh(('data',), devices=jax.devices()[:1]))
    expected = jax_batches(to_device=jax_sharding)
    with jax_make_reader(store, output='columnar', reader_pool_type='dummy', seed=3) as reader:
        prefetched = [{k: np.asarray(v) for k, v in b.items()} for b in jax_prefetch_to_device(
            JaxDataLoader(reader, 8, shuffling_queue_capacity=32, seed=3), jax_sharding)]
    for actual in (torch_batches(False, to_device=sharding), torch_batches(True)):
        assert len(actual) == len(expected) == len(prefetched) == 8
        for a, b, c in zip(actual, expected, prefetched):
            for key in ('image', 'label'):
                np.testing.assert_array_equal(a[key], b[key])
                np.testing.assert_array_equal(a[key], c[key])


@pytest.fixture(scope='module')
def mesh_2x2(store):
    """Four spawned gloo ranks on a (2, 2) mesh: the helpers' facts, then
    three sharded steps on batches each rank reads through its own reader
    (2-worker thread pool) and prefetch_to_device onto the data sharding."""
    spec = {'device': 'cpu', 'axis_shapes': (2, 2), 'url': store, 'global_batch': 8,
            'steps': 3, 'flip_seed': 1, 'preprocess': 'flip_normalize',
            'model': {'stage_sizes': [1, 1], 'block': 'basic', 'num_classes': 8,
                      'num_filters': 8}}
    return spawn(dist_workers.mesh_facts, 4, (spec,), threads=1)


def test_mesh_helpers_on_four_ranks(mesh_2x2):
    for rank, (facts, _) in enumerate(mesh_2x2):
        coord = rank // 2
        # the data coordinate, not the rank: one model group reads one shard
        assert facts['coord'] == facts['reader_shard'] == (coord, 2)
        assert facts['reader_shard_no_mesh'] == (rank, 4)
        assert facts['replicas'] == 2
        assert facts['local_batch'] == 4
        assert 'not divisible by the data size 2' in facts['local_batch_error']
        # the model group's first rank's batch, numeric and host-side
        first = mesh_2x2[2 * coord][0]['global_batch']
        kinds = {k: v[0] for k, v in facts['global_batch'].items()}
        assert kinds == {'x': 'Tensor', 's': 'ndarray', 'ts': 'ndarray'}
        for key, (_, value) in facts['global_batch'].items():
            np.testing.assert_array_equal(value, first[key][1])
        np.testing.assert_array_equal(facts['global_batch']['x'][1],
                                      np.arange(4, dtype=np.float32) + 200 * coord)


def test_two_model_ranks_step_on_identical_batches(mesh_2x2):
    # each rank reads its shard through a 2-worker thread pool, whose order
    # differs between processes: the model group's ranks must still see the
    # same rows in the same order, by prefetch_to_device and by the loader
    for coord in (0, 1):
        (facts0, run0), (facts1, run1) = mesh_2x2[2 * coord], mesh_2x2[2 * coord + 1]
        assert facts0['loader_digests'] == facts1['loader_digests']
        assert run0['digests'] == run1['digests'] and len(run0['digests']) == 3
    assert mesh_2x2[0][1]['digests'] != mesh_2x2[2][1]['digests']
    # the sharded step's metrics are the global batch's on every rank
    losses = {tuple(run['losses']) for _, run in mesh_2x2}
    assert len(losses) == 1 and all(np.isfinite(next(iter(losses))))
