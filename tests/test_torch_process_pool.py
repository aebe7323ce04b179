"""The port's process pool (``petastorm_tpu_torch/workers/process_pool.py``)
against the JAX package's and against the port's thread pool, on the CPU.

``make_reader(reader_pool_type='process')`` blocks, on the shm and zmq
transports, equal the JAX process pool's and the thread pool's, compared
per row group (the delivery order of a pool of several workers varies); the
fused in-place publish is counted and exact; zero-copy blocks keep their
bytes, and the ring sizing rule of ``chip_smoke.py`` does not wedge a
shuffling loader; the ``on_error`` policy, a worker killed mid-item, a
worker-killing item, a failed respawn and the blob channel behave as in the
JAX package's ``test_workers_pool.py``/``test_fault_tolerance.py``, with the
thread and dummy pools on the same policy; spawned workers import no
``torch``; two train steps over the process pool match the JAX slice.

Every pool here has at most two workers and a results timeout, so a hang
fails in seconds."""

import collections
import gc
import inspect
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

import chip_smoke
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu_torch import TransformSpec, make_reader
from petastorm_tpu_torch.codecs import (CompressedImageCodec, RawTensorCodec, ScalarCodec,
                                        image_routes)
from petastorm_tpu_torch.errors import (EmptyResultError, PoisonItemError,
                                        WorkerPoolDepletedError)
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.native import read_routes
from petastorm_tpu_torch.native.lifetime import registry
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.test_util import stub_workers
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device, stage_batch
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import (DummyPool, ProcessPool, ProcessPoolOptions, ThreadPool,
                                         WorkerBase)
from petastorm_tpu_torch.workers import process_pool as pp


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
SIZE = 8
ROWS = 64
ROWS_PER_RG = 16
TIMEOUT = {'results_timeout_s': 60}
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _write(url, image_field, images, rows_per_rg=ROWS_PER_RG, compression='none'):
    schema = Unischema('PoolStore', [
        image_field, UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=rows_per_rg,
                             compression=compression) as writer:
        for i, image in enumerate(images):
            writer.write({'image': image, 'label': np.int64(i)})


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """A raw uint8 store and a fixed-shape PNG store (4 row groups each),
    and a PNG store of varying image sizes for ``image_resize``."""
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(ROWS)]
    urls = {}
    for name in ('raw', 'png_fixed', 'png'):
        urls[name] = 'file://' + str(tmp_path_factory.mktemp('pool_' + name))
    _write(urls['raw'], UnischemaField('image', np.uint8, (SIZE, SIZE, 3), RawTensorCodec(),
                                       False), images)
    _write(urls['png_fixed'], UnischemaField('image', np.uint8, (SIZE, SIZE, 3),
                                             CompressedImageCodec('png'), False), images,
           compression='snappy')
    varying = [rng.integers(0, 256, (int(rng.integers(4, 12)), int(rng.integers(4, 12)), 3),
                            dtype=np.uint8) for _ in range(ROWS)]
    _write(urls['png'], UnischemaField('image', np.uint8, (None, None, 3),
                                       CompressedImageCodec('png'), False), varying,
           compression='snappy')
    return urls


def _by_row_group(blocks):
    """label tuple -> block (numpy copies), one entry per delivered block."""
    out = collections.Counter()
    kept = {}
    for block in blocks:
        block = {k: np.array(v) for k, v in block.items()}
        key = tuple(int(x) for x in block['label'])
        out[key] += 1
        kept[key] = block
    assert all(n == 1 for n in out.values()), out
    return kept


def _assert_same_blocks(actual, expected):
    assert sorted(actual) == sorted(expected)
    for key in expected:
        assert sorted(actual[key]) == sorted(expected[key])
        for name in expected[key]:
            a, e = actual[key][name], expected[key][name]
            assert a.dtype == e.dtype and a.shape == e.shape, (name, a.dtype, e.dtype)
            np.testing.assert_array_equal(a, e)


def _port_blocks(url, pool, options=None, **kwargs):
    if pool == 'process':
        pool = ProcessPoolOptions(**dict(TIMEOUT, **(options or {})))
    with make_reader(url, output='columnar', reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=False, **kwargs) as reader:
        blocks = _by_row_group(b._asdict() for b in reader)
        return blocks, reader.diagnostics


def _jax_blocks(url, **kwargs):
    with jax_make_reader(url, output='columnar', reader_pool_type='process', workers_count=2,
                         shuffle_row_groups=False, **kwargs) as reader:
        return _by_row_group(b._asdict() for b in reader)


# -- blocks across pools, transports and packages -------------------------------------

@pytest.mark.parametrize('transport', ['shm', 'zmq'])
@pytest.mark.parametrize('store', ['raw', 'png_fixed'])
def test_process_pool_blocks_equal_jax_and_thread_pools(stores, store, transport):
    url = stores[store]
    expected, _ = _port_blocks(url, 'thread')
    actual, diag = _port_blocks(url, 'process', options={'transport': transport})
    assert diag['transport'] == transport and diag['worker_restarts'] == 0
    _assert_same_blocks(actual, expected)
    _assert_same_blocks(actual, _jax_blocks(url))
    assert len(actual) == ROWS // ROWS_PER_RG


@pytest.mark.parametrize('store', ['raw', 'png_fixed'])
def test_fused_inplace_publish_is_counted_and_exact(stores, store):
    """No transform, no cache: every row group is decoded by the fused call
    straight into the ring slot (page-scan columns included), two columns
    each, and published in place."""
    read_routes.reset()
    actual, diag = _port_blocks(stores[store], 'process')
    counts = read_routes.snapshot()
    n = ROWS // ROWS_PER_RG
    assert counts['fused_inplace_batches_total'] == counts['fused_batches_total'] == n
    assert counts['fused_columns_total'] == 2 * n
    assert counts['pagescan_columns_total'] == counts['arrow_fallback_columns_total'] == 0
    assert diag['publish_inplace'] == n
    assert diag['publish_ring'] == diag['publish_blob'] == diag['publish_zmq'] == 0
    expected, _ = _port_blocks(stores[store], 'thread')
    _assert_same_blocks(actual, expected)


@pytest.mark.parametrize('store', ['raw', 'png_fixed'])
def test_inplace_plans_and_column_regions_match_the_jax_package(stores, store):
    """The in-place planning the row worker runs (``include_pagescan``,
    ``inplace_ok``, ``payload_bytes``) and the column layout of a fused read
    into a caller's buffer (``column_region``) equal the JAX package's."""
    from petastorm_tpu import native as jax_native
    from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
    from petastorm_tpu.native import fused as jax_fused
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.etl import get_schema
    from petastorm_tpu_torch.native import fused

    path = os.path.join(stores[store][len('file://'):], 'part-00000.parquet')
    ours, theirs = native.NativeParquetFile(path), jax_native.NativeParquetFile(path)
    fields, jax_fields = get_schema(stores[store]).fields, jax_get_schema(stores[store]).fields
    columns = ['image', 'label']
    for include in (False, True):
        plan = ours.fused_plan(1, columns, fields, include_pagescan=include)
        ref = theirs.fused_plan(1, columns, jax_fields, include_pagescan=include)
        assert [c.name for c in plan.columns] == [c.name for c in ref.columns]
        assert plan.reasons == ref.reasons and plan.rest == ref.rest
        assert plan.inplace_ok == ref.inplace_ok
        assert plan.payload_bytes() == ref.payload_bytes()
    assert plan.inplace_ok and plan.payload_bytes() == ROWS_PER_RG * (SIZE * SIZE * 3 + 8)
    offsets = [0, plan.columns[0].out_bound]
    buf, jax_buf = bytearray(plan.payload_bytes()), bytearray(plan.payload_bytes())
    results = ours.fused_read_into(plan, memoryview(buf), offsets)
    jax_results = theirs.fused_read_into(ref, memoryview(jax_buf), offsets)
    assert buf == jax_buf and [r[:4] for r in results] == [r[:4] for r in jax_results]
    for p, r, jp, jr in zip(plan.columns, results, ref.columns, jax_results):
        assert fused.column_region(p, r, plan.expected_rows) == jax_fused.column_region(
            jp, jr, ref.expected_rows)
    ours.close()
    theirs.close()


def test_zero_copy_blocks_are_exact_and_their_borrows_return(stores):
    gc.collect()
    base = registry().counters()['lifetime_live_borrows']
    expected, _ = _port_blocks(stores['raw'], 'thread')
    with make_reader(stores['raw'], output='columnar',
                     reader_pool_type=ProcessPoolOptions(**TIMEOUT),
                     workers_count=2, shuffle_row_groups=False, zero_copy=True) as reader:
        blocks = [b._asdict() for b in reader]
        assert reader.diagnostics['zero_copy'] is True
        assert registry().counters()['lifetime_live_borrows'] - base == 2 * len(blocks)
    # the arrays outlive the pool's stop and join: the rings stay mapped
    _assert_same_blocks(_by_row_group(blocks), expected)
    del blocks
    gc.collect()
    assert registry().counters()['lifetime_live_borrows'] == base


@pytest.mark.parametrize('zero_copy', [False, True])
def test_a_torch_tensor_keeps_its_bytes_while_later_blocks_arrive(stores, zero_copy):
    """``torch.from_numpy`` of a delivered view shares its memory: in copy
    mode the message buffer, in zero-copy mode the ring slot, whose bytes
    the producer may not reuse while the tensor lives (the borrow is held
    through the view's root, whatever slices were taken)."""
    gc.collect()
    base = registry().counters()['lifetime_live_borrows']
    ring = 3 * (ROWS_PER_RG * (SIZE * SIZE * 3 + 8) + 2048)  # three messages
    with make_reader(stores['raw'], output='columnar',
                     reader_pool_type=ProcessPoolOptions(ring_bytes=ring, **TIMEOUT),
                     workers_count=1, shuffle_row_groups=False, num_epochs=None,
                     zero_copy=zero_copy) as reader:
        it = iter(reader)
        first = next(it)
        held = stage_batch({'image': first.image[3:7]}, 'cpu')['image']
        snapshot = held.clone()
        assert np.shares_memory(held.numpy(), first.image)
        del first
        gc.collect()
        if zero_copy:
            assert registry().counters()['lifetime_live_borrows'] > base
        # two more messages fit beside the held one; in copy mode the ring
        # wraps many times over
        for _ in range(2 if zero_copy else 12):
            next(it)
        assert torch.equal(held, snapshot)
        del held
        gc.collect()
        for _ in range(12):  # the ring is reused once the tensor died
            next(it)
    gc.collect()
    assert registry().counters()['lifetime_live_borrows'] == base


def test_small_rings_sized_by_the_smoke_rule_do_not_wedge_a_shuffling_loader(stores):
    """Zero-copy blocks pin ring bytes while the loader's shuffle buffer
    holds them, and rings release in FIFO order; rings of the size
    ``chip_smoke.ring_bytes_needed`` gives still feed a shuffling loader
    epoch after epoch."""
    payload = ROWS_PER_RG * (SIZE * SIZE * 3 + 8) + 8 + 9 + 1024
    capacity, batch, workers = 32, 8, 2
    ring = chip_smoke.ring_bytes_needed(workers, payload, ROWS_PER_RG, capacity, batch)
    assert ring < 8 * payload
    epochs = 6
    with make_reader(stores['raw'], output='columnar',
                     reader_pool_type=ProcessPoolOptions(ring_bytes=ring, **TIMEOUT),
                     workers_count=workers, num_epochs=epochs, seed=3,
                     zero_copy=True) as reader:
        loader = TorchDataLoader(reader, batch, shuffling_queue_capacity=capacity, seed=3)
        labels = []
        for staged in prefetch_to_device(loader, 'cpu', size=2):
            labels.extend(staged['label'].tolist())
    assert sorted(labels) == sorted(list(range(ROWS)) * epochs)


def test_ring_sizing_keeps_the_default_or_what_fits():
    payload = chip_smoke.raw_payload_bytes()
    assert chip_smoke.ring_bytes_for(1 << 40, 8, payload, 64) == (
        64 << 20, chip_smoke.ring_bytes_needed(8, payload, 64))
    ring, needed = chip_smoke.ring_bytes_for(300 << 20, 8, payload, 64)
    assert ring == 33 << 20 and ring >= needed and ring * 8 <= 0.9 * (300 << 20)
    with pytest.raises(AssertionError, match='bytes free'):
        chip_smoke.ring_bytes_for(64 << 20, 8, payload, 64)


# -- the counts the workers ship -----------------------------------------------------

def test_worker_route_counts_reach_the_consumer(stores):
    """Image decodes and column reads counted inside the workers show in the
    consumer's counters, as the thread pool's do; a decoded block above the
    blob threshold rides the blob channel."""
    spec = TransformSpec(image_resize={'image': (SIZE, SIZE)})
    counts = {}
    for pool, extra in (('thread', {}), ('process', {'options': {'blob_threshold_bytes':
                                                                   1024}})):
        image_routes.reset()
        read_routes.reset()
        blocks, diag = _port_blocks(stores['png'], pool, transform_spec=spec, **extra)
        counts[pool] = (image_routes.snapshot(), read_routes.snapshot(), blocks)
    assert counts['process'][0] == counts['thread'][0]
    assert counts['process'][0]['decode_native'] == ROWS
    assert counts['process'][1] == counts['thread'][1]
    _assert_same_blocks(counts['process'][2], counts['thread'][2])
    assert diag['publish_blob'] == ROWS // ROWS_PER_RG and diag['publish_ring'] == 0


@pytest.mark.parametrize('transport', ['shm', 'zmq'])
def test_blob_channel_delivers_and_cleans_up(transport):
    pool = ProcessPool(2, serializer=NumpyBlockSerializer(), transport=transport,
                       blob_threshold_bytes=1024, **TIMEOUT)
    pool.start(stub_workers.NumpyBatchWorker)
    blob_dir = pool._blob_dir
    try:
        assert blob_dir and os.path.isdir(blob_dir)
        for n in (10, 2000, 3000):
            pool.ventilate(n)
        got = sorted(_drain(pool), key=lambda b: len(b['x']))
    finally:
        pool.stop()
        pool.join()
    assert [len(b['x']) for b in got] == [10, 2000, 3000]
    for b in got:
        n = len(b['x'])
        assert np.array_equal(b['x'], np.arange(n)) and b['y'].shape == (n, 1)
        assert b['x'].flags.writeable
    diag = pool.diagnostics
    assert diag['publish_blob'] == 2
    assert diag['publish_ring' if transport == 'shm' else 'publish_zmq'] == 1
    assert not os.path.exists(blob_dir)


def test_stale_blob_dirs_are_swept(tmp_path):
    dead = subprocess.run([sys.executable, '-c', 'import os; print(os.getpid())'],
                          capture_output=True, text=True).stdout.strip()
    old = time.time() - 2 * pp._BLOB_SWEEP_GRACE_S
    paths = {'dead_old': 'pstpu_blobs_{}_a'.format(dead), 'dead_new': 'pstpu_blobs_{}_b'.format(dead),
             'alive_old': 'pstpu_blobs_{}_c'.format(os.getppid()),
             'unparseable_old': 'pstpu_blobs_x_d', 'other': 'unrelated'}
    for key, name in paths.items():
        (tmp_path / name).mkdir()
        if key.endswith('old') or key == 'other':
            os.utime(tmp_path / name, (old, old))
    pp._sweep_stale_blob_dirs(str(tmp_path))
    left = {key for key, name in paths.items() if (tmp_path / name).exists()}
    assert left == {'dead_new', 'alive_old', 'other'}


# -- supervision ---------------------------------------------------------------------

def _drain(pool, timeout_s=60):
    got = []
    while True:
        try:
            got.append(pool.get_results(timeout_s=timeout_s))
        except EmptyResultError:
            return got


@pytest.mark.parametrize('transport', ['shm', 'zmq'])
def test_sigkill_mid_item_delivers_every_item_exactly_once(tmp_path, transport):
    pool = ProcessPool(2, transport=transport, **TIMEOUT)
    pool.start(stub_workers.CrashOnceWorker, {'crash_on': 3, 'state_dir': str(tmp_path)})
    try:
        for i in range(10):
            pool.ventilate(i)
        got = _drain(pool)
    finally:
        pool.stop()
        pool.join()
    assert sorted(got) == list(range(10))
    diag = pool.diagnostics
    assert diag['worker_restarts'] >= 1 and diag['items_requeued'] >= 1
    assert diag['items_quarantined'] == 0
    assert diag['items_ventilated'] == diag['items_completed'] == 10


@pytest.mark.parametrize('on_error', ['skip', 'raise'])
def test_an_item_that_keeps_killing_workers(on_error):
    pool = ProcessPool(2, on_error=on_error, max_item_retries=1, **TIMEOUT)
    pool.start(stub_workers.HardExitWorker, {'crash_on': 1})
    try:
        for i in range(4):
            pool.ventilate(i)
        if on_error == 'skip':
            got = _drain(pool)
            assert sorted(got) == [[0], [2], [3]]
            record, = pool.quarantined_items
            assert record['kind'] == 'crash' and record['attempts'] == 2
            assert pool.diagnostics['items_completed'] == 4
        else:
            with pytest.raises(PoisonItemError, match='killed 2 consecutive'):
                _drain(pool)
    finally:
        pool.stop()
        pool.join()


def test_respawn_failure_sheds_the_slot_and_depletes_the_pool():
    pool = ProcessPool(1, **TIMEOUT)
    pool.start(stub_workers.HardExitWorker, {'crash_on': 1})
    try:
        pool.ventilate(0)
        assert pool.get_results() == [0]

        def broken_spawn(worker_id, ring_name):
            raise OSError('simulated: spawn failed')

        pool._spawn_worker = broken_spawn
        pool.ventilate(1)  # kills the only worker, whose respawn now fails
        with pytest.raises(WorkerPoolDepletedError, match='respawn kept failing'):
            _drain(pool)
    finally:
        pool.stop()
        pool.join()


@pytest.mark.parametrize('on_error', ['retry', 'skip'])
def test_publish_then_error_delivers_exactly_once_process_pool(tmp_path, on_error):
    pool = ProcessPool(2, on_error=on_error, max_item_retries=2, **TIMEOUT)
    pool.start(stub_workers.PublishThenErrorWorker, {'fail_on': (2,), 'state_dir': str(tmp_path)})
    try:
        for i in range(6):
            pool.ventilate(i)
        got = _drain(pool)
    finally:
        pool.stop()
        pool.join()
    assert sorted(got) == list(range(6))
    diag = pool.diagnostics
    assert diag['items_requeued'] == 0 and diag['items_quarantined'] == 0
    assert diag['items_ventilated'] == diag['items_completed'] == 6


@pytest.mark.parametrize('pool_factory', [
    lambda: ThreadPool(2, on_error='retry', max_item_retries=2),
    lambda: DummyPool(on_error='retry', max_item_retries=2),
], ids=['thread', 'dummy'])
def test_publish_then_error_delivers_exactly_once_in_process(tmp_path, pool_factory):
    pool = pool_factory()
    pool.start(stub_workers.PublishThenErrorWorker, {'fail_on': (1, 3),
                                                      'state_dir': str(tmp_path)})
    for i in range(5):
        pool.ventilate(i)
    got = _drain_in_process(pool)
    pool.stop()
    pool.join()
    assert sorted(got) == list(range(5))
    assert pool.diagnostics['items_requeued'] == 0


def _drain_in_process(pool):
    got = []
    while True:
        try:
            got.append(pool.get_results())
        except EmptyResultError:
            return got


@pytest.mark.parametrize('pool_factory', [
    lambda: ThreadPool(1, on_error='skip', max_item_retries=1),
    lambda: DummyPool(on_error='skip', max_item_retries=1),
    lambda: ProcessPool(1, on_error='skip', max_item_retries=1, **TIMEOUT),
], ids=['thread', 'dummy', 'process'])
def test_retry_accounting_is_exact(pool_factory):
    pool = pool_factory()
    pool.start(stub_workers.ExceptionEveryNWorker, worker_setup_args=5)
    try:
        for i in [1, 2, 5, 3]:
            pool.ventilate(i)
        got = _drain_in_process(pool)
    finally:
        pool.stop()
        pool.join()
    assert sorted(got) == [1, 2, 3]
    diag = pool.diagnostics
    assert diag['items_ventilated'] == diag['items_completed'] == 4
    assert diag['items_requeued'] == 1 and diag['items_quarantined'] == 1
    record, = pool.quarantined_items
    assert record['kind'] == 'error' and 'stub failure on 5' in record['traceback']


# -- the on_error policy through make_reader, alike on every pool -------------------------

def _pool_type(pool_type):
    return ProcessPoolOptions(**TIMEOUT) if pool_type == 'process' else pool_type


def _labels(reader):
    return [int(x) for block in reader for x in block.label]


@pytest.mark.parametrize('pool_type', ['thread', 'dummy', 'process'])
def test_poison_skip_completes_the_epoch(stores, pool_type):
    spec = TransformSpec(stub_workers.FailOnLabel(32), batched=True)
    with make_reader(stores['raw'], output='columnar', reader_pool_type=_pool_type(pool_type),
                     workers_count=2, seed=0, transform_spec=spec, on_error='skip',
                     max_item_retries=1) as reader:
        labels = _labels(reader)
        assert sorted(labels) == [i for i in range(ROWS) if not 32 <= i < 48]
        record, = reader.quarantined_items
        assert record['kind'] == 'error' and record['attempts'] == 2
        assert 'injected failure on label 32' in record['traceback']
        diag = reader.diagnostics
        assert diag['items_quarantined'] == 1 and diag['items_requeued'] == 1
        assert diag['items_ventilated'] == diag['items_completed'] == ROWS // ROWS_PER_RG


@pytest.mark.parametrize('pool_type', ['thread', 'dummy', 'process'])
def test_poison_raise_surfaces_the_worker_traceback(stores, pool_type):
    spec = TransformSpec(stub_workers.FailOnLabel(32), batched=True)
    with make_reader(stores['raw'], output='columnar', reader_pool_type=_pool_type(pool_type),
                     workers_count=2, seed=0, transform_spec=spec, on_error='raise') as reader:
        with pytest.raises(ValueError, match='injected failure') as info:
            _labels(reader)
    assert 'injected failure on label 32' in info.value.worker_traceback
    assert 'worker-side traceback' in str(info.value.__cause__)


@pytest.mark.parametrize('pool_type', ['thread', 'dummy', 'process'])
def test_transient_error_retry_recovers_the_full_epoch(stores, tmp_path, pool_type):
    spec = TransformSpec(stub_workers.FailOnLabel(16, times=1, state_dir=str(tmp_path)),
                         batched=True)
    with make_reader(stores['raw'], output='columnar', reader_pool_type=_pool_type(pool_type),
                     workers_count=2, seed=0, transform_spec=spec, on_error='retry',
                     max_item_retries=2) as reader:
        assert sorted(_labels(reader)) == list(range(ROWS))
        diag = reader.diagnostics
        assert diag['items_requeued'] == 1 and diag['items_quarantined'] == 0


def test_make_reader_takes_the_pool_arguments(stores):
    from petastorm_tpu_torch.analysis.protocol.monitor import ProtocolMonitor
    monitor = ProtocolMonitor(name='test')
    with make_reader(stores['raw'], output='columnar',
                     reader_pool_type=ProcessPoolOptions(**TIMEOUT), workers_count=2,
                     zero_copy=True, on_error='skip', max_item_retries=2,
                     protocol_monitor=monitor) as reader:
        assert reader._pool.protocol_monitor is monitor
        assert sorted(_labels(reader)) == list(range(ROWS))
    snap = monitor.snapshot
    assert snap['ventilated'] == snap['completed'] == ROWS // ROWS_PER_RG
    assert snap['in_flight'] == [] and snap['events_checked'] > 0
    for pool_type in ('thread', 'dummy'):  # zero_copy: a no-op in process
        with make_reader(stores['raw'], output='columnar', reader_pool_type=pool_type,
                         zero_copy=True) as reader:
            assert sorted(_labels(reader)) == list(range(ROWS))
    with pytest.raises(ValueError, match='on_error'):
        make_reader('file:///nonexistent', on_error='explode')
    with pytest.raises(ValueError, match='max_item_retries'):
        make_reader('file:///nonexistent', max_item_retries=-1)
    # the JAX factory's signature: pool options ride reader_pool_type
    with pytest.raises(TypeError, match='pool_kwargs'):
        make_reader(stores['raw'], pool_kwargs=TIMEOUT)
    assert inspect.signature(make_reader) == inspect.signature(jax_make_reader)
    with pytest.raises(RuntimeError, match='not started'):
        ProcessPool(1).add_worker_slot()


def test_a_joined_pool_returns_nothing_more():
    pool = ProcessPool(1, **TIMEOUT)
    pool.start(stub_workers.IdentityWorker)
    pool.ventilate(1)
    pool.stop()
    pool.join()
    with pytest.raises(EmptyResultError):
        pool.get_results()


class _BurstWorker(WorkerBase):
    """Publishes three payloads per item."""

    def process(self, item):
        for i in range(3):
            self.publish(item * 10 + i)


def test_a_joined_thread_pool_keeps_no_result():
    """A worker blocked putting into a full results queue when the pool
    stops can land that put after join's last drain; join drops it, so no
    payload (nor a borrow it holds) outlives the pool."""
    pool = ThreadPool(1, results_queue_size=1)
    pool.start(_BurstWorker)
    pool.ventilate(1)
    deadline = time.monotonic() + 10
    while pool._results_queue.qsize() < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    time.sleep(0.1)  # the worker waits to put its second payload
    pool.stop()
    pool.join()
    assert pool._results_queue.qsize() == 0
    with pytest.raises(EmptyResultError):
        pool.get_results()


def test_timeout_names_every_workers_state():
    pool = ProcessPool(1, results_timeout_s=1)
    pool.start(stub_workers.HardExitWorker, {'crash_on': -1})
    try:
        pool._ventilated_items += 1  # an item no worker was given
        with pytest.raises(Exception, match='worker 0: pid .* alive'):
            pool.get_results()
    finally:
        pool.stop()
        pool.join()


# -- the worker processes -------------------------------------------------------------

@pytest.mark.parametrize('env', [None, '3'])
def test_spawned_workers_import_no_torch_and_share_the_cores(monkeypatch, env):
    if env is None:
        monkeypatch.delenv('PSTPU_IMG_THREADS', raising=False)
    else:
        monkeypatch.setenv('PSTPU_IMG_THREADS', env)
    pool = ProcessPool(2, **TIMEOUT)
    pool.start(stub_workers.ProbeWorker)
    try:
        for i in range(4):
            pool.ventilate(i)
        got = _drain(pool)
    finally:
        pool.stop()
        pool.join()
    assert len(got) == 4 and not any(g['torch_imported'] for g in got)
    share = str(max(1, (os.cpu_count() or 1) // 2)) if env is None else env
    assert {g['img_threads'] for g in got} == {share}
    assert os.getpid() not in {g['pid'] for g in got}


def test_new_modules_import_nothing_of_jax_or_torch_and_build_nothing():
    code = '\n'.join([
        'import sys',
        'import petastorm_tpu_torch.reader, petastorm_tpu_torch.row_worker',
        'from petastorm_tpu_torch import serializers',
        'from petastorm_tpu_torch.native import lifetime, shm_ring',
        'from petastorm_tpu_torch.workers import process_pool, protocol, supervision',
        'from petastorm_tpu_torch.test_util import stub_workers',
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in',
        '             ("torch", "jax", "jaxlib", "flax", "optax", "petastorm_tpu"))',
        'assert not bad, bad',
        'assert shm_ring._lib is None and not shm_ring._load_failed',
    ])
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# -- the slice: two train steps over the process pool ----------------------------------

@pytest.fixture(scope='module')
def slice_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('pool_slice'))
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(64)]
    _write(url, UnischemaField('image', np.uint8, (32, 32, 3), RawTensorCodec(), False), images)
    return url


def test_two_train_steps_over_the_process_pool_match_the_jax_slice(slice_store):
    """One worker process keeps the seeded row-group order, so the batches
    are the JAX slice's (dummy pool, seed 7); 1e-3 covers float32 sums in
    another order through a forward, a backward and one update."""
    num_classes, batch = 64, 8
    jax_model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                          num_classes=num_classes, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                                              train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    state = jax_create_train_state(jax_model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    expected = []
    with jax_make_reader(slice_store, output='columnar', reader_pool_type='dummy',
                         seed=7) as reader:
        batches = iter(jax_prefetch_to_device(
            JaxDataLoader(reader, batch, shuffling_queue_capacity=32, seed=7), size=2))
        for _ in range(2):
            b = next(batches)
            state, metrics = step(state, b['image'], b['label'])
            expected.append(float(metrics['loss']))
        batches.close()

    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=num_classes, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    tstate = create_train_state(model, device='cpu')
    tstep = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    actual = []
    with make_reader(slice_store, output='columnar',
                     reader_pool_type=ProcessPoolOptions(**TIMEOUT), workers_count=1, seed=7,
                     zero_copy=True) as reader:
        batches = iter(prefetch_to_device(
            TorchDataLoader(reader, batch, shuffling_queue_capacity=32, seed=7), 'cpu', size=2))
        for _ in range(2):
            b = next(batches)
            tstate, metrics = tstep(tstate, b['image'], b['label'])
            actual.append(metrics['loss'].item())
        batches.close()
    assert all(np.isfinite(actual)) and actual[0] != actual[1]
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)
