"""Port parity: the chunk store of petastorm_tpu_torch against the JAX package's.

Against mock-remote stores (local files behind the retry wrapper the object
stores get), each package with its own cache root (each process's store
writes ``<root>/stats/pid-<pid>.json``, so one root per package in this
process):

* the store's unit behaviour (population, short fetches, atomic racing
  writers, LRU eviction, refetch after an unlink, the strong pool) gives the
  same counters in both packages;
* epochs 1 and 2 of a raw store, a fixed-shape PNG store (fused read from
  the mirrors) and a plain Parquet store give the JAX package's rows and
  ``file://``'s; the prefetcher's timing makes the hit and miss split racy,
  so the counters are compared as the total of fetches, which equals the
  mirror files, and epoch 2 fetches nothing;
* mirror file names and bytes are the same in both packages, and a root the
  JAX package filled in a subprocess serves the port with no miss;
* eviction under a live batch, an unlinked chunk, the prefetcher and its
  budget, and the fused chunk plan (``tests/test_chunkstore.py``);
* the process pool's workers mirror through the same root, their counters
  merged from the stats files; a served tenant reads through the daemon's
  chunk store; the autotuner's prefetch knob decides as the JAX one does.
"""

import gc
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.autotune import controller as jax_controller
from petastorm_tpu.chunkstore.store import ChunkStore as JaxChunkStore
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.autotune import controller
from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, cache_diagnostics
from petastorm_tpu_torch.chunkstore.prefetch import ChunkPrefetcher
from petastorm_tpu_torch.chunkstore.reader import ChunkCachedParquetFile
from petastorm_tpu_torch.chunkstore.store import ChunkStore, open_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.native import is_available
from petastorm_tpu_torch.retry import wrap_retrying
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import ProcessPoolOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, ROWS_PER_GROUP, SIZE = 24, 8, 16
#: the in-process services' ring: a few MiB, not the daemon's 64 MiB default
RING_BYTES = 4 << 20

pytestmark = pytest.mark.skipif(not is_available(), reason='the native reader did not build')


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


# -- the stores ------------------------------------------------------------------------

def _image(i, size=SIZE):
    return np.random.default_rng([11, i]).integers(0, 256, (size, size, 3), dtype=np.uint8)


def _write(url, kind, rows=ROWS, size=SIZE):
    if kind == 'plain':
        path = url[len('file://'):]
        os.makedirs(path)
        table = pa.table({'x': pa.array((np.arange(rows) % 8).astype(np.int64)),
                          'y': pa.array(np.linspace(0, 1, rows).astype(np.float64))})
        pq.write_table(table, os.path.join(path, 'f.parquet'), compression='snappy',
                       use_dictionary=True, row_group_size=ROWS_PER_GROUP)
        return
    codec = RawTensorCodec() if kind == 'raw' else CompressedImageCodec('png')
    schema = Unischema('Remote' + kind.title(), [
        UnischemaField('image', np.uint8, (size, size, 3), codec, False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_GROUP,
                             compression='none' if kind == 'raw' else 'snappy') as writer:
        for i in range(rows):
            writer.write({'image': _image(i, size), 'label': np.int64(i)})


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp('remote_stores')
    out = {}
    for kind in ('raw', 'png_fixed', 'plain'):
        _write('file://' + str(root / kind), kind)
        out[kind] = str(root / kind)
    return out


def _chunk_files(root):
    """relative path -> bytes of every mirror under a cache root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith('.chunk'):
                full = os.path.join(dirpath, name)
                with open(full, 'rb') as f:
                    out[os.path.relpath(full, root)] = f.read()
    return out


def _fetches(diag):
    return diag['chunk_cache_misses'] + diag['chunk_cache_prefetch_chunks']


# -- the store's unit behaviour, both packages ----------------------------------------

def _store_case(cls, root, case):
    if case == 'populate_then_hit':
        store = cls(root)
        calls = []

        def fetch():
            calls.append(1)
            return b'x' * 100
        path, _, fetched = store.ensure('k1', 100, fetch)
        path2, _, fetched2 = store.ensure('k1', 100, fetch)
        return (fetched, not fetched2, path == path2, len(calls), os.path.getsize(path),
                os.path.relpath(path, root))
    if case == 'short_fetch_rejected':
        store = cls(root)
        with pytest.raises(IOError):
            store.ensure('k1', 100, lambda: b'x' * 50)
        return store.contains('k1', 100)
    if case == 'racing_writers_atomic':
        payload = bytes(range(256)) * 40
        barrier = threading.Barrier(4)
        results = []

        def worker():
            # one store per thread, as one per process
            store = cls(root)

            def fetch():
                barrier.wait(timeout=10)
                return payload
            path, _, _ = store.ensure('shared', len(payload), fetch)
            with open(path, 'rb') as f:
                results.append(f.read())

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(results), all(r == payload for r in results)
    if case == 'lru_evicts_oldest':
        store = cls(root, size_limit_bytes=250)
        store.ensure('a', 100, lambda: b'a' * 100)
        os.utime(store._entry_path(store.digest('a')), ns=(1, 1))
        store.ensure('b', 100, lambda: b'b' * 100)
        store.ensure('c', 100, lambda: b'c' * 100)
        return [store.contains(k, 100) for k in 'abc']
    if case == 'refetch_after_unlink':
        store = cls(root)
        fetches = []

        def fetch():
            fetches.append(1)
            return b'z' * 64
        path, _, _ = store.ensure('k', 64, fetch)
        os.unlink(path)
        return bytes(store.mmap_chunk('k', 64, fetch)), len(fetches)
    if case == 'strong_pool_reuses_mapping':
        store = cls(root)
        mm1 = store.mmap_chunk('k', 64, lambda: b'a' * 64)
        ident = id(mm1)
        del mm1
        gc.collect()
        return id(store.mmap_chunk('k', 64, lambda: b'a' * 64)) == ident
    if case == 'strong_pool_never_pins':
        store = cls(root, size_limit_bytes=150)
        store.mmap_chunk('a', 100, lambda: b'a' * 100)
        os.utime(store._entry_path(store.digest('a')), ns=(1, 1))
        store.ensure('b', 100, lambda: b'b' * 100)
        return store.contains('a', 100)
    if case == 'unlinked_chunk_keeps_serving':
        store = cls(root)
        payload = bytes(range(256))
        mm = store.mmap_chunk('k', 256, lambda: payload)
        os.unlink(store._entry_path(store.digest('k')))
        return bytes(mm) == payload
    raise AssertionError(case)


STORE_CASES = ['populate_then_hit', 'short_fetch_rejected', 'racing_writers_atomic',
               'lru_evicts_oldest', 'refetch_after_unlink', 'strong_pool_reuses_mapping',
               'strong_pool_never_pins', 'unlinked_chunk_keeps_serving']


def _store_stats(cls, root):
    snap = cls(root).stats_snapshot()
    return {k: v for k, v in snap.items() if k not in ('chunks_pinned', 'bytes_pinned')}


@pytest.mark.parametrize('case', STORE_CASES)
def test_store_case_equals_jax(case, tmp_path):
    ours = _store_case(ChunkStore, str(tmp_path / 'torch'), case)
    theirs = _store_case(JaxChunkStore, str(tmp_path / 'jax'), case)
    assert ours == theirs
    gc.collect()
    assert _store_stats(ChunkStore, str(tmp_path / 'torch')) == \
        _store_stats(JaxChunkStore, str(tmp_path / 'jax'))
    assert _chunk_files(str(tmp_path / 'torch')) == _chunk_files(str(tmp_path / 'jax'))
    if case == 'lru_evicts_oldest':
        assert ours == [False, True, True]
    if case in ('refetch_after_unlink',):
        assert ours == (b'z' * 64, 2)


# -- epochs 1 and 2, both packages, three stores ----------------------------------------

def _read(package, kind, url, **kwargs):
    """(label-ordered rows, diagnostics) of one epoch: the dummy pool keeps
    the order; the rows are compared as bytes."""
    if kind == 'plain':
        factory = jax_make_batch_reader if package == 'jax' else make_batch_reader
        with factory(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs) as r:
            rows = [(int(x), float(y)) for b in r for x, y in zip(b.x, b.y)]
            diag = r.diagnostics
        return rows, diag
    factory = jax_make_reader if package == 'jax' else make_reader
    with factory(url, reader_pool_type='dummy', output='columnar', shuffle_row_groups=False,
                 **kwargs) as r:
        rows = [(int(label), np.asarray(image).tobytes())
                for b in r for label, image in zip(b.label, b.image)]
        diag = r.diagnostics
    return rows, diag


@pytest.mark.parametrize('kind', ['raw', 'png_fixed', 'plain'])
def test_two_epochs_equal_jax_and_file(kind, stores, tmp_path):
    local, _ = _read('torch', kind, 'file://' + stores[kind])
    url = 'mock-remote://' + stores[kind]
    runs = {}
    for package in ('jax', 'torch'):
        root = str(tmp_path / package)
        first, diag1 = _read(package, kind, url, chunk_cache=root)
        second, diag2 = _read(package, kind, url, chunk_cache=root)
        runs[package] = (first, second, diag1, diag2, _chunk_files(root))
    ours, theirs = runs['torch'], runs['jax']
    assert ours[0] == ours[1] == theirs[0] == theirs[1] == local
    assert len(local) == ROWS
    for first, second, diag1, diag2, files in (ours, theirs):
        # every chunk was fetched once, by a demand miss or by the prefetcher,
        # into one mirror file; epoch 2 fetched nothing and hit
        assert _fetches(diag1) == len(files) > 0
        assert _fetches(diag2) == _fetches(diag1)
        assert diag2['chunk_cache_bytes_fetched'] == diag1['chunk_cache_bytes_fetched']
        assert diag2['chunk_cache_hits'] > diag1['chunk_cache_hits']
    # the same mirrors, name for name and byte for byte
    assert ours[4] == theirs[4]
    assert _fetches(ours[2]) == _fetches(theirs[2])


def test_raw_epoch_is_served_zero_copy_from_the_mirrors(stores, tmp_path):
    from petastorm_tpu_torch import observability as obs
    url = 'mock-remote://' + stores['raw']
    root = str(tmp_path / 'chunks')
    with make_reader(url, reader_pool_type='dummy', output='columnar',
                     shuffle_row_groups=False, chunk_cache=root) as reader:
        list(reader)
    obs.get_registry().reset()
    with make_reader(url, reader_pool_type='dummy', output='columnar',
                     shuffle_row_groups=False, chunk_cache=root) as reader:
        blocks = list(reader)
        diag = reader.diagnostics
    # a view chain over the chunk mirror; every column through the page scan,
    # none through Arrow
    assert np.asarray(blocks[0].image).base is not None
    assert not np.asarray(blocks[0].image).flags.writeable
    assert diag['stage_pagescan_count'] == ROWS // ROWS_PER_GROUP
    assert diag.get('stage_arrow_decode_count', 0) == 0
    assert diag['chunk_cache_chunks_pinned'] > 0
    del blocks
    gc.collect()


def test_a_root_the_jax_package_filled_serves_the_port_with_no_miss(stores, tmp_path):
    url = 'mock-remote://' + stores['raw']
    root = str(tmp_path / 'shared')
    code = ('from petastorm_tpu import make_reader\n'
            'with make_reader({!r}, reader_pool_type="dummy", output="columnar", '
            'shuffle_row_groups=False, chunk_cache={!r}) as r:\n'
            '    print(sum(len(b.label) for b in r))\n').format(url, root)
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO, PSTPU_FLIGHT='0')
    out = subprocess.run([sys.executable, '-c', code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == str(ROWS)
    jax_files = _chunk_files(root)
    before = cache_diagnostics(ChunkCacheConfig(root))
    rows, after = _read('torch', 'raw', url, chunk_cache=root)
    assert rows == _read('torch', 'raw', 'file://' + stores['raw'])[0]
    assert after['chunk_cache_misses'] == before['chunk_cache_misses']
    assert after['chunk_cache_prefetch_chunks'] == before['chunk_cache_prefetch_chunks']
    assert after['chunk_cache_hits'] > before['chunk_cache_hits']
    assert _chunk_files(root) == jax_files


# -- eviction, the prefetcher and the fused chunk plan -----------------------------------

def test_eviction_under_live_batch_never_invalidates_views(tmp_path):
    store_path = str(tmp_path / 'raw')
    _write('file://' + store_path, 'raw', rows=48)
    expected = np.stack([_image(i) for i in range(48)])
    config = ChunkCacheConfig(str(tmp_path / 'chunks'), size_limit_bytes=4096)
    with make_reader('mock-remote://' + store_path, reader_pool_type='dummy',
                     output='columnar', shuffle_row_groups=False, chunk_cache=config) as reader:
        blocks = list(reader)
        diag = cache_diagnostics(config)
        np.testing.assert_array_equal(np.concatenate([b.image for b in blocks]), expected)
        assert diag['chunk_cache_evict_skipped_pinned'] > 0
        assert diag['chunk_cache_chunks_pinned'] > 0
        store = ChunkStore(config.root, size_limit_bytes=config.size_limit_bytes)
        store.ensure('pressure', 4096, lambda: b'p' * 4096)
        np.testing.assert_array_equal(np.concatenate([b.image for b in blocks]), expected)
    del blocks
    gc.collect()
    store._evict_if_needed()
    assert store.stats_snapshot()['chunks_evicted'] > 0


class _FakeVentilator(object):
    def __init__(self, items):
        self._items = items

    def upcoming_items(self, max_items):
        return self._items[:max_items]


def _mock_remote_fs():
    return wrap_retrying(pafs.LocalFileSystem())


def _pieces(store_path, n):
    parquet = next(os.path.join(store_path, p) for p in sorted(os.listdir(store_path))
                   if p.endswith('.parquet'))
    return [SimpleNamespace(path=parquet, row_group=rg) for rg in range(n)]


def _wait_for(predicate, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_prefetcher_populates_upcoming_chunks(stores, tmp_path):
    config = ChunkCacheConfig(str(tmp_path / 'chunks'))
    prefetcher = ChunkPrefetcher(_FakeVentilator([{'piece_index': i} for i in range(3)]),
                                 _pieces(stores['raw'], 3), ['image', 'label'],
                                 _mock_remote_fs, config)
    prefetcher.start()
    try:
        assert _wait_for(lambda: cache_diagnostics(config)['chunk_cache_prefetch_chunks'] >= 6)
    finally:
        prefetcher.stop()
        prefetcher.join()
    diag = cache_diagnostics(config)
    assert diag['chunk_cache_prefetch_chunks'] == 6 and diag['chunk_cache_prefetch_bytes'] > 0
    # the footer is a demand read of the prefetcher's open
    assert diag['chunk_cache_misses'] == 1


def test_prefetcher_respects_its_inflight_byte_budget(stores, tmp_path):
    # image chunks are 8 * 16 * 16 * 3 = 6 KiB and more: a budget below two
    config = ChunkCacheConfig(str(tmp_path / 'chunks'), prefetch_budget_bytes=8000)
    prefetcher = ChunkPrefetcher(_FakeVentilator([{'piece_index': i} for i in range(3)]),
                                 _pieces(stores['raw'], 3), ['image'], _mock_remote_fs, config)
    prefetcher.start()
    try:
        assert _wait_for(lambda: cache_diagnostics(config)['chunk_cache_prefetch_chunks'] >= 1)
        time.sleep(0.5)  # every chance to (wrongly) run ahead
        stalled = cache_diagnostics(config)['chunk_cache_prefetch_chunks']
        assert stalled == 1
        # consumption: a demand hit bumps the mirror's mtime
        for out_path, _size, _ns in list(prefetcher._outstanding):
            os.utime(out_path, None)
        assert _wait_for(
            lambda: cache_diagnostics(config)['chunk_cache_prefetch_chunks'] > stalled)
    finally:
        prefetcher.stop()
        prefetcher.join()


def test_chunk_plan_covers_fused_dict_snappy_chunks(stores, tmp_path):
    config = ChunkCacheConfig(str(tmp_path / 'chunks'))
    path = os.path.join(stores['plain'], 'f.parquet')
    pf = ChunkCachedParquetFile(path, _mock_remote_fs(), config)
    try:
        # neither column qualifies for views (snappy, dictionary) ...
        assert pf._qualifying(0, ['x', 'y']) == []
        # ... yet both are in the prefetcher's work list through the fused plan
        plan = pf.chunk_plan(0, ['x', 'y'])
        assert len(plan) == 2
        store = open_store(config)
        for key, length, fetch_fn in plan:
            assert store.ensure(key, length, fetch_fn, for_prefetch=True)[2]
        diag = cache_diagnostics(config)
        assert diag['chunk_cache_prefetch_chunks'] == 2
        # the fused call decodes the warm mirror exactly
        block, rest = pf.read_fused(0, ['x', 'y'])
        assert rest == []
        np.testing.assert_array_equal(block['x'], (np.arange(8) % 8).astype(np.int64))
        np.testing.assert_array_equal(block['y'],
                                      np.linspace(0, 1, ROWS).astype(np.float64)[:8])
        assert cache_diagnostics(config)['chunk_cache_misses'] == diag['chunk_cache_misses']
    finally:
        pf.close()


def test_chunk_plans_equal_jax(stores, tmp_path):
    from petastorm_tpu.chunkstore.reader import ChunkCachedParquetFile as JaxChunkCachedFile
    from petastorm_tpu.chunkstore.store import ChunkCacheConfig as JaxChunkCacheConfig
    from petastorm_tpu.retry import wrap_retrying as jax_wrap_retrying
    for kind, columns in (('raw', ['image', 'label']), ('png_fixed', ['image', 'label']),
                          ('plain', ['x', 'y'])):
        path = _pieces(stores[kind], 1)[0].path
        ours = ChunkCachedParquetFile(path, _mock_remote_fs(),
                                      ChunkCacheConfig(str(tmp_path / kind / 'torch')))
        theirs = JaxChunkCachedFile(path, jax_wrap_retrying(pafs.LocalFileSystem()),
                                    JaxChunkCacheConfig(str(tmp_path / kind / 'jax')))
        try:
            for rg in range(ROWS // ROWS_PER_GROUP):
                assert [(k, n) for k, n, _ in ours.chunk_plan(rg, columns)] == \
                    [(k, n) for k, n, _ in theirs.chunk_plan(rg, columns)]
        finally:
            ours.close()
            theirs.close()


# -- the process pool, the serve daemon and the autotuner --------------------------------

def test_process_pool_mirrors_through_the_shared_root(stores, tmp_path):
    url = 'mock-remote://' + stores['raw']
    root = str(tmp_path / 'chunks')
    with make_reader(url, reader_pool_type=ProcessPoolOptions(results_timeout_s=60), workers_count=2,
                     output='columnar', shuffle_row_groups=False, chunk_cache=root,
                     zero_copy=True) as reader:
        rows = sorted((int(label), np.asarray(image).tobytes())
                      for b in reader for label, image in zip(b.label, b.image))
        inplace = reader.diagnostics['fused_inplace_batches_total']
    # read once the workers exited: each flushed its counters as it closed
    # its files
    diag = cache_diagnostics(ChunkCacheConfig(root))
    assert rows == _read('torch', 'raw', 'file://' + stores['raw'])[0]
    # the workers' counters come from their stats files. Each row group's two
    # chunks were demanded once by the worker that decoded it in place; each
    # process that opened the file also demanded its footer (the workers
    # and the consumer's prefetcher). Fetches are single per process, so a
    # chunk two processes missed at once is fetched twice
    groups = ROWS // ROWS_PER_GROUP
    demands = diag['chunk_cache_hits'] + diag['chunk_cache_misses']
    assert 2 * groups + 1 <= demands <= 2 * groups + 3
    files = _chunk_files(root)
    assert len(files) == 2 * groups + 1
    assert len(files) <= _fetches(diag) <= len(files) + 2
    stats = [n for n in os.listdir(os.path.join(root, 'stats')) if n.endswith('.json')]
    assert len(stats) >= 2
    assert inplace == groups


def test_served_tenant_reads_through_the_daemons_chunk_store(stores, tmp_path):
    from petastorm_tpu_torch.serve import ReaderService
    url = 'mock-remote://' + stores['raw']
    root = str(tmp_path / 'chunks')
    svc = ReaderService(str(tmp_path / 'svc'), pool_type='thread', workers_count=2,
                        idle_timeout_s=None, ring_bytes=RING_BYTES)
    svc.start()
    try:
        with make_reader(url, serve=svc.service_dir, seed=0, output='columnar',
                         chunk_cache=root) as served:
            ours = sorted((int(label), np.asarray(image).tobytes())
                          for b in served for label, image in zip(b.label, b.image))
            streams = svc.stats()['streams']
    finally:
        svc.shutdown()
    with make_reader(url, seed=0, output='columnar', chunk_cache=str(tmp_path / 'private'),
                     reader_pool_type='dummy') as private:
        theirs = sorted((int(label), np.asarray(image).tobytes())
                        for b in private for label, image in zip(b.label, b.image))
    assert ours == theirs and len(ours) == ROWS
    (stream,) = streams.values()
    assert _fetches(stream['chunk_cache']) == len(_chunk_files(root)) > 0


class _SimCache(object):
    def __init__(self, budget):
        self.prefetch_budget_bytes = budget

    def set_prefetch_budget(self, n):
        self.prefetch_budget_bytes = n


def _fetch_bound(wait=0.9, rows_per_s=100.0):
    return {'window_s': 1.0, 'reader_wait_s': wait, 'reader_wait_fraction': wait,
            'stage_pool_wait_s': wait, 'rows_per_s': rows_per_s, 'wait_proxy': None,
            'stage_read_s': wait, 'stage_chunk_fetch_s': wait * 0.9}


#: name -> (config arguments, starting budget, [(window, now)])
PREFETCH_SCRIPTS = {
    'raise_to_max': ({'cooldown_s': 1.0, 'max_prefetch_bytes': 64 << 20}, 16 << 20,
                     [(_fetch_bound(), 10.0 * i) for i in range(1, 6)]),
    'at_max_grows_workers': ({'cooldown_s': 1.0, 'max_prefetch_bytes': 8 << 20,
                              'max_workers': 4}, 8 << 20,
                             [(_fetch_bound(), 10.0 * i) for i in range(1, 4)]),
    'rollback_prefetch': ({'cooldown_s': 1.0, 'freeze_s': 500.0}, 16 << 20,
                          [(_fetch_bound(), 10.0), (_fetch_bound(rows_per_s=30.0), 20.0),
                           (_fetch_bound(), 30.0)]),
}


def _run_prefetch_script(module, name):
    kwargs, budget, script = PREFETCH_SCRIPTS[name]
    cache = _SimCache(budget)
    pool = SimpleNamespace(workers_count=1)

    def grow():
        pool.workers_count += 1
        return pool.workers_count

    pool.add_worker_slot = grow
    tuner = module.Autotuner(module.AutotuneConfig(interval_s=1.0, **kwargs), pool=pool,
                             chunk_cache=cache)
    for window, now in script:
        tuner.evaluate(dict(window), now=now)
    records = [{k: v for k, v in r.items() if k != 'ts'} for r in tuner.decision_records()]
    return records, tuner.proposal(), cache.prefetch_budget_bytes


@pytest.mark.parametrize('name', sorted(PREFETCH_SCRIPTS))
def test_prefetch_budget_knob_decides_as_jax(name):
    ours = _run_prefetch_script(controller, name)
    assert ours == _run_prefetch_script(jax_controller, name)
    records, proposal, budget = ours
    assert records and records[0]['window']['bottleneck'] == 'worker.chunk_fetch'
    moves = [(r['knob'], r['action']) for r in records]
    if name == 'raise_to_max':
        # doubled to its bound, then the workers grow
        assert budget == 64 << 20
        assert moves == [('prefetch_bytes', 'grow')] * 2 + [('workers', 'grow')] * 3
    if name == 'at_max_grows_workers':
        assert {knob for knob, _ in moves} == {'workers'}
    if name == 'rollback_prefetch':
        # the regressed move is reverted and the knob frozen: the workers grow
        assert moves == [('prefetch_bytes', 'grow'), ('prefetch_bytes', 'rollback'),
                         ('workers', 'grow')]
        assert budget == 16 << 20 and proposal['prefetch_budget_bytes'] == budget


def test_reader_autotuner_gets_the_chunk_cache(stores, tmp_path):
    from petastorm_tpu_torch import AutotuneConfig
    with make_reader('mock-remote://' + stores['raw'], reader_pool_type='dummy',
                     chunk_cache=str(tmp_path / 'chunks'),
                     autotune=AutotuneConfig(interval_s=60.0)) as reader:
        assert reader.autotuner._chunk_cache is reader.chunk_cache_config
        assert reader.autotuner.proposal()['prefetch_budget_bytes'] == \
            reader.chunk_cache_config.prefetch_budget_bytes
        assert len(list(reader)) == ROWS

