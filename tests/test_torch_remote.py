"""Port parity: remote stores of petastorm_tpu_torch against the JAX package's.

* The retry machinery (``retry.py``, ``pafs_util.py``): ``RetryPolicy.call``
  sleeps the same schedule and ends the same way in both packages (sleep,
  clock and jitter draws patched in both); ``fetch_range`` reads the same
  windows and refuses the same short reads; the flaky-filesystem cases of
  ``tests/test_retry.py`` hold for both packages' wrappers.
* Resolution (``fs.py``, ``hdfs/``): every scheme resolves to the same kind
  of filesystem and path, compares and pickles the same way, and
  ``retry_policy=False`` wraps nothing. The HA namenode client fails over
  through the same connect sequence with fake connectors.
* Faults: ``FaultPlan(storage_fail_first=3)`` under ``make_reader`` gives the
  rows of ``file://`` in both packages.
* ``resolve_chunk_cache`` and ``upcoming_items`` of the three ventilators.
* Two ResNet train steps from a mock-remote store with a chunk cache equal
  the JAX package's two steps.

No S3, GCS or HDFS service exists here: those resolvers are built over local
filesystems patched in, as the JAX package's tests build them.
"""

import errno
import os
import pickle
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu.faults as jax_faults
import petastorm_tpu.fs as jax_fs
import petastorm_tpu.retry as jax_retry
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.chunkstore import resolve_chunk_cache as jax_resolve_chunk_cache
from petastorm_tpu.elastic.coordinator import ElasticVentilator as JaxElasticVentilator
from petastorm_tpu.hdfs import namenode as jax_nn
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.pafs_util import DelegatingHandler as JaxDelegatingHandler
from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxConcurrentVentilator
from petastorm_tpu.workers.ventilator import FairShareVentilator as JaxFairShareVentilator
from petastorm_tpu_torch import faults as torch_faults
from petastorm_tpu_torch import fs as torch_fs
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import retry as torch_retry
from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, resolve_chunk_cache
from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.elastic.coordinator import ElasticVentilator
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.hdfs import namenode as torch_nn
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.pafs_util import DelegatingHandler
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import ConcurrentVentilator, FairShareVentilator

PKGS = {
    'jax': SimpleNamespace(retry=jax_retry, fs=jax_fs, nn=jax_nn, faults=jax_faults,
                           handler=JaxDelegatingHandler, make_reader=jax_make_reader,
                           make_batch_reader=jax_make_batch_reader),
    'torch': SimpleNamespace(retry=torch_retry, fs=torch_fs, nn=torch_nn, faults=torch_faults,
                             handler=DelegatingHandler, make_reader=make_reader,
                             make_batch_reader=make_batch_reader),
}
PACKAGES = sorted(PKGS)


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


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    yield
    for pkg in PKGS.values():
        pkg.faults.uninstall()
        assert pkg.retry.FAULT_POINT is None


def _fast(package, **kwargs):
    args = dict(max_attempts=4, initial_backoff_s=0.001, max_backoff_s=0.004)
    args.update(kwargs)
    return PKGS[package].retry.RetryPolicy(**args)


# -- RetryPolicy.call: the sleep schedule and the outcome ----------------------------

class _FakeClock(object):
    """A clock that moves only when slept on, and a jitter source that
    returns seeded draws: the retry loop's schedule becomes a pure
    function of the policy and the outcomes."""

    def __init__(self, draws):
        self.now = 100.0
        self.sleeps = []
        self._draws = list(draws)

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds

    def random(self):
        return self._draws.pop(0)


#: name -> (policy arguments, the outcomes of the successive attempts)
SCHEDULES = {
    'succeeds_after_two': ({}, ['transient', 'transient', 'ok']),
    'exhausted': ({'max_attempts': 3}, ['transient'] * 5),
    'permanent_not_retried': ({}, ['transient', 'permanent', 'ok']),
    'capped_backoff': ({'max_attempts': 7, 'initial_backoff_s': 1.0, 'multiplier': 3.0,
                        'max_backoff_s': 5.0}, ['transient'] * 6 + ['ok']),
    'no_jitter': ({'jitter': 0.0, 'max_attempts': 5}, ['transient'] * 3 + ['ok']),
    'deadline': ({'max_attempts': 20, 'initial_backoff_s': 1.0, 'multiplier': 1.0,
                  'deadline_s': 3.5}, ['transient'] * 20),
    'first_try': ({}, ['ok']),
}


def _run_schedule(package, monkeypatch, name):
    kwargs, outcomes = SCHEDULES[name]
    retry = PKGS[package].retry
    clock = _FakeClock(np.random.default_rng(5).random(32).tolist())
    monkeypatch.setattr(retry, 'time', clock)
    policy = retry.RetryPolicy(**kwargs)
    if package == 'jax':
        monkeypatch.setattr(retry, 'random', clock)
    else:
        policy._rng = clock
    calls, retries = [], []

    def op():
        outcome = outcomes[len(calls)]
        calls.append(outcome)
        if outcome == 'transient':
            raise OSError(errno.ECONNRESET, 'connection reset by peer')
        if outcome == 'permanent':
            raise FileNotFoundError('no such object')
        return 'ok'

    try:
        result = policy.call(op, on_retry=lambda: retries.append(clock.now))
    except Exception as e:  # noqa: BLE001 - the test compares the outcome
        result = (type(e).__name__, str(e))
    return result, calls, clock.sleeps, retries


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_retry_call_schedule_equals_jax(monkeypatch, name):
    ours = _run_schedule('torch', monkeypatch, name)
    theirs = _run_schedule('jax', monkeypatch, name)
    assert ours == theirs
    result, calls, sleeps, retries = ours
    assert len(sleeps) == len(retries) == len(calls) - 1
    if name == 'exhausted':
        assert result[0] == 'ConnectionResetError' and len(calls) == 3
    if name == 'permanent_not_retried':
        assert result[0] == 'FileNotFoundError' and len(calls) == 2
    if name == 'deadline':
        assert 1 < len(calls) < 20 and sum(sleeps) <= 3.5


@pytest.mark.parametrize('attempt', [1, 2, 3, 6, 12])
def test_backoff_bounds_equal_jax(monkeypatch, attempt):
    for draw in (0.0, 0.5, 0.999):
        values = []
        for package in PACKAGES:
            policy = PKGS[package].retry.RetryPolicy(initial_backoff_s=0.1, max_backoff_s=5.0)
            if package == 'jax':
                monkeypatch.setattr(jax_retry, 'random', SimpleNamespace(random=lambda: draw))
            else:
                policy._rng = SimpleNamespace(random=lambda: draw)
            values.append(policy.backoff_s(attempt))
            monkeypatch.undo()
        assert values[0] == values[1]


def test_retry_policy_identity_and_pickle():
    ours = torch_retry.RetryPolicy(max_attempts=7, initial_backoff_s=0.01)
    same = torch_retry.RetryPolicy(max_attempts=7, initial_backoff_s=0.01)
    # equal policies pickle to equal bytes (a served stream's id hashes its
    # spec) and a pickled policy keeps drawing jitter
    assert pickle.dumps(ours) == pickle.dumps(same)
    restored = pickle.loads(pickle.dumps(ours))
    assert restored == ours and hash(restored) == hash(ours)
    assert 0.0075 <= restored.backoff_s(1) <= 0.0125
    bounded = ours.with_deadline(2.5)
    assert bounded != ours and bounded.deadline_s == 2.5 and ours.deadline_s is None
    assert ours.with_deadline(None) == ours


# -- fetch_range --------------------------------------------------------------------

@pytest.fixture(scope='module')
def blob(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('blob') / 'blob.bin')
    payload = np.random.default_rng(3).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    with open(path, 'wb') as f:
        f.write(payload)
    return path, payload


@pytest.mark.parametrize('offset,length', [(0, 10), (100, 300), (4000, 96), (0, 4096),
                                           (1234, 1)])
def test_fetch_range_windows_equal_jax(blob, offset, length):
    path, payload = blob
    got = [PKGS[p].retry.fetch_range(pafs.LocalFileSystem(), path, offset, length,
                                     policy=_fast(p)) for p in PACKAGES]
    assert got[0] == got[1] == payload[offset:offset + length]


@pytest.mark.parametrize('offset,length', [(4000, 200), (4096, 1), (0, 5000)])
def test_fetch_range_short_reads_are_refused(blob, offset, length):
    path, _ = blob
    messages = []
    for package in PACKAGES:
        with pytest.raises(IOError, match='short read') as info:
            PKGS[package].retry.fetch_range(pafs.LocalFileSystem(), path, offset, length,
                                            policy=_fast(package, max_attempts=2))
        messages.append(str(info.value))
        assert PKGS[package].retry.is_transient_io_error(info.value)
    assert messages[0] == messages[1]


# -- the flaky-filesystem cases of tests/test_retry.py ------------------------------

class _FlakyFile(object):
    """File-like that raises on the first ``fail_reads`` reads (counted
    across reopens), then reads for real."""

    def __init__(self, inner, key, counters, fail_reads, exc_factory):
        self._inner = inner
        self._key = key
        self._counters = counters
        self._fail_reads = fail_reads
        self._exc_factory = exc_factory

    def read(self, nbytes=None):
        n = self._counters.setdefault(self._key, 0)
        if n < self._fail_reads:
            self._counters[self._key] = n + 1
            raise self._exc_factory()
        return self._inner.read(nbytes) if nbytes is not None else self._inner.read()

    def seek(self, offset, whence=0):
        return self._inner.seek(offset, whence)

    def tell(self):
        return self._inner.tell()

    def size(self):
        return self._inner.size()

    @property
    def closed(self):
        return self._inner.closed

    def close(self):
        self._inner.close()


def _flaky_handler_class(package):
    base = PKGS[package].handler

    class FlakyHandler(base):
        """The first ``fail_opens`` input opens and the first ``fail_reads``
        stream reads raise ``exc_factory()``; ``info_failures`` metadata
        calls raise a throttle first."""

        def __init__(self, fs, fail_opens=0, fail_reads=0, info_failures=0,
                     exc_factory=lambda: OSError('connection reset by peer')):
            super(FlakyHandler, self).__init__(fs)
            self.fail_opens = fail_opens
            self.fail_reads = fail_reads
            self.info_failures = info_failures
            self.exc_factory = exc_factory
            self.open_calls = 0
            self.info_calls = 0
            self.read_fail_counters = {}

        def __eq__(self, other):
            return self is other

        def __ne__(self, other):
            return self is not other

        def __hash__(self):
            return id(self)

        def get_type_name(self):
            return 'flaky+' + self.fs.type_name

        def get_file_info(self, paths):
            self.info_calls += 1
            if self.info_calls <= self.info_failures:
                raise OSError('HTTP 429 Too Many Requests')
            return super(FlakyHandler, self).get_file_info(paths)

        def _open(self, path):
            self.open_calls += 1
            if self.open_calls <= self.fail_opens:
                raise self.exc_factory()
            inner = self.fs.open_input_file(path)
            return pa.PythonFile(_FlakyFile(inner, path, self.read_fail_counters,
                                            self.fail_reads, self.exc_factory), mode='r')

        def open_input_stream(self, path):
            return self._open(path)

        def open_input_file(self, path):
            return self._open(path)

    return FlakyHandler


def _flaky_fs(package, **kwargs):
    handler = _flaky_handler_class(package)(pafs.LocalFileSystem(), **kwargs)
    return pafs.PyFileSystem(handler), handler


@pytest.fixture(scope='module')
def parquet_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('flaky') / 'data.parquet')
    table = pa.table({'id': np.arange(500, dtype=np.int64),
                      'payload': np.random.default_rng(1).random(500)})
    pq.write_table(table, path)
    return path, table


def _flaky_case(package, case, parquet_file, tmp_path):
    """One case of ``tests/test_retry.py`` through ``package``'s wrapper:
    what it returned or raised, and the handler's counts."""
    path, expected = parquet_file
    retry = PKGS[package].retry
    fast = _fast(package)
    if case == 'flaky_opens':
        flaky, handler = _flaky_fs(package, fail_opens=2)
        got = pq.ParquetFile(retry.wrap_retrying(flaky, fast).open_input_file(path)).read()
        return got.equals(expected), handler.open_calls
    if case == 'midstream_failures':
        flaky, handler = _flaky_fs(package, fail_reads=2)
        got = pq.ParquetFile(retry.wrap_retrying(flaky, fast).open_input_file(path)).read()
        return got.equals(expected), sorted(handler.read_fail_counters.values())
    if case == 'permanent_error':
        flaky, _ = _flaky_fs(package)
        with pytest.raises(FileNotFoundError):
            retry.wrap_retrying(flaky, fast).open_input_file(str(tmp_path / 'missing'))
        return 'raised'
    if case == 'exhausted':
        flaky, handler = _flaky_fs(package, fail_opens=50)
        with pytest.raises(OSError, match='connection reset'):
            retry.wrap_retrying(flaky, fast).open_input_file(path)
        return handler.open_calls
    if case == 'metadata_retried':
        flaky, handler = _flaky_fs(package, info_failures=2)
        info = retry.wrap_retrying(flaky, fast).get_file_info([path])[0]
        return info.type == pafs.FileType.File, handler.info_calls
    if case == 'fetch_range_transient':
        flaky, handler = _flaky_fs(package, fail_reads=2,
                                   exc_factory=lambda: ConnectionResetError('reset'))
        return (retry.fetch_range(flaky, path, 10, 50, policy=fast)
                == open(path, 'rb').read()[10:60], sorted(handler.read_fail_counters.values()))
    if case == 'mutations_not_retried':
        calls = {'delete': 0, 'move': 0}

        class CountingHandler(PKGS[package].handler):
            def get_type_name(self):
                return 'counting+' + self.fs.type_name

            def delete_file(self, p):
                calls['delete'] += 1
                raise OSError('connection reset by peer')

            def move(self, src, dest):
                calls['move'] += 1
                raise OSError('connection reset by peer')

        fs = retry.wrap_retrying(pafs.PyFileSystem(CountingHandler(pafs.LocalFileSystem())), fast)
        with pytest.raises(OSError):
            fs.delete_file(str(tmp_path / 'x'))
        with pytest.raises(OSError):
            fs.move(str(tmp_path / 'a'), str(tmp_path / 'b'))
        return calls
    if case == 'handler_identity':
        local = pafs.LocalFileSystem()
        a = retry.RetryingHandler(local, fast)
        b = retry.RetryingHandler(local, _fast(package))
        other = retry.RetryingHandler(local, _fast(package, max_attempts=9))
        wrapped = retry.wrap_retrying(local, fast)
        return (a == b, hash(a) == hash(b), len({a, b}), a != other,
                isinstance(hash(PKGS[package].handler(local)), int),
                wrapped.equals(retry.wrap_retrying(local, _fast(package))),
                wrapped.equals(retry.wrap_retrying(local, _fast(package, max_attempts=9))),
                wrapped.type_name)
    if case == 'prebuffered_open':
        from petastorm_tpu.native import open_parquet as jax_open_parquet

        from petastorm_tpu_torch.native import open_parquet
        flaky, _ = _flaky_fs(package, fail_opens=1, fail_reads=1)
        opener = jax_open_parquet if package == 'jax' else open_parquet
        pf = opener(path, filesystem=retry.wrap_retrying(flaky, fast))
        got = pa.concat_tables(pf.read_row_group(i) for i in range(pf.num_row_groups))
        return type(pf).__name__, got.equals(expected)
    raise AssertionError(case)


FLAKY_CASES = ['flaky_opens', 'midstream_failures', 'permanent_error', 'exhausted',
               'metadata_retried', 'fetch_range_transient', 'mutations_not_retried',
               'handler_identity', 'prebuffered_open']


@pytest.mark.parametrize('case', FLAKY_CASES)
def test_flaky_filesystem_cases_equal_jax(case, parquet_file, tmp_path):
    ours = _flaky_case('torch', case, parquet_file, tmp_path)
    theirs = _flaky_case('jax', case, parquet_file, tmp_path)
    assert ours == theirs
    if case in ('flaky_opens', 'metadata_retried'):
        assert ours == (True, 3)
    if case == 'exhausted':
        assert ours == 4
    if case == 'mutations_not_retried':
        assert ours == {'delete': 1, 'move': 1}


# -- resolution of every scheme -------------------------------------------------------

HDFS_SITE = """<?xml version="1.0"?>
<configuration>
  <property><name>dfs.ha.namenodes.nameservice1</name><value>nn1,nn2</value></property>
  <property><name>dfs.namenode.rpc-address.nameservice1.nn1</name><value>host1:8020</value></property>
  <property><name>dfs.namenode.rpc-address.nameservice1.nn2</name><value>host2:8020</value></property>
</configuration>
"""

CORE_SITE = """<?xml version="1.0"?>
<configuration>
  <property><name>fs.defaultFS</name><value>hdfs://nameservice1</value></property>
</configuration>
"""

#: name -> (URL, what the resolver needs patched in: a Hadoop configuration
#: and local namenodes, or pyarrow's own URI resolution)
SCHEMES = {
    'file': ('file:///data/ds', None),
    'mock-remote': ('mock-remote:///data/ds', None),
    's3': ('s3://bucket/data/ds', None),
    'gs': ('gs://bucket/data/ds', None),
    'gcs': ('gcs://bucket/data/ds', None),
    'hdfs-nameservice': ('hdfs://nameservice1/data/ds', 'hadoop'),
    'hdfs-default': ('hdfs:///data/ds', 'hadoop'),
    'hdfs-direct': ('hdfs://some-host:8020/data/ds', 'hadoop'),
    'hdfs-no-config': ('hdfs:///data/ds', 'from_uri'),
}


@pytest.fixture
def fake_stores(monkeypatch, tmp_path):
    """S3 and GCS as local filesystems, namenodes that connect to the local
    filesystem, and pyarrow's URI resolution recorded instead of run: the
    resolvers' ``pafs`` is swapped for one with these in both packages."""
    from_uri = []
    fake_pafs = SimpleNamespace(
        LocalFileSystem=pafs.LocalFileSystem,
        S3FileSystem=lambda *a, **k: pafs.LocalFileSystem(),
        GcsFileSystem=lambda *a, **k: pafs.LocalFileSystem(),
        FileSystem=SimpleNamespace(from_uri=lambda uri: from_uri.append(uri) or
                                   (pafs.LocalFileSystem(), '/from_uri')))
    for fs_module in (jax_fs, torch_fs):
        monkeypatch.setattr(fs_module, 'pafs', fake_pafs)
    for nn in (jax_nn, torch_nn):
        monkeypatch.setattr(nn.HdfsConnector, 'hdfs_connect_namenode',
                            classmethod(lambda cls, address, user=None:
                                        pafs.LocalFileSystem()))
    for name in ('HADOOP_CONF_DIR', 'HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'):
        monkeypatch.delenv(name, raising=False)
    conf = tmp_path / 'hadoop'
    conf.mkdir()
    (conf / 'hdfs-site.xml').write_text(HDFS_SITE)
    (conf / 'core-site.xml').write_text(CORE_SITE)
    return SimpleNamespace(conf_dir=str(conf), from_uri=from_uri, monkeypatch=monkeypatch)


def _resolve(package, name, fake_stores, retry_policy=None):
    url, needs = SCHEMES[name]
    if needs == 'hadoop':
        fake_stores.monkeypatch.setenv('HADOOP_CONF_DIR', fake_stores.conf_dir)
    resolver = PKGS[package].fs.FilesystemResolver(url, retry_policy=retry_policy)
    fs = resolver.filesystem()
    again = PKGS[package].fs.FilesystemResolver(url, retry_policy=retry_policy).filesystem()
    restored = pickle.loads(pickle.dumps(resolver))
    factory = pickle.loads(pickle.dumps(resolver.filesystem_factory()))
    out = {'scheme': resolver.scheme, 'url': resolver.url, 'is_local': resolver.is_local,
           'path': resolver.get_dataset_path(), 'type_name': fs.type_name,
           'equal_to_another': fs.equals(again),
           'pickled': (restored.get_dataset_path(), restored.filesystem().type_name),
           'factory': factory().type_name}
    fake_stores.monkeypatch.delenv('HADOOP_CONF_DIR', raising=False)
    return out


@pytest.mark.parametrize('name', sorted(SCHEMES))
def test_scheme_resolution_equals_jax(name, fake_stores):
    ours = _resolve('torch', name, fake_stores)
    theirs = _resolve('jax', name, fake_stores)
    assert ours == theirs
    assert ours['is_local'] == (name == 'file')
    if name in ('mock-remote', 's3', 'gs', 'gcs'):
        assert ours['type_name'] == 'py::retrying+local'
    if name in ('hdfs-nameservice', 'hdfs-default'):
        assert ours['type_name'] == 'py::ha-hdfs'
    if name == 'hdfs-no-config':
        assert fake_stores.from_uri and set(fake_stores.from_uri) == {SCHEMES[name][0]}
        assert ours['path'] == '/from_uri'


@pytest.mark.parametrize('name', ['mock-remote', 's3', 'gs'])
def test_retry_policy_false_wraps_nothing(name, fake_stores):
    for package in PACKAGES:
        fs = PKGS[package].fs.FilesystemResolver(SCHEMES[name][0], retry_policy=False)
        assert isinstance(fs.filesystem(), pafs.LocalFileSystem)
    policy = torch_retry.RetryPolicy(max_attempts=7, initial_backoff_s=0.01)
    resolver = torch_fs.FilesystemResolver(SCHEMES[name][0], retry_policy=policy)
    factory = pickle.loads(pickle.dumps(resolver.filesystem_factory()))
    assert factory._retry_policy.max_attempts == 7
    assert pickle.loads(pickle.dumps(resolver))._retry_policy == policy


def test_bad_urls_are_refused_alike():
    for url in ('/no/scheme', 'ftp://host/x', 'file://host/x', 'mock-remote://host/x'):
        errors = []
        for package in PACKAGES:
            with pytest.raises(Exception) as info:
                PKGS[package].fs.FilesystemResolver(url)
            errors.append((type(info.value).__name__, str(info.value)))
        assert errors[0] == errors[1]
    assert torch_fs.path_to_url('/a/b') == jax_fs.path_to_url('/a/b') == 'file:///a/b'


# -- the HA namenode client with fake connectors ----------------------------------------

class _MockHdfs(object):
    """Fails its first ``n_failures`` operations, as the reference's mock."""

    def __init__(self, n_failures=0, namenode=None):
        self._n_failures = n_failures
        self.namenode = namenode

    def ls(self, path):
        if self._n_failures > 0:
            self._n_failures -= 1
            raise OSError('namenode is in standby state')
        return ['{}/part-0.parquet'.format(path)]

    def bad_method(self):
        raise ValueError('not an IO error')


def _connector(package, plan):
    """A connector of ``package`` serving ``plan``'s mock filesystems, its
    connect attempts recorded in order."""
    attempts = []

    class MockConnector(PKGS[package].nn.HdfsConnector):
        refuse_next = plan.get('refuse', 0)

        @classmethod
        def hdfs_connect_namenode(cls, address, user=None):
            attempts.append(address)
            if cls.refuse_next > 0:
                cls.refuse_next -= 1
                raise OSError('connection refused: {}'.format(address))
            return plan['fs'][address]

    return MockConnector, attempts


#: name -> (failures of each namenode's filesystem, connections refused
#: first, connections refused after the client is up)
FAILOVERS = {
    'no_failure': ((0, 0), 0, 0),
    'one_failure': ((1, 0), 0, 0),
    'shared_two_failures': ('shared2', 0, 0),
    'budget_exceeded': ((5, 5), 0, 0),
    'first_namenode_down': ((0, 0), 1, 0),
    'ring_down_on_failover': ((5, 5), 0, 10),
}


def _failover(package, name):
    failures, refuse_first, refuse_later = FAILOVERS[name]
    if failures == 'shared2':
        shared = _MockHdfs(2, 'host1:8020')
        fs = {'host1:8020': shared, 'host2:8020': shared}
    else:
        fs = {'host1:8020': _MockHdfs(failures[0], 'host1:8020'),
              'host2:8020': _MockHdfs(failures[1], 'host2:8020')}
    connector, attempts = _connector(package, {'fs': fs, 'refuse': refuse_first})
    client = PKGS[package].nn.HAHdfsClient(connector, ['host1:8020', 'host2:8020'])
    connector.refuse_next = refuse_later
    try:
        result = client.ls('/data')
    except Exception as e:  # noqa: BLE001 - the test compares the outcome
        result = (type(e).__name__, getattr(e, '__name__', None),
                  len(getattr(e, 'failed_exceptions', ())))
    return result, attempts, client.namenode


@pytest.mark.parametrize('name', sorted(FAILOVERS))
def test_ha_failover_sequence_equals_jax(name):
    ours = _failover('torch', name)
    theirs = _failover('jax', name)
    assert ours == theirs
    if name == 'budget_exceeded':
        assert ours[0] == ('MaxFailoversExceeded', 'ls', 3)
    if name == 'ring_down_on_failover':
        assert ours[0][0] == 'HdfsConnectError'


class _MockConnector(torch_nn.HdfsConnector):
    @classmethod
    def hdfs_connect_namenode(cls, address, user=None):
        return _MockHdfs(0, address)


def test_ha_client_surface_and_pyarrow_wrap(tmp_path):
    fs = {'host1:8020': _MockHdfs(0, 'host1:8020'), 'host2:8020': _MockHdfs(0, 'host2:8020')}
    connector, attempts = _connector('torch', {'fs': fs})
    client = torch_nn.HAHdfsClient(connector, ['host1:8020', 'host2:8020'])
    with pytest.raises(ValueError, match='not an IO error'):
        client.bad_method()
    assert attempts == ['host1:8020']
    # a client pickles by its connector's name and reconnects on unpickle
    restored = pickle.loads(pickle.dumps(torch_nn.HAHdfsClient(_MockConnector,
                                                               ['host1:8020'])))
    assert restored.ls('/d') == ['/d/part-0.parquet']
    with pytest.raises(torch_nn.HdfsConnectError):
        torch_nn.HAHdfsClient(connector, [])

    class LocalConnector(torch_nn.HdfsConnector):
        @classmethod
        def hdfs_connect_namenode(cls, address, user=None):
            return pafs.LocalFileSystem()

    wrapped = torch_nn.as_pyarrow_filesystem(
        torch_nn.HAHdfsClient(LocalConnector, ['host1:8020', 'host2:8020']))
    assert isinstance(wrapped, pafs.FileSystem)
    out = str(tmp_path / 'ha_out')
    pq.write_to_dataset(pa.table({'id': np.arange(10)}), out, filesystem=wrapped)
    files = [f.path for f in wrapped.get_file_info(pafs.FileSelector(out, recursive=True))
             if f.type == pafs.FileType.File]
    assert pq.read_table(files[0], filesystem=wrapped)['id'].to_pylist() == list(range(10))


# -- faults --------------------------------------------------------------------------

ROWS, ROWS_PER_GROUP, SIZE = 48, 16, 32


def _write_raw_store(url):
    schema = Unischema('RemoteRaw', [
        UnischemaField('image', np.uint8, (SIZE, SIZE, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    with materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_GROUP,
                             compression='none') as writer:
        for i in range(ROWS):
            writer.write({'image': rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
                          'label': np.int64(i % NUM_CLASSES)})


@pytest.fixture(scope='module')
def raw_store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('remote_raw'))
    _write_raw_store('file://' + path)
    return path


def _rows(reader):
    return sorted((int(r.label), np.asarray(r.image).tobytes()) for r in reader)


@pytest.mark.parametrize('package', PACKAGES)
def test_storage_fault_plan_gives_the_rows_of_file(package, raw_store, tmp_path):
    pkg = PKGS[package]
    with pkg.make_reader('file://' + raw_store, reader_pool_type='dummy') as reader:
        expected = _rows(reader)
    pkg.faults.install(pkg.faults.FaultPlan(storage_fail_first=3))
    try:
        with pkg.make_reader('mock-remote://' + raw_store, reader_pool_type='dummy',
                             storage_retry_policy=_fast(package),
                             chunk_cache=str(tmp_path / 'chunks')) as reader:
            got = _rows(reader)
        fired = (pkg.faults.storage_faults_fired() if package == 'torch'
                 else jax_faults._storage_faults_fired)
    finally:
        pkg.faults.uninstall()
    assert got == expected and len(got) == ROWS
    assert fired == 3


def test_fault_plan_kinds_not_ported_are_refused():
    # every item kind is ported: the plan is the JAX package's, and a one-shot
    # kind without a state_dir is refused as there
    for kwargs in ({'kill_items': (1,)}, {'error_items': (2,), 'error_times': 1},
                   {'segv_items': (3,)}, {'hang_items': (4,)}):
        with pytest.raises(ValueError, match='state_dir'):
            torch_faults.FaultPlan(**kwargs)
        ours = torch_faults.FaultPlan(state_dir='/tmp', **kwargs)
        assert repr(ours) == repr(jax_faults.FaultPlan(state_dir='/tmp', **kwargs))
        assert vars(pickle.loads(pickle.dumps(ours))) == vars(ours)
    plan = torch_faults.FaultPlan(storage_fail_first=2)
    assert repr(plan) == repr(jax_faults.FaultPlan(storage_fail_first=2))
    assert pickle.loads(pickle.dumps(plan)).storage_fail_first == 2
    assert torch_faults.install(plan) is plan and torch_faults.get_plan() is plan
    assert torch_retry.FAULT_POINT is not None
    torch_faults.uninstall()
    assert torch_retry.FAULT_POINT is None and torch_faults.get_plan() is None


# -- resolve_chunk_cache ----------------------------------------------------------------

CACHE_CASES = {
    'none': (None, 'mock-remote:///d', False),
    'false': (False, 'mock-remote:///d', False),
    'local_ignored': ('/tmp/x', 'file:///d', True),
    'explicit': ('/tmp/x', 'mock-remote:///d', False),
    'relative': ('rel/cache', 'mock-remote:///d', False),
}


@pytest.mark.parametrize('name', sorted(CACHE_CASES))
@pytest.mark.parametrize('limit', [None, 1 << 20])
def test_resolve_chunk_cache_equals_jax(name, limit):
    ours = resolve_chunk_cache(*CACHE_CASES[name], size_limit_bytes=limit)
    theirs = jax_resolve_chunk_cache(*CACHE_CASES[name], size_limit_bytes=limit)
    if theirs is None:
        assert ours is None
    else:
        assert (ours.root, ours.size_limit_bytes, ours.prefetch_budget_bytes,
                ours.prefetch_lookahead) == (theirs.root, theirs.size_limit_bytes,
                                             theirs.prefetch_budget_bytes,
                                             theirs.prefetch_lookahead)


def test_auto_chunk_cache_root_is_the_ports_own(tmp_path):
    ours = resolve_chunk_cache('auto', 'mock-remote:///d', False)
    theirs = jax_resolve_chunk_cache('auto', 'mock-remote:///d', False)
    assert os.path.basename(ours.root) == os.path.basename(theirs.root)
    assert os.path.basename(os.path.dirname(ours.root)) == 'pstpu_torch_chunk_cache'
    assert os.path.basename(os.path.dirname(theirs.root)) == 'pstpu_chunk_cache'
    assert ours == resolve_chunk_cache('auto', 'mock-remote:///d', False)
    assert hash(ours) == hash(resolve_chunk_cache('auto', 'mock-remote:///d', False))
    assert ours != resolve_chunk_cache('auto', 'mock-remote:///other', False)
    config = ChunkCacheConfig(str(tmp_path))
    assert resolve_chunk_cache(config, 'mock-remote:///d', False) is config
    with pytest.raises(ValueError, match='chunk_cache must be'):
        resolve_chunk_cache(123, 'mock-remote:///d', False)
    with pytest.raises(ValueError, match='>= 1 byte'):
        config.set_prefetch_budget(0)
    config.set_prefetch_budget(1 << 20)
    assert config.prefetch_budget_bytes == 1 << 20


# -- upcoming_items of the three ventilators ----------------------------------------------

def _concurrent_upcoming(cls, seed, budget):
    sent = []
    done = threading.Event()

    def ventilate(**kwargs):
        sent.append(kwargs['i'])
        if len(sent) == budget:
            done.set()

    vent = cls(ventilate, [{'i': i} for i in range(12)], iterations=2,
               max_ventilation_queue_size=budget, randomize_item_order=seed is not None,
               random_seed=seed)
    before = vent.upcoming_items(5)
    vent.start()
    assert done.wait(10)
    peeks = [vent.upcoming_items(n) for n in (1, 4, 100)]
    vent.stop()
    return before, list(sent), [[item['i'] for item in p] for p in peeks]


@pytest.mark.parametrize('seed,budget', [(None, 2), (3, 1), (11, 4)])
def test_concurrent_ventilator_upcoming_items_equal_jax(seed, budget):
    ours = _concurrent_upcoming(ConcurrentVentilator, seed, budget)
    theirs = _concurrent_upcoming(JaxConcurrentVentilator, seed, budget)
    assert ours == theirs
    before, sent, peeks = ours
    assert before == [] and len(sent) == budget and len(peeks[-1]) == 12 - budget


def _fairshare_upcoming(cls, dispatches):
    fsv = cls(lambda **kw: None)
    fsv.add_tenant('a', [{'i': i} for i in range(6)], iterations=1, weight=2, max_in_flight=100,
                   shuffle=True, seed=4)
    fsv.add_tenant('b', [{'i': 10 + i} for i in range(4)], iterations=2, weight=1,
                   max_in_flight=100, shuffle=False)
    peeks = []
    for _ in range(dispatches):
        with fsv._cv:
            fsv._pick_next()
        peeks.append([item['i'] for item in fsv.upcoming_items(5)])
    return peeks


@pytest.mark.parametrize('dispatches', [1, 5, 12])
def test_fairshare_ventilator_upcoming_items_equal_jax(dispatches):
    ours = _fairshare_upcoming(FairShareVentilator, dispatches)
    assert ours == _fairshare_upcoming(JaxFairShareVentilator, dispatches)
    assert all(len(p) <= 5 for p in ours)


class _FakeCoordinator(object):
    """Enough of an elastic coordinator for the ventilator's feed loop: the
    claimable items are the undone ones in a seeded order."""

    poll_s = 0.01

    def __init__(self, num_items, seed):
        self.num_items = num_items
        self._order = [int(i) for i in np.random.default_rng(seed).permutation(num_items)]
        self._sent = set()

    def start(self):
        pass

    def begin_epoch(self, epoch):
        pass

    def poll(self, epoch=None):
        pass

    def epoch_complete(self, epoch):
        return False

    def claimable_items(self, epoch):
        return [i for i in self._order if i not in self._sent]

    def is_done(self, epoch, item):
        return False

    def note_ventilated(self, epoch, item):
        self._sent.add(item)

    def commit(self, epoch, item):
        pass

    def close(self):
        pass


def _elastic_upcoming(cls, seed):
    sent = []
    first = threading.Event()

    def ventilate(**kwargs):
        sent.append(kwargs['i'])
        first.set()

    vent = cls(ventilate, [{'i': i} for i in range(8)], _FakeCoordinator(8, seed),
               iterations=1, max_ventilation_queue_size=1)
    before = vent.upcoming_items(3)
    vent.start()
    assert first.wait(10)
    # the feed loop polls again, then blocks on the in-flight budget of one
    deadline = time.monotonic() + 10
    while len(vent.upcoming_items(100)) != 7 and time.monotonic() < deadline:
        time.sleep(0.01)
    peeks = [[item['i'] for item in vent.upcoming_items(n)] for n in (2, 100)]
    vent.stop()
    return before, sent, peeks


@pytest.mark.parametrize('seed', [0, 5])
def test_elastic_ventilator_upcoming_items_equal_jax(seed):
    ours = _elastic_upcoming(ElasticVentilator, seed)
    assert ours == _elastic_upcoming(JaxElasticVentilator, seed)
    before, sent, (two, rest) = ours
    assert before == [] and two == rest[:2] and sorted(sent + rest) == list(range(8))


# -- two ResNet steps from a mock-remote store --------------------------------------------

NUM_CLASSES = 5
BATCH = 8
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _jax_losses(url, chunk_cache, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    losses = []
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                         chunk_cache=chunk_cache) as reader:
        batches = iter(jax_prefetch_to_device(
            JaxDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7), size=2))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
        batches.close()
    return losses


def _torch_losses(url, chunk_cache, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses = []
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     chunk_cache=chunk_cache) as reader:
        loader = TorchDataLoader(reader, BATCH, shuffling_queue_capacity=32, seed=7)
        batches = iter(prefetch_to_device(loader, 'cpu', size=2))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(metrics['loss'].item())
        batches.close()
        diag = loader.diagnostics
    return losses, diag


def test_two_train_steps_from_a_mock_remote_store_match_jax(raw_store, tmp_path):
    # the slice test's comparison (tests/test_torch_slice.py), from a
    # mock-remote store through each package's chunk cache (roots apart:
    # the stores' stats files are per process)
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                          num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
        variables = jax.device_get(model.init(jax.random.PRNGKey(1),
                                              jnp.zeros((1, SIZE, SIZE, 3)), train=False))
        variables = {k: dict(v) for k, v in variables.items()}
        url = 'mock-remote://' + raw_store
        expected = _jax_losses(url, str(tmp_path / 'jax_chunks'), variables, steps=2)
        actual, diag = _torch_losses(url, str(tmp_path / 'torch_chunks'), variables, steps=2)
    finally:
        torch.set_num_threads(torch_threads)
    assert all(np.isfinite(actual))
    # 1e-3 covers float32 sums taken in another order through a forward, a
    # backward and one SGD update
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)
    assert actual[0] != actual[1]
    # the loader's diagnostics carry the chunk cache's counters
    assert diag['chunk_cache_misses'] + diag['chunk_cache_prefetch_chunks'] > 0
