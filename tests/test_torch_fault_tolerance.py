"""Worker supervision under injected faults, the port against the JAX package.

The twin of ``tests/test_fault_tolerance.py``: the same chaos matrix (a
worker SIGKILLed or SIGSEGVed mid-item, a poison row group skipped or
raised, a transient error retried, a retry budget exhausted, an item that
fails after it published, a respawn that keeps failing, the recovery
counters), each case run through both packages on the same store and the
same :class:`FaultPlan`, comparing the delivered ids as multisets and the
quarantine records. Every pool here has the protocol conformance monitor
armed (the autouse fixture), so each scenario is also a proof that the
port's pools walk the supervision spec: a stale drop, a requeue or a
completion the spec rejects raises ``ProtocolViolation`` on the spot.
"""

import collections
import os
import re
import threading
import time

import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import faults, make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.errors import (EmptyResultError, PetastormTpuError, PoisonItemError,
                                        TimeoutWaitingForResultError, WorkerPoolDepletedError)
from petastorm_tpu_torch.retry import RetryPolicy
from petastorm_tpu_torch.workers import (DummyPool, ErrorPolicy, ProcessPool, ProcessPoolOptions,
                                         ThreadPool)
from petastorm_tpu_torch.workers.supervision import attach_remote_context

PACKAGES = {'jax': (jax_make_reader, jax_faults), 'torch': (make_reader, faults)}
IN_PROCESS_POOLS = ['thread', 'dummy']


@pytest.fixture(scope='module', autouse=True)
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, and hold the module to leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
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


@pytest.fixture(autouse=True)
def _protocol_monitor_on(monkeypatch):
    """Arm the conformance monitor for every pool of both packages."""
    monkeypatch.setenv('PSTPU_PROTOCOL_MONITOR', '1')


@pytest.fixture
def fault_states(tmp_path):
    """One state dir per package (one-shot faults claim files there), and
    both packages' hooks disarmed afterwards."""
    dirs = {name: tmp_path / name for name in PACKAGES}
    for path in dirs.values():
        path.mkdir()
    yield {name: str(path) for name, path in dirs.items()}
    faults.uninstall()
    jax_faults.uninstall()


def _pool_type(package, pool_type):
    if package == 'torch' and pool_type == 'process':
        return ProcessPoolOptions(results_timeout_s=60)
    return pool_type


def _run(package, url, plan_kwargs, state_dir, pool_type, **reader_kwargs):
    """Read ``url`` through ``package`` with its own FaultPlan installed:
    ``(ids, diagnostics, quarantine records, monitor snapshot)``."""
    factory, module = PACKAGES[package]
    module.install(module.FaultPlan(state_dir=state_dir, **plan_kwargs))
    try:
        with factory(url, schema_fields=['id'], reader_pool_type=_pool_type(package, pool_type),
                     output='columnar', seed=0, **reader_kwargs) as reader:
            ids = [int(x) for batch in reader for x in batch.id]
            snap = reader._pool.protocol_monitor.snapshot
            return ids, reader.diagnostics, reader.quarantined_items, snap
    finally:
        module.uninstall()


def _record_key(record):
    return (record['seq'], record['kind'], record['attempts'], record['error'],
            record['item']['kwargs'].get('piece_index'))


def _both(url, plan_kwargs, states, pool_type, **reader_kwargs):
    return {package: _run(package, url, plan_kwargs, states[package], pool_type,
                          **reader_kwargs)
            for package in PACKAGES}


# ---------------------------------------------------------------------------
# error taxonomy and fault plan mechanics
# ---------------------------------------------------------------------------

def test_worker_errors_root_at_petastorm_tpu_error():
    from petastorm_tpu_torch.errors import ProtocolViolation
    for exc in (EmptyResultError, TimeoutWaitingForResultError, PoisonItemError,
                WorkerPoolDepletedError, ProtocolViolation, faults.FaultInjectedError):
        assert issubclass(exc, PetastormTpuError)


def test_error_policy_validation():
    with pytest.raises(ValueError, match='on_error'):
        ErrorPolicy('explode')
    with pytest.raises(ValueError, match='max_item_retries'):
        ErrorPolicy('skip', -1)
    with pytest.raises(ValueError, match='on_error'):
        make_reader('file:///nonexistent', on_error='explode')


def test_attach_remote_context_preserves_type_and_traceback():
    exc = ValueError('boom')
    out = attach_remote_context(exc, 'Traceback ...worker side...', worker_id=3, seq=7, pid=42)
    assert out is exc and exc.worker_traceback == 'Traceback ...worker side...'
    assert exc.item_seq == 7
    assert 'worker 3 (pid 42)' in str(exc.__cause__)


@pytest.mark.parametrize('kwargs', [{'kill_items': (1,)}, {'error_items': (1,), 'error_times': 2},
                                    {'segv_items': (1,)}, {'hang_items': (1,)}],
                         ids=['kill', 'error_times', 'segv', 'hang'])
def test_fault_plan_one_shot_needs_state_dir(kwargs):
    for module in (faults, jax_faults):
        with pytest.raises(ValueError, match='state_dir'):
            module.FaultPlan(**kwargs)
    assert repr(faults.FaultPlan(state_dir='/x', **kwargs)) == \
        repr(jax_faults.FaultPlan(state_dir='/x', **kwargs))


def test_storage_faults_exercise_retry_backoff(fault_states):
    faults.install(faults.FaultPlan(storage_fail_first=2))
    calls = {'n': 0}

    def op():
        calls['n'] += 1
        return 'ok'

    assert RetryPolicy(max_attempts=4, initial_backoff_s=0.001).call(op) == 'ok'
    assert calls['n'] == 1 and faults.storage_faults_fired() == 2
    faults.uninstall()
    from petastorm_tpu_torch import retry
    assert retry.FAULT_POINT is None


@pytest.mark.parametrize('kind', ['kill', 'segv'])
def test_kill_and_segv_degrade_to_errors_outside_a_spawned_worker(fault_states, kind):
    """Outside a spawned worker a signal would kill the caller: both
    packages raise the same error instead, every time when not one-shot."""
    messages = []
    for module, state in ((faults, fault_states['torch']), (jax_faults, fault_states['jax'])):
        module.install(module.FaultPlan(state_dir=state, **{
            kind + '_items': (5,), kind + '_once': False}))
        for _ in range(2):
            with pytest.raises(module.FaultInjectedError, match='degraded to an error') as info:
                module.on_item({'piece_index': 5})
            messages.append(str(info.value))
        module.on_item({'piece_index': 4})   # another piece passes
        module.on_item({})                   # an item with no piece passes
        module.uninstall()
    assert len(set(messages)) == 1


def test_error_times_fire_once_per_shot_across_calls(fault_states):
    faults.install(faults.FaultPlan(error_items=(2,), error_times=2,
                                    state_dir=fault_states['torch']))
    for shot in (1, 2):
        with pytest.raises(faults.FaultInjectedError,
                           match='transient error {}/2 on piece_index=2'.format(shot)):
            faults.on_item({'piece_index': 2})
    faults.on_item({'piece_index': 2})  # the budget is spent: the item passes


def test_hang_sleeps_inside_its_stage(fault_states):
    obs.get_registry().reset()
    faults.install(faults.FaultPlan(hang_items=(3,), hang_s=0.2,
                                    state_dir=fault_states['torch']))
    t0 = time.monotonic()
    faults.on_item({'piece_index': 3})
    assert time.monotonic() - t0 >= 0.2
    t0 = time.monotonic()
    faults.on_item({'piece_index': 3})  # one-shot: the second call passes at once
    assert time.monotonic() - t0 < 0.2
    counters = obs.snapshot()['counters']
    assert counters['stage_fault_hang_count'] == 1 and counters['stage_fault_hang_s'] >= 0.2


# ---------------------------------------------------------------------------
# THE chaos cases: SIGKILL and SIGSEGV mid-item, exactly-once epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['kill', 'segv'])
def test_signal_mid_item_epoch_completes_exactly_once(synthetic_dataset, fault_states, kind):
    runs = _both(synthetic_dataset.url, {kind + '_items': (3,)}, fault_states, 'process',
                 workers_count=2)
    for package, (ids, diag, records, snap) in runs.items():
        counts = collections.Counter(ids)
        assert len(ids) == 100 and set(counts.values()) == {1}, package
        assert diag['worker_restarts'] == 1 and diag['items_requeued'] >= 1, package
        assert diag['items_quarantined'] == 0 and records == []
        assert diag['items_ventilated'] == diag['items_completed'] == 10
        assert diag['items_in_flight'] == 0
        assert snap['ventilated'] == snap['completed'] == 10 and snap['in_flight'] == []
    assert collections.Counter(runs['torch'][0]) == collections.Counter(runs['jax'][0])


def test_three_faults_in_one_epoch_like_the_smoke(synthetic_dataset, fault_states):
    """The smoke's ``raw_chaos`` plan: a kill, a segfault and a transient
    error on three row groups of one epoch, under ``on_error='retry'``."""
    plan = {'kill_items': (1,), 'segv_items': (5,), 'error_items': (8,), 'error_times': 1}
    runs = _both(synthetic_dataset.url, plan, fault_states, 'process', workers_count=2,
                 on_error='retry')
    for package, (ids, diag, records, snap) in runs.items():
        assert sorted(ids) == list(range(100)), package
        assert diag['worker_restarts'] == 2 and diag['items_requeued'] >= 3, package
        assert diag['items_quarantined'] == 0 and records == []
        assert snap['completed'] == 10 and snap['in_flight'] == []


# ---------------------------------------------------------------------------
# the policy matrix, alike on every pool and in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pool_type', IN_PROCESS_POOLS + ['process'])
def test_poison_skip_completes_epoch(synthetic_dataset, fault_states, pool_type):
    runs = _both(synthetic_dataset.url, {'error_items': (2,)}, fault_states, pool_type,
                 workers_count=1 if pool_type == 'process' else 2, on_error='skip',
                 max_item_retries=1)
    for package, (ids, diag, records, snap) in runs.items():
        assert len(ids) == 90 and len(set(ids)) == 90, package
        record, = records
        assert record['kind'] == 'error' and record['attempts'] == 2
        assert 'FaultInjectedError' in record['error']
        assert 'injected poison' in record['traceback']
        assert diag['items_quarantined'] == 1 and diag['items_requeued'] == 1
        assert diag['items_ventilated'] == diag['items_completed'] == 10
        assert snap['completed'] == 10 and snap['in_flight'] == []
    assert collections.Counter(runs['torch'][0]) == collections.Counter(runs['jax'][0])
    assert [_record_key(r) for r in runs['torch'][2]] == [_record_key(r) for r in runs['jax'][2]]


@pytest.mark.parametrize('pool_type', IN_PROCESS_POOLS + ['process'])
def test_poison_raise_surfaces_traceback(synthetic_dataset, fault_states, pool_type):
    errors = {}
    for package, (factory, module) in PACKAGES.items():
        module.install(module.FaultPlan(error_items=(2,), state_dir=fault_states[package]))
        try:
            with factory(synthetic_dataset.url, schema_fields=['id'],
                         reader_pool_type=_pool_type(package, pool_type), workers_count=2,
                         output='columnar', seed=0, on_error='raise') as reader:
                with pytest.raises(module.FaultInjectedError) as info:
                    for _ in reader:
                        pass
            errors[package] = info.value
        finally:
            module.uninstall()
    for package, exc in errors.items():
        assert 'injected poison' in exc.worker_traceback, package
        assert exc.item_seq is not None
        if pool_type == 'process':
            assert 'worker-side traceback' in str(exc.__cause__)
    assert str(errors['torch']) == str(errors['jax'])
    assert errors['torch'].item_seq == errors['jax'].item_seq


@pytest.mark.parametrize('pool_type', IN_PROCESS_POOLS + ['process'])
def test_transient_error_retry_recovers_full_epoch(synthetic_dataset, fault_states, pool_type):
    runs = _both(synthetic_dataset.url, {'error_items': (4,), 'error_times': 1}, fault_states,
                 pool_type, workers_count=2, on_error='retry', max_item_retries=2)
    for package, (ids, diag, records, snap) in runs.items():
        assert sorted(ids) == list(range(100)), package
        assert diag['items_requeued'] == 1 and diag['items_quarantined'] == 0
        assert snap['ventilated'] == snap['completed'] == 10


def test_retry_budget_exhaustion_raises(synthetic_dataset, fault_states):
    for package, (factory, module) in PACKAGES.items():
        module.install(module.FaultPlan(error_items=(4,), state_dir=fault_states[package]))
        try:
            with factory(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='thread',
                         workers_count=1, output='columnar', seed=0, on_error='retry',
                         max_item_retries=1) as reader:
                with pytest.raises(module.FaultInjectedError, match='injected poison'):
                    for _ in reader:
                        pass
                assert reader.diagnostics['items_requeued'] == 1
        finally:
            module.uninstall()


def test_hang_fault_delays_but_delivers(synthetic_dataset, fault_states):
    runs = _both(synthetic_dataset.url, {'hang_items': (6,), 'hang_s': 0.3}, fault_states,
                 'thread', workers_count=2)
    for package, (ids, diag, records, snap) in runs.items():
        assert sorted(ids) == list(range(100)), package
        assert diag['items_requeued'] == 0


# ---------------------------------------------------------------------------
# an item that publishes and then errors completes delivered, never re-runs
# ---------------------------------------------------------------------------

def _drain_pool(pool, **kwargs):
    got = []
    while True:
        try:
            got.append(pool.get_results(**kwargs))
        except EmptyResultError:
            return got


@pytest.mark.parametrize('on_error', ['retry', 'skip'])
def test_publish_then_error_delivers_exactly_once_process_pool(tmp_path, on_error):
    from petastorm_tpu_torch.test_util.stub_workers import PublishThenErrorWorker
    pool = ProcessPool(2, on_error=on_error, max_item_retries=2)
    pool.start(PublishThenErrorWorker, {'fail_on': (2,), 'state_dir': str(tmp_path)})
    try:
        for i in range(6):
            pool.ventilate(i)
        got = _drain_pool(pool, timeout_s=60)
    finally:
        pool.stop()
        pool.join()
    counts = collections.Counter(got)
    assert sorted(counts) == list(range(6)) and set(counts.values()) == {1}
    diag = pool.diagnostics
    assert diag['items_requeued'] == 0 and diag['items_quarantined'] == 0
    assert diag['items_ventilated'] == diag['items_completed'] == 6
    assert pool.protocol_monitor.snapshot['completed'] == 6


@pytest.mark.parametrize('pool_factory', [
    lambda: ThreadPool(2, on_error='retry', max_item_retries=2),
    lambda: DummyPool(on_error='retry', max_item_retries=2),
], ids=['thread', 'dummy'])
def test_publish_then_error_delivers_exactly_once_in_process(tmp_path, pool_factory):
    from petastorm_tpu_torch.test_util.stub_workers import PublishThenErrorWorker
    pool = pool_factory()
    pool.start(PublishThenErrorWorker, {'fail_on': (1, 3), 'state_dir': str(tmp_path)})
    for i in range(5):
        pool.ventilate(i)
    got = _drain_pool(pool)
    pool.stop()
    pool.join()
    counts = collections.Counter(got)
    assert sorted(counts) == list(range(5)) and set(counts.values()) == {1}
    assert pool.diagnostics['items_requeued'] == 0
    assert pool.protocol_monitor.snapshot['completed'] == 5


def test_publish_then_error_raise_policy_still_raises(tmp_path):
    from petastorm_tpu_torch.test_util.stub_workers import PublishThenErrorWorker
    pool = ThreadPool(1, on_error='raise')
    pool.start(PublishThenErrorWorker, {'fail_on': (0,), 'state_dir': str(tmp_path)})
    pool.ventilate(0)
    with pytest.raises(ValueError, match='post-publish failure'):
        _drain_pool(pool)
    pool.stop()
    pool.join()


# ---------------------------------------------------------------------------
# a respawn that keeps failing sheds the slot; a shed pool fails
# ---------------------------------------------------------------------------

def test_respawn_failure_sheds_slot_and_depletes_pool():
    from petastorm_tpu_torch.test_util.stub_workers import HardExitWorker
    pool = ProcessPool(1)
    pool.start(HardExitWorker, {'crash_on': 1})
    try:
        pool.ventilate(0)
        assert pool.get_results(timeout_s=60) == [0]

        def broken_spawn(worker_id, ring_name):
            raise OSError('simulated: fork/exec failed')

        pool._spawn_worker = broken_spawn
        pool.ventilate(1)  # kills the only worker; its respawn now fails
        with pytest.raises(WorkerPoolDepletedError, match='respawn kept failing'):
            while True:
                pool.get_results(timeout_s=60)
        assert pool._all_slots_shed()
    finally:
        pool.stop()
        pool.join()


# ---------------------------------------------------------------------------
# the fault plan reaches spawned workers; recovery shows in the counters
# ---------------------------------------------------------------------------

def test_storage_fault_plan_reaches_process_workers(synthetic_dataset, fault_states, capfd):
    """``FaultPlan(storage_fail_first=2)`` fires in every spawned worker of
    both packages: the same rows, the same restart and requeue counts, and
    the same number of injected storage faults merged over the consumer and
    the workers (each spawned worker logs its retries to the shared stderr;
    the consumer's count is read in process)."""
    url = 'mock-remote://' + synthetic_dataset.url[len('file://'):]
    fired, rows, counts = {}, {}, {}
    for package, (factory, module) in PACKAGES.items():
        policy_module = __import__('petastorm_tpu_torch.retry' if package == 'torch'
                                   else 'petastorm_tpu.retry', fromlist=['RetryPolicy'])
        policy = policy_module.RetryPolicy(max_attempts=4, initial_backoff_s=0.001,
                                           max_backoff_s=0.002)
        capfd.readouterr()
        module.install(module.FaultPlan(storage_fail_first=2))
        try:
            with factory(url, schema_fields=['id'], reader_pool_type=_pool_type(package,
                                                                                'process'),
                         workers_count=2, output='columnar', seed=0,
                         storage_retry_policy=policy) as reader:
                rows[package] = collections.Counter(int(x) for b in reader for x in b.id)
                diag = reader.diagnostics
                workers = len([p for p in reader._pool._processes if p is not None])
            consumer = (module.storage_faults_fired() if package == 'torch'
                        else module._storage_faults_fired)
        finally:
            module.uninstall()
        err = capfd.readouterr().err
        in_workers = len(re.findall(r'injected transient storage fault \d/2', err))
        fired[package] = consumer + in_workers
        counts[package] = (diag['worker_restarts'], diag['items_requeued'],
                           diag['items_quarantined'])
        assert consumer == 2 and in_workers == 2 * workers, (package, consumer, in_workers)
    assert rows['torch'] == rows['jax'] and sorted(rows['torch']) == list(range(100))
    assert fired['torch'] == fired['jax']
    assert counts['torch'] == counts['jax'] == (0, 0, 0)


def test_recovery_counters_and_stall_report(synthetic_dataset, fault_states):
    obs.get_registry().reset()
    ids, diag, records, _snap = _run('torch', synthetic_dataset.url, {'error_items': (2,)},
                                     fault_states['torch'], 'thread', workers_count=1,
                                     telemetry='counters', on_error='skip', max_item_retries=0)
    report = obs.stall_report(dict(diag, reader_wait_s=1.0))
    assert report['recovery']['items_quarantined'] == 1
    text = obs.format_stall_report(report)
    assert 'recovery events' in text and '1 quarantined' in text


def test_heartbeat_age_gauge_updates(synthetic_dataset):
    obs.get_registry().reset()
    with make_reader(synthetic_dataset.url, schema_fields=['id'],
                     reader_pool_type=ProcessPoolOptions(results_timeout_s=60),
                     workers_count=1, output='columnar', seed=0,
                     telemetry='counters') as reader:
        assert sum(len(b.id) for b in reader) == 100
        diag = reader.diagnostics
        assert 0 <= diag['heartbeat_age_s'] < 60


def test_thread_pool_retry_accounting_exact():
    from petastorm_tpu_torch.test_util.stub_workers import ExceptionEveryNWorker
    pool = ThreadPool(1, on_error='skip', max_item_retries=1)
    pool.start(ExceptionEveryNWorker, worker_setup_args=5)
    for i in [1, 2, 5, 3]:
        pool.ventilate(i)
    assert sorted(_drain_pool(pool)) == [1, 2, 3]
    diag = pool.diagnostics
    assert diag['items_ventilated'] == diag['items_completed'] == 4
    assert diag['items_requeued'] == 1 and diag['items_quarantined'] == 1
    pool.stop()
    pool.join()


def test_dummy_pool_skip_does_not_stop_epoch():
    from petastorm_tpu_torch.test_util.stub_workers import ExceptionEveryNWorker
    pool = DummyPool(on_error='skip', max_item_retries=0)
    pool.start(ExceptionEveryNWorker, worker_setup_args=2)
    for i in [1, 2, 3, 4, 5]:
        pool.ventilate(i)
    assert sorted(_drain_pool(pool)) == [1, 3, 5]
    assert pool.diagnostics['items_quarantined'] == 2
    assert pool.diagnostics['items_completed'] == 5
    assert pool.protocol_monitor.snapshot['completed'] == 5
    pool.stop()
    pool.join()


def test_quarantine_records_carry_the_ventilated_seq(synthetic_dataset, tmp_path):
    """A record names the item by the ventilator's seq (the checkpoint's
    identity), not by a dispatch id, in every pool and in both packages."""
    keys = {}
    for pool_type in IN_PROCESS_POOLS:
        states = {}
        for package in PACKAGES:
            states[package] = str(tmp_path / pool_type / package)
            os.makedirs(states[package])
        runs = _both(synthetic_dataset.url, {'error_items': (7,)}, states, pool_type,
                     workers_count=2, on_error='skip', max_item_retries=0)
        keys[pool_type] = [_record_key(r) for r in runs['torch'][2]]
        assert keys[pool_type] == [_record_key(r) for r in runs['jax'][2]]
    assert keys['thread'] == keys['dummy']
    assert [k[4] for k in keys['thread']] == [7]
