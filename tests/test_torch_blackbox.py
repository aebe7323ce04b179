"""The port's flight recorder against the JAX package's: one on-disk format
(each package's ``load_flight`` and ``postmortem_report`` read the other's
files, record for record), the ``PSTPU_FLIGHT*`` switches, the activity
slot, the watchdog, the loader's closing stall record, the stale-file sweep
of a shared run directory, and processes that crash, are killed or exit
cleanly mid-read. Intervals stay under a second."""

import os
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu.observability import blackbox as jax_blackbox
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    """A fresh run directory and no recorder in this process; the process's
    recorder is closed again afterwards."""
    blackbox.disable()
    run_dir = str(tmp_path / 'flight')
    monkeypatch.setenv('PSTPU_FLIGHT_DIR', run_dir)
    monkeypatch.delenv('PSTPU_FLIGHT', raising=False)
    yield run_dir
    blackbox.disable()


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('flight_store'))
    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=10) as writer:
        for i in range(40):
            writer.write({'id': np.int64(i)})
    return url


def _write(module, path):
    rec = module.FlightRecorder(path, capacity=4096, label='writer')
    for i in range(200):  # wraps the 4 KiB ring many times
        rec.record(module.K_EVENT, {'i': i, 'pad': 'x' * 8})
    rec.record(module.K_STALL, {'reader_wait_s': 1.5, 'stage_pool_wait_s': 1.0})
    rec.set_activity('worker.decode')
    rec.close()


def _comparable(flight):
    return {k: v for k, v in flight.items() if k != 'path'}


@pytest.mark.parametrize('writer', ['torch', 'jax'])
def test_flight_files_read_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / 'flight-writer-{}-1.bin'.format(os.getpid()))
    _write(blackbox if writer == 'torch' else jax_blackbox, path)
    ours, theirs = blackbox.load_flight(path), jax_blackbox.load_flight(path)
    assert _comparable(ours) == _comparable(theirs)
    assert ours['clean_shutdown'] and ours['torn'] == 0 and ours['label'] == 'writer'
    assert ours['activity'] == 'worker.decode' and ours['pid'] == os.getpid()
    events = [r['data']['i'] for r in ours['records'] if r['kind'] == blackbox.K_EVENT]
    assert events == list(range(events[0], 200)) and events[0] > 0
    assert ours['records'][-1]['data'] == {'event': 'closing'}
    ours_pm = blackbox.postmortem_report(str(tmp_path))
    theirs_pm = jax_blackbox.postmortem_report(str(tmp_path))
    assert ours_pm == theirs_pm and ours_pm['processes'][0]['status'] == 'exited'
    assert ours_pm['processes'][0]['last_stall_report'] == {'reader_wait_s': 1.5,
                                                            'stage_pool_wait_s': 1.0}


def test_torn_tail_and_foreign_files_are_tolerated(tmp_path):
    path = str(tmp_path / 'flight-t-1-1.bin')
    rec = blackbox.FlightRecorder(path, label='torn')
    for i in range(10):
        rec.record(blackbox.K_EVENT, {'i': i})
    start, size = rec._live[-1]
    tail_at = blackbox.HEADER_SIZE + (start + size - 8) % rec.capacity
    rec._mm[tail_at:tail_at + 8] = struct.pack('<Q', 0xDEAD)
    rec._mm.flush()
    for loader in (blackbox.load_flight, jax_blackbox.load_flight):
        flight = loader(path)
        assert flight['torn'] == 1
        assert [r['data']['i'] for r in flight['records']] == list(range(9))
    rec.close()
    assert rec.record(blackbox.K_EVENT, {}) is False
    garbage = str(tmp_path / 'flight-garbage-1-1.bin')
    with open(garbage, 'wb') as f:
        f.write(b'\x00' * 8192)
    with pytest.raises(blackbox.FlightFileError):
        blackbox.load_flight(garbage)
    report = blackbox.postmortem_report(str(tmp_path))
    assert [s['path'] for s in report['skipped']] == [garbage]
    small = blackbox.FlightRecorder(str(tmp_path / 'flight-s-1-1.bin'), capacity=4096)
    assert small.record(blackbox.K_EVENT, {'blob': 'x' * 8192}) is False and small.dropped == 1
    small.close()
    with pytest.raises(ValueError):
        blackbox.FlightRecorder(str(tmp_path / 'x.bin'), capacity=100)


def test_flight_switches(flight_dir, monkeypatch):
    monkeypatch.setenv('PSTPU_FLIGHT', '0')
    assert blackbox.maybe_enable('consumer') is None and blackbox._ACTIVITY is None
    assert not os.path.exists(flight_dir)
    monkeypatch.delenv('PSTPU_FLIGHT')
    saved = obs.current_config()
    try:
        obs.configure('off')
        assert blackbox.maybe_enable('consumer') is None
    finally:
        obs.configure(saved)
    monkeypatch.setenv('PSTPU_FLIGHT_CAPACITY', '8192')
    rec = blackbox.maybe_enable('consumer')
    assert rec is blackbox.maybe_enable('loader') is blackbox.get_recorder()
    assert rec.capacity == 8192 and os.path.dirname(rec.path) == flight_dir
    assert os.path.basename(rec.path).startswith('flight-consumer-{}-'.format(os.getpid()))
    with obs.stage('outer', cat='consumer'):
        with obs.stage('inner', cat='worker'):
            assert blackbox.load_flight(rec.path)['activity'] == 'worker.inner'
        assert rec._activity == 'consumer.outer'
    assert blackbox.load_flight(rec.path)['activity'] == ''


def test_concurrent_enables_arm_one_recorder(flight_dir):
    """Readers started on several threads at once (elastic hosts of one
    process) arm one recorder: no second recorder thread outlives
    ``disable()``."""
    threads_before = set(threading.enumerate())
    barrier = threading.Barrier(8)
    recorders = []

    def arm():
        barrier.wait()
        recorders.append(blackbox.maybe_enable('consumer'))

    callers = [threading.Thread(target=arm) for _ in range(8)]
    for t in callers:
        t.start()
    for t in callers:
        t.join()
    assert len({id(r) for r in recorders}) == 1
    assert recorders[0] is blackbox.get_recorder()
    assert len([f for f in os.listdir(flight_dir) if f.endswith('.bin')]) == 1
    blackbox.disable()
    deadline = time.monotonic() + 10
    while [t for t in threading.enumerate() if t not in threads_before and t.is_alive()]:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_watchdog_dumps_once_per_episode(tmp_path):
    rec = blackbox.FlightRecorder(str(tmp_path / 'flight-wd-1-1.bin'), stall_threshold_s=0.05)
    lock = threading.Lock()
    lock.acquire()
    rec.register_lock('test.lock', lock)
    progress = {'n': 0}
    rec.watch('progress', lambda: progress['n'])
    rec.set_activity('worker.fused_decode')
    now = time.monotonic()
    rec._pump_once(now=now)
    time.sleep(0.1)
    rec._pump_once(now=now + 10)   # stalled: a dump
    rec._pump_once(now=now + 20)   # the same episode: none
    progress['n'] += 1
    rec._pump_once(now=now + 30)   # progress re-arms it
    time.sleep(0.1)
    rec._pump_once(now=now + 50)   # a second episode
    rec.close()
    lock.release()
    dumps = [r['data'] for r in blackbox.load_flight(rec.path)['records']
             if r['kind'] == blackbox.K_WATCHDOG]
    assert len(dumps) == 2
    assert dumps[0]['activity'] == 'worker.fused_decode' and dumps[0]['locks'] == {
        'test.lock': True}
    assert 'test_watchdog_dumps_once_per_episode' in '\n'.join(dumps[0]['threads'].values())


def test_loader_stop_records_its_stall_report(flight_dir, store):
    reader = make_reader(store, reader_pool_type='dummy', output='columnar')
    loader = TorchDataLoader(reader, batch_size=10)
    assert sum(len(b['id']) for b in loader) == 40
    loader.stop()
    loader.join()
    rec = blackbox.get_recorder()
    assert rec is not None and os.path.basename(rec.path).startswith('flight-consumer-')
    stalls = [r['data'] for r in blackbox.load_flight(rec.path)['records']
              if r['kind'] == blackbox.K_STALL]
    assert len(stalls) == 1 and stalls[0]['coverage'] == 1.0
    assert set(stalls[0]) == set(obs.stall_report({}))


def test_the_sweep_keeps_live_files_of_either_package(tmp_path):
    run_dir = str(tmp_path)
    old = time.time() - 7 * 3600
    live = jax_blackbox.FlightRecorder(
        os.path.join(run_dir, 'flight-jax-{}-1.bin'.format(os.getpid())), label='jax')
    dead = subprocess.Popen([sys.executable, '-c', 'pass'])
    dead.wait()
    stale = os.path.join(run_dir, 'flight-gone-{}-1.bin'.format(dead.pid))
    _write(blackbox, stale)
    for path in (live.path, stale):
        os.utime(path, (old, old))
    blackbox._sweep_stale(run_dir)
    assert os.path.exists(live.path) and not os.path.exists(stale)
    live.close()


def test_both_packages_in_one_process_keep_files_of_their_own(flight_dir, monkeypatch):
    """Both packages arm their first recorder of one label in one process
    and one run directory: two files, each intact and readable by the other
    package, not one file truncated under the other's mapping (which made
    the port's next activity write raise SIGBUS)."""
    jax_blackbox.disable()
    # as in a fresh process: each package's first recorder
    monkeypatch.setattr(jax_blackbox, '_ENABLE_COUNT', 0)
    monkeypatch.setattr(blackbox, '_ENABLE_COUNT', 0)
    try:
        jax_rec = jax_blackbox.enable(label='consumer', run_dir=flight_dir)
        rec = blackbox.enable(label='consumer', run_dir=flight_dir)
        assert rec.path != jax_rec.path
        assert os.path.basename(rec.path).startswith('flight-consumer-{}-'.format(os.getpid()))
        for module, recorder in ((blackbox, rec), (jax_blackbox, jax_rec)):
            recorder.set_activity('worker.decode')
            recorder.record(module.K_EVENT, {'who': module.__name__})
        for path in (rec.path, jax_rec.path):
            assert os.path.getsize(path) == blackbox.HEADER_SIZE + rec.capacity
            events = [r['data']['who'] for r in jax_blackbox.load_flight(path)['records']
                      if r['kind'] == jax_blackbox.K_EVENT]
            assert events == [blackbox.__name__ if path == rec.path else jax_blackbox.__name__]
    finally:
        jax_blackbox.disable()


_VICTIM = """\
import os, signal, sys, time
import numpy as np
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.torch import TorchDataLoader

reader = make_reader({url!r}, reader_pool_type='dummy', output='columnar', num_epochs=None)
loader = TorchDataLoader(reader, batch_size=10)
it = iter(loader)
next(it)
print('reading', flush=True)
with obs.stage('doom', cat='worker'):
    {die}
"""


def _victim(run_dir, url, die):
    env = dict(os.environ, PSTPU_FLIGHT_DIR=run_dir, PSTPU_FLIGHT_INTERVAL='0.1',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    env.pop('PSTPU_FLIGHT', None)
    return subprocess.Popen([sys.executable, '-c', _VICTIM.format(url=url, die=die)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_postmortem(run_dir):
    """The JAX package's post-mortem, its windowed stall reports less the
    part of a feature the port lacks: the mixture reader's counts (none)."""
    report = jax_blackbox.postmortem_report(run_dir)
    for proc in report['processes']:
        window = proc.get('window_stall_report')
        if window is not None:
            assert window.pop('mixture') == {}
    return report


def test_a_process_killed_mid_read_is_reported(tmp_path, store):
    runs = {'killed': 'time.sleep(60)', 'crashed': 'os.kill(os.getpid(), signal.SIGTERM)',
            'exited': 'pass'}
    procs = {name: _victim(str(tmp_path / name), store, die) for name, die in runs.items()}
    assert procs['killed'].stdout.readline().strip() == 'reading'
    time.sleep(0.3)  # a snapshot tick or two
    procs['killed'].kill()
    for proc in procs.values():
        proc.wait(timeout=60)
    assert procs['crashed'].returncode == -signal.SIGTERM
    assert procs['exited'].returncode == 0, procs['exited'].stderr.read()[-2000:]
    for name in runs:
        report = blackbox.postmortem_report(str(tmp_path / name))
        (proc,) = report['processes']
        assert proc['status'] == name and proc['label'] == 'consumer'
        assert report == _jax_postmortem(str(tmp_path / name))
        if name == 'killed':
            assert proc['signal'] == 'SIGKILL' and proc['activity'] == 'worker.doom'
            assert 'was killed' in report['probable_cause']
            assert proc['records_total'] >= 2
        elif name == 'crashed':
            assert 'died on SIGTERM mid `worker.doom`' in report['probable_cause']
        else:
            assert 'exited cleanly' in report['probable_cause']
        assert blackbox.format_postmortem(report).startswith('post-mortem of')


def test_progress_reads_create_no_metric(flight_dir, store):
    """The watchdog polls the loader's progress at every level: the poll
    must not create the counter it reads (the JAX loader's does, so a read
    at telemetry 'off' can record one)."""
    saved = obs.current_config()
    rec = blackbox.maybe_enable('consumer')
    try:
        with make_reader(store, reader_pool_type='dummy', output='columnar',
                         telemetry='off') as reader:
            TorchDataLoader(reader, batch_size=10)
            obs.get_registry().reset()
            signature = dict(rec._progress_signature())
        assert signature['loader_batches'] == 0
        assert obs.get_registry().snapshot()['counters'] == {}
    finally:
        obs.configure(saved)
