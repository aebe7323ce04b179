"""The port's autotuner against the JAX package's: the same decision
records (ts left out) for the same scripted evidence windows, the clamp,
cooldowns, oscillation guard and rollback, and the worker knob on the thread
and process pools resized mid-epoch, which deliver the JAX pool's multiset
of rows, each row once per epoch."""

import collections
import json
import time

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import observability as jax_obs
from petastorm_tpu.autotune import controller as jax_controller
from petastorm_tpu_torch import AutotuneConfig, make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.autotune import Autotuner, clamp, controller, resolve_autotune
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
from petastorm_tpu_torch.workers import ProcessPoolOptions

ROWS = 100
ROWS_PER_GROUP = 10


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    saved = obs.current_config()
    obs.get_ring().clear()
    jax_obs.get_ring().clear()
    yield
    obs.configure(saved)
    obs.get_ring().clear()
    jax_obs.get_ring().clear()


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('tune_store'))
    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_GROUP) as writer:
        for i in range(ROWS):
            writer.write({'id': np.int64(i)})
    return url


# -- simulated knobs, the same for both controllers ---------------------------------

class _SimPool(object):
    def __init__(self, workers):
        self.workers_count = workers

    def add_worker_slot(self):
        self.workers_count += 1
        return self.workers_count

    def retire_worker_slot(self):
        if self.workers_count > 1:
            self.workers_count -= 1
        return self.workers_count


class _SimLoader(object):
    def __init__(self, capacity):
        self.shuffle_capacity = capacity

    def set_shuffle_capacity(self, n):
        self.shuffle_capacity = n


class _SimVentilator(object):
    def __init__(self):
        self.sizes = []

    def set_max_queue_size(self, n):
        self.sizes.append(n)


def _stalled(stage='stage_decode_s', wait=0.9, span=1.0, rows_per_s=100.0, **extra):
    win = {'window_s': span, 'reader_wait_s': wait, 'reader_wait_fraction': wait / span,
           'stage_pool_wait_s': wait, 'rows_per_s': rows_per_s, 'wait_proxy': None,
           stage: wait * 0.9}
    win.update(extra)
    return win


def _calm(span=1.0):
    return {'window_s': span, 'reader_wait_s': 0.0, 'reader_wait_fraction': 0.0,
            'stage_pool_wait_s': 0.0, 'rows_per_s': 100.0, 'wait_proxy': None}


def _assembly():
    win = _calm()
    win.update(reader_wait_s=0.9, reader_wait_fraction=0.9)
    return win


def _oscillating():
    script = [(_stalled(), 0.0)]
    now = 0.0
    for _ in range(40):
        now += 10.0
        script.append((_stalled(), now))
        now += 10.0
        script.append((_calm(), now))
    return script


#: name -> (config kwargs, workers, shuffle, [(window, now)]); the JAX
#: controller, like the port's, gets no chunk cache
SCRIPTS = {
    'grow_to_max': ({'max_workers': 3, 'cooldown_s': 1.0}, 1, 0,
                    [(_stalled(), 10.0 * i) for i in range(1, 11)]),
    'read_io_grows_workers': ({'max_workers': 8}, 1, 0,
                              [(_stalled('stage_read_s'), 100.0 * i) for i in range(1, 5)]),
    'shuffle_shrink': ({'min_shuffle_capacity': 4}, 1, 64,
                       [(_assembly(), 50.0 + 100.0 * i) for i in range(12)]),
    'shrink_only_grown': ({'shrink_after_windows': 2, 'cooldown_s': 1.0,
                           'reverse_cooldown_s': 2.0, 'max_workers': 8}, 2, 0,
                          [(_calm(), 10.0 * i) for i in range(1, 11)] + [(_stalled(), 110.0)]
                          + [(_calm(), 200.0 + 100.0 * i) for i in range(4)]),
    'oscillation_guard': ({'cooldown_s': 1.0, 'reverse_cooldown_s': 1.5, 'freeze_s': 1000.0,
                           'shrink_after_windows': 1, 'max_workers': 8}, 1, 0,
                          _oscillating()),
    'rollback_workers': ({'cooldown_s': 1.0, 'freeze_s': 500.0, 'max_workers': 8}, 1, 0,
                         [(_stalled(), 10.0), (_stalled(rows_per_s=30.0), 20.0),
                             (_stalled(), 30.0), (_stalled(), 120.0), (_stalled(), 600.0)]),
    'rollback_shuffle': ({'freeze_s': 500.0}, 1, 64,
                         [(_assembly(), 10.0), (_assembly(), 20.0),
                          (dict(_assembly(), rows_per_s=30.0), 30.0), (_assembly(), 40.0)]),
    'ab_window_holds': ({'cooldown_s': 100.0, 'max_workers': 8}, 1, 0,
                        [(_stalled(), 10.0), (_stalled(), 10.5),
                         (_stalled(rows_per_s=30.0), 11.0)]),
    'rollback_off': ({'rollback': False, 'cooldown_s': 100.0, 'max_workers': 8}, 1, 0,
                     [(_stalled(), 10.0), (_stalled(rows_per_s=30.0), 20.0)]),
}


def _run_script(module, name):
    kwargs, workers, shuffle, script = SCRIPTS[name]
    pool = _SimPool(workers)
    loader = _SimLoader(shuffle) if shuffle else None
    ventilator = _SimVentilator()
    tuner = module.Autotuner(module.AutotuneConfig(interval_s=1.0, **kwargs), pool=pool,
                             ventilator=ventilator, loader=loader)
    returned = [tuner.evaluate(dict(window), now=now) for window, now in script]
    records = [{k: v for k, v in r.items() if k != 'ts'} for r in tuner.decision_records()]
    state = {knob: (s.last_t, s.last_direction, s.reversals, s.frozen_until)
             for knob, s in tuner._knobs.items()}
    return (records, [r is not None for r in returned], tuner.proposal(), ventilator.sizes,
            state)


@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_decisions_match_jax(name):
    ours = _run_script(controller, name)
    assert ours == _run_script(jax_controller, name)
    records, returned, proposal, _, state = ours
    assert records, 'every script moves a knob'
    for record in records:
        assert record['window']['stages'] is not None
    if name == 'grow_to_max':
        assert proposal['workers_count'] == 3 and len(records) == 2
    if name == 'oscillation_guard':
        assert len(records) <= 5 and state['workers'][3] > 0
    if name == 'rollback_workers':
        assert [r['action'] for r in records] == ['grow', 'rollback', 'grow']
        assert records[1]['regression']['kind'] == 'throughput_drop'
    if name == 'shuffle_shrink':
        assert proposal['shuffling_queue_capacity'] == 4
    if name == 'read_io_grows_workers':
        assert [r['action'] for r in records] == ['grow'] * 4
        assert {r['window']['bottleneck'] for r in records} == {'worker.read_io'}
    if name == 'rollback_shuffle':
        assert [(r['knob'], r['action']) for r in records] == [
            ('shuffle_capacity', 'shrink'), ('shuffle_capacity', 'shrink'),
            ('shuffle_capacity', 'rollback')]
        assert proposal['shuffling_queue_capacity'] == 32
    if name == 'shrink_only_grown':
        assert [r['action'] for r in records] == ['grow', 'shrink']


def test_clamp_config_and_decision_log(tmp_path):
    assert clamp(5, 1, 3) == 3 and clamp(0, 1, None) == 1 and clamp(2, None, None) == 2
    assert resolve_autotune(None) is None and resolve_autotune(False) is None
    assert isinstance(resolve_autotune(True), AutotuneConfig)
    config = AutotuneConfig(interval_s=0.5)
    assert resolve_autotune(config) is config
    assert (config.cooldown_s, config.reverse_cooldown_s, config.freeze_s) == (1.0, 3.0, 10.0)
    for kwargs in ({'interval_s': 0}, {'stall_threshold': 0.1, 'low_water': 0.2},
                   {'min_workers': 3, 'max_workers': 2}, {'min_workers': 0},
                   {'rollback_throughput_ratio': 0}, {'shrink_after_windows': 0}):
        with pytest.raises(ValueError):
            AutotuneConfig(**kwargs)
        with pytest.raises(ValueError):
            jax_controller.AutotuneConfig(**kwargs)
    with pytest.raises(ValueError):
        resolve_autotune('yes')
    log = tmp_path / 'decisions.jsonl'
    obs.configure('counters')
    tuner = Autotuner(AutotuneConfig(interval_s=1.0, cooldown_s=1.0, max_workers=8,
                                     decision_log=str(log)), pool=_SimPool(1))
    tuner.evaluate(_stalled(), now=10.0)
    tuner.evaluate(_stalled(rows_per_s=30.0), now=20.0)
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r['action'] for r in lines] == ['grow', 'rollback']
    assert lines == tuner.decision_records()
    # every decision is a span even below the spans level
    events = [e for e in obs.get_ring().snapshot() if e['name'] == 'autotune.decision']
    assert [e['args']['action'] for e in events] == ['grow', 'rollback']


# -- the knobs of the port's pools, loader and ventilator -----------------------------

def _ids(blocks):
    return collections.Counter(int(i) for b in blocks for i in b.id)


def _jax_multiset(url):
    with jax_make_reader(url, reader_pool_type='thread', workers_count=1, output='columnar',
                         num_epochs=2, shuffle_row_groups=False) as reader:
        return _ids(reader)


def test_thread_pool_resized_mid_epoch_matches_jax(store):
    with make_reader(store, reader_pool_type='thread', workers_count=1, output='columnar',
                     num_epochs=2, shuffle_row_groups=False) as reader:
        pool = reader._pool
        it = iter(reader)
        blocks = [next(it)]
        assert pool.add_worker_slot() == 2 and pool.add_worker_slot() == 3
        blocks.append(next(it))
        assert pool.retire_worker_slot() == 2 and pool.retire_worker_slot() == 1
        assert pool.retire_worker_slot() == 1  # never below one
        blocks.extend(it)
        assert reader.diagnostics['workers_count'] == 1
    ids = _ids(blocks)
    assert ids == _jax_multiset(store) and set(ids.values()) == {2}


def test_process_pool_resized_mid_epoch_matches_jax(store):
    with make_reader(store, reader_pool_type=ProcessPoolOptions(results_timeout_s=60), workers_count=1,
                     output='columnar', num_epochs=2, shuffle_row_groups=False) as reader:
        pool = reader._pool
        it = iter(reader)
        blocks = [next(it)]
        assert pool.add_worker_slot() == 2 and pool.add_worker_slot() == 3
        blocks.append(next(it))
        assert pool.retire_worker_slot() == 2
        blocks.extend(it)
        deadline = time.monotonic() + 15
        while pool.workers_alive() > 2 and time.monotonic() < deadline:
            pool._supervise(idle=True)
            time.sleep(0.05)
        diag = reader.diagnostics
        assert pool.workers_alive() == 2 and diag['workers_count'] == 2
        assert diag['worker_restarts'] == 0 and diag['items_quarantined'] == 0
    ids = _ids(blocks)
    assert ids == _jax_multiset(store) and set(ids.values()) == {2}


def test_process_pool_requeues_items_stranded_by_a_retire(store):
    """A retired worker leaves the items in its dispatch pipe unclaimed: the
    dispatch watermarks requeue them while the other workers stay busy."""
    with make_reader(store, reader_pool_type=ProcessPoolOptions(results_timeout_s=60), workers_count=3,
                     output='columnar', num_epochs=3, shuffle_row_groups=False) as reader:
        pool = reader._pool
        it = iter(reader)
        blocks = [next(it)]
        for _ in range(2):
            assert pool.retire_worker_slot() < 3
        blocks.extend(it)
        # a retired worker exits after its current item: the epoch can end
        # before its process is gone
        deadline = time.monotonic() + 15
        while pool.workers_alive() > 1 and time.monotonic() < deadline:
            pool._supervise(idle=True)
            time.sleep(0.05)
        assert pool.workers_alive() == 1
        assert reader.diagnostics['worker_restarts'] == 0
    ids = _ids(blocks)
    assert set(ids) == set(range(ROWS)) and set(ids.values()) == {3}


def test_process_pool_resized_from_another_thread_stays_exact(store):
    """A thread resizes the process pool while the consumer sits in
    get_results, as the autotuner's does: the consumer thread makes every
    spawn, and each row and each read-route count still arrives once per
    epoch."""
    import threading

    from petastorm_tpu_torch import native

    def read(resize):
        native.read_routes.reset()
        with make_reader(store, reader_pool_type=ProcessPoolOptions(results_timeout_s=60), workers_count=1,
                         output='columnar', num_epochs=3, shuffle_row_groups=False) as reader:
            pool, done, spawned = reader._pool, threading.Event(), []
            spawn = pool._spawn_worker

            def spawn_worker(*args):
                spawned.append(threading.current_thread())
                return spawn(*args)
            pool._spawn_worker = spawn_worker

            def wait_for(alive):
                while not done.is_set() and not alive(pool.workers_alive()):
                    time.sleep(0.01)

            def resizer():
                # grow to 3, back to 1, up to 2: each step waits for the
                # consumer to apply the last
                assert pool.add_worker_slot() == 2 and pool.add_worker_slot() == 3
                wait_for(lambda n: n >= 3)
                assert pool.retire_worker_slot() == 2 and pool.retire_worker_slot() == 1
                wait_for(lambda n: n <= 1)
                assert pool.add_worker_slot() == 2
                wait_for(lambda n: n >= 2)

            def slow(reader):
                # the reads outlast the resizes
                for block in reader:
                    if tuner.is_alive():
                        time.sleep(0.2)
                    yield block
            tuner = threading.Thread(target=resizer, daemon=True)
            if resize:
                tuner.start()
            try:
                ids = _ids(slow(reader) if resize else reader)
            finally:
                done.set()
                if resize:
                    tuner.join(timeout=10)
            diag = reader.diagnostics
            assert diag['worker_restarts'] == 0 and diag['items_quarantined'] == 0
        assert not tuner.is_alive()
        assert all(t is threading.main_thread() for t in spawned)
        return ids, len(spawned), native.read_routes.snapshot()

    ids, spawned, routes = read(resize=True)
    assert set(ids) == set(range(ROWS)) and set(ids.values()) == {3}
    assert spawned == 3  # two grown, one grown again
    assert routes == read(resize=False)[2]


def test_ventilator_budget_follows_the_pool():
    sent = []
    vent = ConcurrentVentilator(lambda **kw: sent.append(kw['i']), [{'i': i} for i in range(6)],
                                max_ventilation_queue_size=1)
    vent.start()
    deadline = time.monotonic() + 5
    while len(sent) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert sent == [0]  # the budget holds the rest back
    vent.set_max_queue_size(3)
    deadline = time.monotonic() + 5
    while len(sent) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sent == [0, 1, 2]
    vent.set_max_queue_size(0)  # clamped to 1: nothing is cancelled
    for _ in range(6):
        vent.processed_item()
    vent.stop()


@pytest.mark.parametrize('output', ['rows', 'columnar'])
def test_loader_shuffle_knob(store, output):
    with make_reader(store, reader_pool_type='dummy', output=output, seed=1) as reader:
        loader = TorchDataLoader(reader, batch_size=10, shuffling_queue_capacity=40, seed=2)
        it = iter(loader)
        got = [next(it)]
        assert loader.set_shuffle_capacity(12) == 12 and loader.shuffle_capacity == 12
        got.extend(it)
        with pytest.raises(ValueError, match='>= 2'):
            loader.set_shuffle_capacity(1)
    assert sorted(int(i) for b in got for i in b['id']) == list(range(ROWS))
    with make_reader(store, reader_pool_type='dummy', output=output) as reader:
        with pytest.raises(RuntimeError, match='no shuffling buffer'):
            TorchDataLoader(reader, batch_size=10).set_shuffle_capacity(8)


def test_reader_autotune_attaches_the_loader_and_offers_no_prefetch_knob(store):
    config = AutotuneConfig(interval_s=0.05, max_workers=3)
    with make_reader(store, reader_pool_type='thread', workers_count=1, output='columnar',
                     num_epochs=3, autotune=config) as reader:
        assert reader.autotuner is not None and reader.autotuner.config is config
        loader = TorchDataLoader(reader, batch_size=10, shuffling_queue_capacity=30, seed=1)
        assert reader.autotuner._loader is loader
        assert sum(len(b['id']) for b in loader) == 3 * ROWS
        proposal = reader.autotuner.proposal()
        assert 'prefetch_budget_bytes' not in proposal
        assert set(proposal) == {'workers_count', 'shuffling_queue_capacity'}
        assert 1 <= proposal['workers_count'] <= 3
        assert len(reader.autotuner.history) >= 1
    assert reader.autotuner._thread is None
    with make_reader(store, reader_pool_type='dummy') as reader:
        assert reader.autotuner is None


def test_thread_pool_resized_from_another_thread_stays_exact(store):
    """The autotuner resizes from its own thread while the consumer reads:
    more slots than cores, a short switch interval, and still each row once
    per epoch."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with make_reader(store, reader_pool_type='thread', workers_count=2, output='columnar',
                         num_epochs=3, seed=3) as reader:
            pool, done = reader._pool, threading.Event()

            def resize():
                grow = True
                while not done.is_set():
                    count = pool.add_worker_slot() if grow else pool.retire_worker_slot()
                    grow = count < 12 if grow else count <= 1
            tuner = threading.Thread(target=resize, daemon=True)
            tuner.start()
            try:
                ids = _ids(reader)
            finally:
                done.set()
                tuner.join(timeout=10)
            assert not tuner.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert set(ids) == set(range(ROWS)) and set(ids.values()) == {3}
