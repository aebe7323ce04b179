"""Telemetry of the port against the JAX package: the metrics registry and
its merge and flatten, the stall report, span trees and critical paths,
Prometheus text, history windows and regressions, the span multiset of a
read of one store by both readers, and the diagnostics key sets. Every
comparison with the JAX package is exact; timestamps and durations are left
out of the equalities."""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import observability as jax_obs
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.observability import history as jax_history
from petastorm_tpu.observability import metrics as jax_metrics
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.observability import history
from petastorm_tpu_torch.observability.metrics import MetricsRegistry
from petastorm_tpu_torch.observability.trace import TraceRing
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.workers import ProcessPoolOptions


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


ROWS = 60
ROWS_PER_GROUP = 10


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    """Telemetry is process-wide in both packages: save and restore the
    levels, and clear the registries and rings around every test."""
    saved, jax_saved = obs.current_config(), jax_obs.current_config()
    for package in (obs, jax_obs):
        package.get_registry().reset()
        package.get_ring().clear()
    yield
    obs.configure(saved)
    jax_obs.configure(jax_saved)
    for package in (obs, jax_obs):
        package.get_registry().reset()
        package.get_ring().clear()


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """ids (fused), a string label (Arrow) and an ndarray feature (codec)."""
    url = 'file://' + str(tmp_path_factory.mktemp('obs_store'))
    schema = JaxUnischema('ObsSchema', [
        JaxUnischemaField('id', np.int64, (), JaxScalarCodec(), False),
        JaxUnischemaField('label', np.str_, (), JaxScalarCodec(str), False),
        JaxUnischemaField('feature', np.float32, (4,), JaxNdarrayCodec(), False)])
    rng = np.random.default_rng(5)
    with jax_materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_GROUP) as writer:
        for i in range(ROWS):
            writer.write({'id': np.int64(i), 'label': 'c{}'.format(i % 7),
                          'feature': rng.standard_normal(4).astype(np.float32)})
    return url


# -- the registry ---------------------------------------------------------------

def _fill(registry):
    registry.counter('rows').inc(3)
    registry.counter('rows').inc()
    registry.counter('wait_s').add(0.25)
    registry.gauge('occupancy').set(7)
    for v in (0.0005, 0.02, 0.3, 7.0):
        registry.histogram('lat').observe(v)
    registry.histogram('custom', buckets=(1.0, 2.0)).observe(1.5)
    registry.stage_timer('decode').record(0.5)
    registry.stage_timer('decode').record(0.25)


def test_registry_snapshot_merge_and_flatten_match_jax():
    ours, theirs = MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(ours)
    _fill(theirs)
    snap, jax_snap = ours.snapshot(), theirs.snapshot()
    assert snap == jax_snap
    assert snap['counters']['stage_decode_s'] == 0.75
    assert snap['counters']['stage_decode_count'] == 2
    assert snap['histograms']['lat']['counts'] == [1, 0, 0, 1, 0, 1, 0, 0, 1]
    other = MetricsRegistry()
    other.counter('rows').inc(10)
    other.gauge('occupancy').set(1)
    other.histogram('custom', buckets=(1.0, 2.0)).observe(0.5)
    other.histogram('lat', buckets=(5.0,)).observe(1.0)  # other bounds: replaces
    inputs = [snap, other.snapshot(), 'not a snapshot', jax_snap]
    merged = obs.merge_snapshots(inputs)
    assert merged == jax_metrics.merge_snapshots(inputs)
    assert merged['counters']['rows'] == 18 and merged['gauges']['occupancy'] == 15
    assert obs.flatten_snapshot(merged) == jax_metrics.flatten_snapshot(merged)
    with pytest.raises(TypeError, match='already registered'):
        ours.gauge('rows')


def test_telemetry_levels_and_config():
    assert obs.TelemetryConfig() == obs.resolve_telemetry('counters')
    assert obs.resolve_telemetry(None) is None
    for bad in ('verbose', 3):
        with pytest.raises(ValueError):
            obs.resolve_telemetry(bad)
    with pytest.raises(ValueError):
        obs.TelemetryConfig(trace_capacity=0)
    assert obs.configure(obs.TelemetryConfig('spans', trace_capacity=32)).trace_capacity == 32
    assert obs.spans_on() and obs.counters_on()
    obs.configure('off')
    obs.count('nothing')
    with obs.stage('nothing'):
        pass
    assert obs.snapshot()['counters'] == {} and not obs.counters_on()
    obs.configure('counters')
    with obs.span('only_at_spans'):
        pass
    assert len(obs.get_ring()) == 0


def test_trace_ring_is_bounded_and_ships():
    ring = TraceRing(capacity=4)
    for i in range(10):
        ring.add({'i': i})
    assert len(ring) == 4 and ring.dropped == 6
    assert [e['i'] for e in ring.drain()] == [6, 7, 8, 9] and len(ring) == 0
    ring.extend([{'i': i} for i in range(6)])
    assert len(ring) == 4 and ring.capacity == 4
    ring.set_capacity(2)
    assert [e['i'] for e in ring.snapshot()] == [4, 5]


# -- the stall report -------------------------------------------------------------

STALL_DIAGNOSTICS = [
    {},
    {'reader_wait_s': 1.0, 'reader_wait_fraction': 0.5, 'stage_pool_wait_s': 0.8,
     'stage_read_s': 0.1, 'stage_decode_s': 0.7, 'stage_transform_s': 0.0},
    {'reader_wait_s': 2.0, 'stage_pool_wait_s': 1.5, 'stage_read_s': 0.3,
     'stage_fused_decode_s': 2.0, 'stage_collate_s': 0.25,
     'worker_restarts': 2, 'items_requeued': 3, 'watchdog_stall_total': 1},
    {'reader_wait_s': 0.5, 'stage_pool_wait_s': 0.5},
    {'reader_wait_s': 0.3, 'stage_pool_wait_s': 0.9, 'stage_fused_predicate_s': 0.2,
     'items_quarantined': 1},
    # a cold chunk cache: the mirror fetches nest in the read stage
    {'reader_wait_s': 1.5, 'stage_pool_wait_s': 1.2, 'stage_read_s': 0.9,
     'stage_chunk_fetch_s': 0.7, 'stage_decode_s': 0.1},
    # a two-source mixture, one source dry: its counts ride along
    {'reader_wait_s': 0.4, 'stage_pool_wait_s': 0.3, 'stage_read_s': 0.2,
     'mixture_source_0_rows': 70, 'mixture_source_0_tokens': 700,
     'mixture_source_0_exhausted': 0, 'mixture_source_1_rows': 30,
     'mixture_source_1_tokens': 0, 'mixture_source_1_exhausted': 1},
]


@pytest.mark.parametrize('diag', STALL_DIAGNOSTICS)
def test_stall_report_matches_jax(diag):
    report = obs.stall_report(diag)
    assert report == jax_obs.stall_report(diag)
    assert obs.decode_collate_share(diag) == jax_obs.decode_collate_share(diag)
    assert obs.format_stall_report(report).splitlines()[0] == \
        jax_obs.format_stall_report(report).splitlines()[0]
    mixture_lines = [line for line in obs.format_stall_report(report).splitlines()
                     if 'mixture sources' in line or line.startswith('    source ')]
    assert mixture_lines == [line for line in jax_obs.format_stall_report(report).splitlines()
                             if 'mixture sources' in line or line.startswith('    source ')]
    assert len(mixture_lines) == (3 if report['mixture'] else 0)
    if diag.get('reader_wait_s'):
        assert report['coverage'] == 1.0 and report['bottleneck'] is not None


# -- spans and critical paths ------------------------------------------------------

def _read_traced(url, package):
    """A dummy-pool read of the store at the spans level: the loader's
    collate and a synchronous prefetch's staging link to each batch."""
    if package == 'jax':
        import jax
        reader = jax_make_reader(url, reader_pool_type='dummy', seed=1, telemetry='spans')
        with reader:
            loader = JaxDataLoader(reader, batch_size=ROWS_PER_GROUP, drop_last=False)
            from petastorm_tpu.jax import prefetch_to_device as jax_prefetch
            batches = list(jax_prefetch(loader, jax.devices('cpu')[0], size=1,
                                        background=False))
        return batches, jax_obs.get_ring().snapshot()
    reader = make_reader(url, reader_pool_type='dummy', seed=1, telemetry='spans')
    with reader:
        loader = TorchDataLoader(reader, batch_size=ROWS_PER_GROUP, drop_last=False)
        batches = list(prefetch_to_device(loader, 'cpu', size=1, background=False))
    return batches, obs.get_ring().snapshot()


def _span_multiset(events):
    """(name, cat, args without ids, parent's name) of every event; parents
    are '<root>' (the item's virtual root) or None (no trace)."""
    names = {e['args']['span']: e['name'] for e in events if 'span' in e.get('args', {})}
    out = collections.Counter()
    for e in events:
        args = dict(e.get('args') or {})
        parent = args.pop('parent', None)
        trace = args.pop('trace', None)
        args.pop('span', None)
        parent_name = None if trace is None else ('<root>' if parent == trace
                                                  else names.get(parent, '<lost>'))
        out[(e['name'], e['cat'], tuple(sorted(args.items())), parent_name)] += 1
    return out


def test_span_multisets_of_one_read_match_jax(store):
    batches, events = _read_traced(store, 'torch')
    jax_batches, jax_events = _read_traced(store, 'jax')
    assert len(batches) == len(jax_batches) == ROWS // ROWS_PER_GROUP
    for b, jb in zip(batches, jax_batches):
        np.testing.assert_array_equal(b['id'].numpy(), np.asarray(jb['id']))
    ours = _span_multiset(events)
    # the CPU infeed's copy stage, under each batch's infeed, and the
    # hand-over are the port's own (a synchronous prefetch has no queue
    # waits, the CPU no pinned memory)
    assert {key[0] for key in ours} & PORT_ONLY_STAGES == {'infeed_copy', 'prefetch_hand_over'}
    assert {key[3] for key in ours if key[0] == 'infeed_copy'} == {'infeed'}
    ours = collections.Counter({key: n for key, n in ours.items()
                                if key[0] not in PORT_ONLY_STAGES})
    assert ours == _span_multiset(jax_events)
    names = {key[0] for key in ours}
    assert {'ventilate', 'pool_wait', 'read', 'decode', 'fused_decode', 'collate',
            'infeed'} <= names
    # every item's tree links the dispatch to the staging
    for tid in obs.traces_in(events):
        tree = obs.span_tree(events, tid)
        tree_names = {tree['name']}
        stack = list(tree['children'])
        while stack:
            node = stack.pop()
            tree_names.add(node['name'])
            stack.extend(node['children'])
        assert {'ventilate', 'read', 'decode'} <= tree_names, tree_names
    assert sum('infeed' in {n['name'] for n in obs.span_tree(events, t)['children']}
               for t in obs.traces_in(events)) == len(batches)


def test_span_tree_and_critical_path_match_jax(store):
    _, events = _read_traced(store, 'torch')
    for tid in list(obs.traces_in(events))[:3]:
        tree = obs.span_tree(events, tid)
        assert tree == jax_obs.span_tree(events, tid)
        path = obs.critical_path(tree)
        assert path == jax_obs.critical_path(tree)
        assert sum(seg['dur_us'] for seg in path) == tree['dur']
        assert obs.stage_breakdown(tree) == jax_obs.stage_breakdown(tree)
    rows = obs.slowest_batches(events, top=3)
    assert rows == jax_obs.slowest_batches(events, top=3)
    assert obs.span_tree(events, 'no-such-trace') is None


def test_chrome_trace_export(store, tmp_path):
    _, events = _read_traced(store, 'torch')
    path = str(tmp_path / 'trace.json')
    assert obs.export_chrome_trace(path) == len(events)
    with open(path) as f:
        doc = json.load(f)
    assert doc == jax_obs.chrome_trace(events) and doc['displayTimeUnit'] == 'ms'
    for event in doc['traceEvents']:
        assert event['ph'] == 'X' and event['pid'] == os.getpid()
        assert {'name', 'cat', 'ts', 'dur', 'tid'} <= set(event)


# -- exporters and history ---------------------------------------------------------

def test_prometheus_text_matches_jax(tmp_path):
    registry = MetricsRegistry()
    _fill(registry)
    # the port's stages also count their CPU seconds: one more counter
    registry.stage_timer('collate').record(0.5, 0.125)
    snap = registry.snapshot()
    assert snap['counters']['stage_collate_cpu_s'] == 0.125
    assert _port_only_keys(snap['counters']) == {'stage_collate_cpu_s'}
    text = obs.to_prometheus_text(snap)
    assert text == jax_obs.to_prometheus_text(snap)
    assert 'pstpu_lat_bucket{le="+Inf"} 4' in text and '# TYPE pstpu_rows counter' in text
    assert 'pstpu_stage_collate_cpu_s 0.125' in text
    assert obs.to_prometheus_text(snap, prefix='x_') == jax_obs.to_prometheus_text(
        snap, prefix='x_')
    obs.write_prometheus(str(tmp_path / 'm.prom'), snap)
    assert (tmp_path / 'm.prom').read_text() == text


def test_jsonl_exporter_lines(tmp_path):
    obs.get_registry().counter('rows_total').inc(7)
    with obs.stage('collate'):
        pass
    path = tmp_path / 'metrics.jsonl'
    with obs.JsonlExporter(str(path), interval_s=0.05, host_key='h0'):
        time.sleep(0.12)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) >= 2
    for rec in lines:
        assert rec['metrics']['rows_total'] == 7 and rec['host']['host'] == 'h0'
        assert rec['metrics']['stage_collate_count'] == 1
        assert _port_only_keys(rec['metrics']) == {'stage_collate_cpu_s'}
        assert set(rec['host']) == set(jax_obs.host_identity('h0'))
    # the JAX package's history loader reads the port's export
    assert [s['diag'] for s in jax_history.load_history(str(path))] == \
        [r['metrics'] for r in lines]


def _snapshots():
    return [
        {'ts': 100.0, 'diag': {'rows_emitted': 0, 'reader_wait_s': 0.0,
                               'stage_pool_wait_s': 0.0, 'stage_decode_s': 0.0,
                               'workers_count': 2, 'shuffle_buffer_occupancy': 10}},
        {'ts': 101.0, 'diag': {'rows_emitted': 1000, 'reader_wait_s': 0.1,
                               'stage_pool_wait_s': 0.1, 'stage_decode_s': 0.5,
                               'workers_count': 2, 'shuffle_buffer_occupancy': 12}},
        {'ts': 102.5, 'diag': {'rows_emitted': 1400, 'reader_wait_s': 0.9,
                               'stage_pool_wait_s': 0.85, 'stage_decode_s': 1.5,
                               'stage_read_s': 0.4, 'workers_count': 3,
                               'shuffle_buffer_occupancy': 4, 'transport': 'shm'}},
        {'ts': 103.0, 'diag': {'stage_pool_wait_s': 1.2, 'stage_decode_s': 1.7}},
    ]


def test_history_windows_and_regressions_match_jax(tmp_path):
    snaps = _snapshots()
    windows = history.history_windows(snaps)
    assert windows == jax_history.history_windows(snaps)
    assert windows[0]['rows_per_s'] == 1000.0 and windows[2]['wait_proxy'] == 'pool_wait'
    for a, b in zip(windows, windows[1:]):
        assert history.detect_regression(a, b) == jax_history.detect_regression(a, b)
    assert history.detect_regression(windows[0], windows[1])['kind'] == 'throughput_drop'
    assert history.detect_regression(None, windows[0]) is None
    for w in windows:
        assert history.windowed_stall_report(w) == \
            jax_history.windowed_stall_report(w)
    # a recorder over the scripted diagnostics: windows, save, and a load by
    # either package
    feed = iter([s['diag'] for s in snaps])
    recorder = history.HistoryRecorder(lambda: next(feed), interval_s=0.5, capacity=3)
    for _ in snaps:
        recorder.record_now()
    assert len(recorder) == 3 and recorder.window_last() is not None
    assert recorder.regression() == history.detect_regression(
        *[history.window_delta(a, b) for a, b in zip(recorder.snapshots(),
                                                     recorder.snapshots()[1:])])
    path = str(tmp_path / 'history.jsonl')
    assert recorder.save(path) == 3
    assert history.load_history(path) == jax_history.load_history(path) == recorder.snapshots()
    with pytest.raises(ValueError):
        history.HistoryRecorder(dict, capacity=1)


# -- the diagnostics surfaces --------------------------------------------------------

#: process pool keys of the JAX diagnostics the port lacks, by name: none
#: since both idle waits count the consumer's spins (``ring_idle_spins``)
JAX_ONLY_KEYS = {}
#: process pool keys only the port reports, by name: its transport, ring
#: size and publishes per channel
PORT_ONLY_KEYS = {'process': {'transport', 'ring_bytes', 'publish_inplace', 'publish_ring',
                              'publish_blob', 'publish_zmq'}}
#: stages only the port times: the loader's shuffle (a span only, in the
#: JAX package), the infeed's per-array split, the prefetch queue's waits and
#: hand-over, and the graphed step's dispatch
PORT_ONLY_STAGES = {'shuffle.add_block', 'shuffle.emit', 'infeed_alloc', 'infeed_copy',
                    'infeed_enqueue', 'prefetch_put_wait', 'prefetch_get_wait',
                    'prefetch_hand_over', 'train_step', 'train_step_replay'}
#: counters only the port keeps
PORT_ONLY_COUNTERS = {'infeed_bytes_total'}


def _port_only_keys(keys):
    """The port's own diagnostics keys among ``keys``: its stages' timers,
    its counters, and every stage's CPU seconds (``stage_<name>_cpu_s``)."""
    stages = {'stage_{}_{}'.format(name, part) for name in PORT_ONLY_STAGES
              for part in ('s', 'count', 'cpu_s')}
    return {k for k in keys if k in stages or k in PORT_ONLY_COUNTERS
            or (k.startswith('stage_') and k.endswith('_cpu_s'))}


def _reader_keys(keys):
    """Leave out the JAX serve plane's ``serve_*`` counters: the registry is
    process-wide, and a serve thread left by an earlier test in the process
    can bump them during the read."""
    return {k for k in keys if not k.startswith('serve_')}


def _drained_diagnostics(url, package, pool):
    if package == 'jax':
        reader = jax_make_reader(url, reader_pool_type=pool, workers_count=2, seed=1,
                                 output='columnar', telemetry='counters')
        cls = JaxDataLoader
    else:
        reader = make_reader(url, reader_pool_type=pool, workers_count=2, seed=1,
                             output='columnar', telemetry='counters')
        cls = TorchDataLoader
    with reader:
        loader = cls(reader, batch_size=20, drop_last=False)
        before = _reader_keys(loader.diagnostics)
        rows = sum(len(b['id']) for b in loader)
        diag = loader.diagnostics
        return (rows, before, {k: v for k, v in diag.items() if k in _reader_keys(diag)},
                _reader_keys(reader.diagnostics))


@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
def test_diagnostics_key_sets_match_jax(store, pool):
    rows, before, diag, reader_keys = _drained_diagnostics(store, 'torch', pool)
    for package in (obs, jax_obs):
        package.get_registry().reset()
    jax_rows, jax_before, jax_diag, jax_reader_keys = _drained_diagnostics(store, 'jax', pool)
    assert rows == jax_rows == ROWS
    port_only, jax_only = PORT_ONLY_KEYS.get(pool, set()), JAX_ONLY_KEYS.get(pool, set())
    port_only = port_only | _port_only_keys(set(diag) | reader_keys)
    assert port_only <= set(diag) and jax_only <= set(jax_diag)
    assert set(diag) - port_only == set(jax_diag) - jax_only
    assert reader_keys - port_only == jax_reader_keys - jax_only
    # the port's own: the shuffle's stages, and every stage's CPU seconds
    assert {'stage_shuffle.add_block_count', 'stage_shuffle.emit_count',
            'stage_shuffle.emit_cpu_s'} <= set(diag)
    assert diag['stage_shuffle.emit_count'] == diag['stage_collate_count']
    for key in diag:
        if key.startswith('stage_') and key.endswith('_count'):
            assert key[:-len('count')] + 'cpu_s' in diag, key
    # the loader's keys are there before the first batch
    loader_keys = {'rows_emitted', 'reader_wait_s', 'reader_wait_fraction',
                   'padding_waste_fraction'}
    assert loader_keys <= before and loader_keys <= jax_before
    for key in ('worker_rows_decoded_total', 'loader_batches_total', 'stage_ventilate_count',
                'items_completed', 'rows_emitted', 'stage_collate_count'):
        assert diag[key] == jax_diag[key], key
    assert diag['stage_pool_wait_s'] > 0 and diag['reader_wait_s'] > 0
    report = obs.stall_report(diag)
    assert report['coverage'] == 1.0
    assert report == jax_obs.stall_report(diag)
    assert set(report) == set(jax_obs.stall_report(jax_diag))


def test_telemetry_off_records_nothing(store):
    with make_reader(store, reader_pool_type='thread', workers_count=1, output='columnar',
                     telemetry='off') as reader:
        loader = TorchDataLoader(reader, batch_size=20, drop_last=False)
        assert sum(len(b['id']) for b in loader) == ROWS
        diag = loader.diagnostics
    snap = obs.get_registry().snapshot()
    assert snap['counters'] == {} and snap['gauges'] == {} and len(obs.get_ring()) == 0
    assert diag['rows_emitted'] == ROWS and obs.stall_report(diag)['bottleneck'] is not None


def test_counters_stay_at_block_granularity(store, monkeypatch):
    calls = {obs: collections.Counter(), jax_obs: collections.Counter()}

    def counting(package, name, fn):
        def wrapper(*args, **kwargs):
            calls[package][name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for package in calls:
        for name in ('stage', 'span', 'count', 'gauge_set', 'observe'):
            monkeypatch.setattr(package, name, counting(package, name, getattr(package, name)))
    for factory, cls in ((make_reader, TorchDataLoader), (jax_make_reader, JaxDataLoader)):
        with factory(store, reader_pool_type='dummy', output='columnar',
                     telemetry='counters') as reader:
            loader = cls(reader, batch_size=20, drop_last=False)
            assert sum(len(b['id']) for b in loader) == ROWS
    # 6 blocks and 3 batches: the JAX package's block-granular budget; one
    # per-row call site would add 60 on its own
    ours, theirs = sum(calls[obs].values()), sum(calls[jax_obs].values())
    assert ours <= theirs < ROWS * 2, (calls[obs], calls[jax_obs])


def test_process_pool_ships_worker_telemetry(store):
    with make_reader(store, reader_pool_type=ProcessPoolOptions(results_timeout_s=60), workers_count=2,
                     output='columnar', telemetry='spans') as reader:
        loader = TorchDataLoader(reader, batch_size=20, drop_last=False)
        assert sum(len(b['id']) for b in loader) == ROWS
        diag = loader.diagnostics
        snapshots = reader._pool.telemetry_snapshots()
    # counted only inside the workers: they arrive in the merged snapshots
    assert diag['worker_rows_decoded_total'] == ROWS
    assert obs.get_registry().snapshot()['counters'].get('worker_rows_decoded_total') is None
    assert sum(s['counters']['worker_rows_decoded_total'] for s in snapshots) == ROWS
    assert diag['stage_item_count'] == ROWS // ROWS_PER_GROUP
    events = obs.get_ring().snapshot()
    worker_pids = {e['pid'] for e in events if e['name'] == 'item'}
    assert len(worker_pids) >= 1 and os.getpid() not in worker_pids
    # the workers' spans join the trees minted in this process
    trees = [obs.span_tree(events, t) for t in obs.traces_in(events)]
    assert any(len({n['pid'] for n in t['children']} | {
        c['pid'] for n in t['children'] for c in n['children']}) >= 2 for t in trees)
    assert obs.stall_report(diag)['coverage'] == 1.0


# -- the prefetch thread's budget and the graphed step's dispatch ----------------------

def _prefetched_diagnostics(url, telemetry):
    """A thread-pool read through a background prefetch onto the CPU: the
    loader's diagnostics after the last batch, and the batches."""
    with make_reader(url, reader_pool_type='thread', workers_count=2, seed=1,
                     output='columnar', telemetry=telemetry) as reader:
        loader = TorchDataLoader(reader, batch_size=20, drop_last=False)
        batches = list(prefetch_to_device(loader, 'cpu', size=2, background=True))
        return loader.diagnostics, batches


def test_prefetch_thread_stages_reach_the_loader_diagnostics(store):
    diag, batches = _prefetched_diagnostics(store, 'counters')
    assert sum(len(b['id']) for b in batches) == ROWS
    n = len(batches)
    arrays = sum(isinstance(v, torch.Tensor) for v in batches[0].values())
    assert arrays >= 2  # ids and features; the string labels stay numpy
    expected = {'shuffle.add_block': ROWS // ROWS_PER_GROUP, 'shuffle.emit': n, 'collate': n,
                'infeed': n, 'infeed_copy': n * arrays,
                # the end of the stream is put and got too
                'prefetch_put_wait': n + 1, 'prefetch_get_wait': n + 1,
                'prefetch_hand_over': n}
    for name, count in expected.items():
        assert diag['stage_{}_count'.format(name)] == count, name
        assert diag['stage_{}_s'.format(name)] >= 0.0
        assert 0.0 <= diag['stage_{}_cpu_s'.format(name)]
    # the CPU path has no pinned memory: nothing to allocate or enqueue
    assert 'stage_infeed_alloc_count' not in diag and 'stage_infeed_enqueue_count' not in diag
    assert diag['infeed_bytes_total'] >= 0
    # the infeed's copies nest in it
    assert diag['stage_infeed_copy_s'] <= diag['stage_infeed_s']


def test_telemetry_off_records_nothing_through_the_prefetch_thread(store):
    diag, batches = _prefetched_diagnostics(store, 'off')
    assert sum(len(b['id']) for b in batches) == ROWS
    snap = obs.get_registry().snapshot()
    assert snap['counters'] == {} and snap['gauges'] == {} and len(obs.get_ring()) == 0
    assert not {k for k in diag if k.startswith('stage_') or k == 'infeed_bytes_total'}


def test_stage_cpu_seconds_tell_a_busy_loop_from_a_sleep():
    with obs.stage('busy'):
        deadline = time.perf_counter() + 0.1
        while time.perf_counter() < deadline:
            pass
    with obs.stage('nap'):
        time.sleep(0.1)
    counters = obs.snapshot()['counters']
    busy, busy_cpu = counters['stage_busy_s'], counters['stage_busy_cpu_s']
    nap, nap_cpu = counters['stage_nap_s'], counters['stage_nap_cpu_s']
    assert busy >= 0.1 and nap >= 0.1
    # a host shared with other work may take the spinning thread off its
    # core for a while, and a sandboxed host may count CPU time in 10 ms
    # ticks; a sleeping thread spends next to nothing
    assert 0.5 * busy <= busy_cpu <= busy + 0.011
    assert nap_cpu <= 0.011


def _profiled_block(anchor, tmp_path):
    """A CPU ``torch.profiler`` trace of one ``record_function`` region with
    a ring span over the same block on this thread: the profiler's file as a
    dict and the ring's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    obs.configure('spans')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('warm-up'):  # the session's first range opens slowly
            pass
        if anchor:
            obs.clock_anchor()
        with record_function('block'):
            with obs.span('block', cat='test'):
                time.sleep(0.02)
    path = str(tmp_path / 'profiler.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f), obs.get_ring().snapshot()


@pytest.mark.parametrize('clock', ['baseTimeNanoseconds', 'anchor'])
def test_ring_spans_merge_onto_the_profiler_clock(clock, tmp_path):
    doc, events = _profiled_block(clock == 'anchor', tmp_path)
    if clock == 'anchor':
        doc.pop('baseTimeNanoseconds', None)
    ring_ts = [e['ts'] for e in events]
    merged = obs.merge_profiler_trace(doc)
    assert merged['programEvents']['clock'] == clock
    assert merged['programEvents']['count'] == len(events)
    # the ring and the profiler's document are left as they were
    assert [e['ts'] for e in obs.get_ring().snapshot()] == ring_ts
    assert 'programEvents' not in doc
    moved = merged['traceEvents'][-len(events):]
    theirs = next(e for e in doc['traceEvents']
                  if e.get('name') == 'block' and e.get('cat') == 'user_annotation')
    ours = next(e for e in moved if e['name'] == 'block')
    # the ring's span opens just inside the range and closes just before it
    assert abs(ours['ts'] - theirs['ts']) < 1000
    assert abs((ours['ts'] + ours['dur']) - (theirs['ts'] + theirs['dur'])) < 1000
    names = {e['tid']: e['args']['name'] for e in merged['traceEvents']
             if e.get('ph') == 'M' and e.get('name') == 'thread_name' and e['tid'] == ours['tid']}
    assert names == {ours['tid']: threading.current_thread().name}
    # the same document, written by the exporter from the profiler's file
    prof_path, out = str(tmp_path / 'prof.json'), str(tmp_path / 'merged.json')
    with open(prof_path, 'w') as f:
        json.dump(doc, f)
    assert obs.export_chrome_trace(out, profiler_trace=prof_path) == len(merged['traceEvents'])
    with open(out) as f:
        assert json.load(f) == merged


def test_a_profiler_trace_without_a_clock_is_refused(tmp_path):
    doc, events = _profiled_block(False, tmp_path)
    doc.pop('baseTimeNanoseconds', None)
    with pytest.raises(ValueError, match='clock_anchor'):
        obs.merge_profiler_trace(doc, events)
