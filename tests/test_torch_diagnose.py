"""The port's observability CLIs, held against the JAX package's on the same
files: ``python -m petastorm_tpu_torch.observability.diagnose`` (one-shot,
``--watch``, ``--json``, ``--batch``, ``--pod``, ``--postmortem``,
``--serve``), the pod aggregation (``observability/podagg.py``) and the
offline autotune replay (``python -m petastorm_tpu_torch.autotune.cli``).
The loader stages on the CPU here (``--device cpu``): the CLIs default to
the card.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from petastorm_tpu import observability as jax_obs
from petastorm_tpu.autotune import AutotuneConfig as JaxAutotuneConfig
from petastorm_tpu.autotune.cli import main as jax_autotune_main
from petastorm_tpu.autotune.cli import replay as jax_replay
from petastorm_tpu.autotune.cli import windows_from_trace as jax_windows_from_trace
from petastorm_tpu.observability import history as jax_hist
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.autotune import AutotuneConfig
from petastorm_tpu_torch.autotune.cli import main as autotune_main
from petastorm_tpu_torch.autotune.cli import replay, windows_from_trace
from petastorm_tpu_torch.observability import blackbox, diagnose
from petastorm_tpu_torch.observability import history as hist


@pytest.fixture(scope='module', autouse=True)
def _leave_no_telemetry_state():
    """Restore the telemetry level, disarm what this module armed, clear the
    registries and hold the module to leaving no thread behind."""
    from petastorm_tpu.observability import blackbox as jax_blackbox
    saved = obs.current_config()
    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    obs.configure(saved)
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


# ---------------------------------------------------------------------------
# one-shot, --batch, --watch
# ---------------------------------------------------------------------------

def test_diagnose_cli_smoke(synthetic_dataset, tmp_path, capsys):
    trace = tmp_path / 'diag_trace.json'
    rc = diagnose.main([synthetic_dataset.url, '--batches', '3', '--batch-size', '10',
                        '-p', 'dummy', '-w', '1', '--device', 'cpu',
                        '--trace-out', str(trace), '--prom-out', str(tmp_path / 'm.prom')])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'stall report' in out and 'diagnostics:' in out
    assert json.loads(trace.read_text())['traceEvents'], 'spans level records events'
    assert (tmp_path / 'm.prom').read_text().startswith('# TYPE')


def test_diagnose_json_report_matches_the_jax_keys(synthetic_dataset, capsys):
    rc = diagnose.main([synthetic_dataset.url, '--batches', '3', '--batch-size', '10',
                        '-p', 'dummy', '--device', 'cpu', '--json'])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {'host', 'stall_report', 'fused_fallbacks', 'diagnostics'}
    theirs = jax_obs.stall_report(doc['diagnostics'])
    assert set(doc['stall_report']) == set(theirs)
    assert doc['stall_report']['bottleneck'] == theirs['bottleneck']


def test_diagnose_refuses_the_cpu_unless_asked(synthetic_dataset, monkeypatch):
    """No CUDA and no ``--device cpu``: the CLI raises before reading."""
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        diagnose.diagnose(synthetic_dataset.url, batches=1, pool_type='dummy')


def test_diagnose_batch_cli(synthetic_dataset, capsys):
    rc = diagnose.main([synthetic_dataset.url, '--batches', '3', '--batch-size', '10',
                        '-p', 'thread', '-w', '1', '--device', 'cpu', '--batch', 'slowest'])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'dominant stage' in out and 'critical path:' in out and 'makespan' in out


def test_diagnose_watch_json_ticks_replay_through_autotune(synthetic_dataset, tmp_path,
                                                           capsys):
    """``--watch --json`` is one JSON line per tick, and the same lines are a
    history both packages' autotune replays read to the same decisions."""
    rc = diagnose.main([synthetic_dataset.url, '--watch', '0.3', '--ticks', '2',
                        '--batch-size', '10', '-p', 'dummy', '-w', '1', '--device', 'cpu',
                        '--json'])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [rec['tick'] for rec in lines] == [1, 2]
    for rec in lines:
        assert 'window' in rec and 'fused_fallbacks' in rec and 'host' in rec
        assert rec['window']['window_s'] == pytest.approx(0.3, abs=0.25)
    path = tmp_path / 'watch.jsonl'
    path.write_text(''.join(json.dumps(rec) + '\n' for rec in lines))
    assert autotune_main([str(path), '--workers', '1', '--json']) == \
        jax_autotune_main([str(path), '--workers', '1', '--json'])
    ours, theirs = capsys.readouterr().out.strip().splitlines()
    assert _without_ts(json.loads(ours)) == _without_ts(json.loads(theirs))


def test_diagnose_watch_text(synthetic_dataset, capsys):
    n = diagnose.watch(synthetic_dataset.url, interval_s=0.3, ticks=2, batch_size=10,
                       pool_type='dummy', workers_count=1, device='cpu')
    out = capsys.readouterr().out
    assert n == 2
    assert 'watch tick 1' in out and 'watch tick 2' in out and 'stall report' in out


def test_diagnose_cli_as_a_module(synthetic_dataset):
    """``python -m`` runs it and exits with its return code (no hard exit)."""
    proc = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose',
                           synthetic_dataset.url, '--batches', '2', '--batch-size', '10',
                           '-p', 'dummy', '--device', 'cpu', '--telemetry', 'counters'],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PSTPU_FLIGHT='0'))
    assert proc.returncode == 0, proc.stderr
    assert 'stall report' in proc.stdout
    assert subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose'],
                          capture_output=True, text=True, timeout=60).returncode == 2


def test_diagnose_fabric_waits_for_the_fabric(tmp_path, capsys):
    """``--fabric DIR`` merges the per-peer stats files of both packages'
    clients under ``DIR/fabric/stats/`` (the port's end in ``.torch.json``)
    as the JAX CLI does, and exits 1 on a directory without any."""
    from petastorm_tpu.observability import diagnose as jax_diagnose

    assert diagnose.main(['--fabric', str(tmp_path)]) == 1
    assert 'no fabric stats' in capsys.readouterr().out
    stats_dir = tmp_path / 'fabric' / 'stats'
    stats_dir.mkdir(parents=True)
    (stats_dir / 'hA-pid1.json').write_text(json.dumps({
        'host': 'hA', 'breakers': {'pX': 'half-open'},
        'peers': {'pX': {'hits': 4, 'failures': 1, 'fallbacks': 1, 'bytes': 4096,
                         'latency_sum': 0.2, 'latency_n': 4}}}))
    (stats_dir / 'hA-pid1.torch.json').write_text(json.dumps({
        'host': 'hA', 'breakers': {'pX': 'open', 'pY': 'closed'},
        'peers': {'pX': {'hits': 2, 'failures': 3, 'fallbacks': 3, 'bytes': 2048,
                         'latency_sum': 0.1, 'latency_n': 2},
                  '-': {'fallbacks': 5}}}))
    (stats_dir / 'x.tmp').write_text('{torn')
    table = diagnose.fabric_peer_table(str(tmp_path))
    assert table == jax_diagnose.fabric_peer_table(str(tmp_path))
    assert table['pX']['hits'] == 6 and table['pX']['failures'] == 4
    assert table['pX']['breaker'] == 'open' and table['pX']['bytes'] == 6144
    assert table['pX']['mean_latency_ms'] == pytest.approx(50.0)
    assert table['-']['fallbacks'] == 5 and table['-']['mean_latency_ms'] is None
    assert diagnose.format_fabric_peers(table) == jax_diagnose.format_fabric_peers(table)
    assert diagnose.main(['--fabric', str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith('fabric peers') and 'pX' in out and 'open' in out
    assert diagnose.main(['--fabric', str(tmp_path), '--json']) == 0
    assert json.loads(capsys.readouterr().out)['fabric_peers']['pX']['hits'] == 6


# ---------------------------------------------------------------------------
# --pod: the same report as the JAX package's on the same exports
# ---------------------------------------------------------------------------

def _write_host_series(path, host, points, wait_per_point=0.0):
    """One exporter-style JSONL file: ``points`` is [(ts, rows_emitted)]."""
    ident = obs.host_identity(host)
    with open(path, 'w') as f:
        for i, (ts, rows) in enumerate(points):
            f.write(json.dumps({'ts': ts, 'host': ident,
                                'metrics': {'rows_emitted': rows,
                                            'reader_wait_s': wait_per_point * i}}) + '\n')


POD_CASES = {
    'throughput': [('a', 'host0', [(100.0, 0), (110.0, 10000)], 0.0),
                   ('b', 'host1', [(100.0, 0), (110.0, 9000)], 0.0),
                   ('c', 'host2', [(100.0, 0), (110.0, 2000)], 0.0)],
    'stall': [('a', 'host0', [(100.0, 0), (110.0, 5000)], 0.5),
              ('b', 'host1', [(100.0, 0), (110.0, 5000)], 0.5),
              ('c', 'host2', [(100.0, 0), (110.0, 5000)], 8.0)],
    'balanced': [('h{}'.format(i), 'host{}'.format(i), [(100.0, 0), (110.0, 5000 + 100 * i)],
                  0.0) for i in range(3)],
    'rotated': [('a.jsonl.1', 'host0', [(100.0, 0)], 0.0),
                ('a', 'host0', [(110.0, 10000)], 0.0),
                ('b', 'host1', [(105.0, 500)], 0.0)],
}

POD_STRAGGLER = {'throughput': ('host2', 'throughput'), 'stall': ('host2', 'stall'),
                 'balanced': None, 'rotated': None}


def _pod(tmp_path, case):
    pod = tmp_path / 'pod'
    pod.mkdir()
    for name, host, points, wait in POD_CASES[case]:
        fname = name if name.endswith('.1') else name + '.jsonl'
        _write_host_series(str(pod / fname), host, points, wait)
    return str(pod)


@pytest.mark.parametrize('case', sorted(POD_CASES))
def test_pod_report_equals_jax(tmp_path, case):
    pod = _pod(tmp_path, case)
    ours = obs.pod_report(pod)
    assert ours == jax_obs.pod_report(pod)
    expected = POD_STRAGGLER[case]
    if expected is None:
        assert ours['straggler'] is None
    else:
        assert (ours['straggler']['host'], ours['straggler']['reason']) == expected
        assert 'STRAGGLER {}'.format(expected[0]) in obs.format_pod_report(ours)
    if case == 'throughput':
        assert ours['throughput_skew'] == pytest.approx(0.2)
    if case == 'balanced':
        assert 'no straggler' in obs.format_pod_report(ours)
    if case == 'rotated':
        by_host = {h['host']: h for h in ours['hosts']}
        assert by_host['host0']['rows_per_s'] == pytest.approx(1000.0)
        assert by_host['host1']['rows_per_s'] is None


def test_diagnose_pod_cli(tmp_path, capsys):
    pod = _pod(tmp_path, 'throughput')
    assert diagnose.main(['--pod', pod]) == 0
    out = capsys.readouterr().out
    assert 'host0' in out and 'STRAGGLER host2' in out
    assert diagnose.main(['--pod', pod, '--json']) == 0
    assert json.loads(capsys.readouterr().out)['pod'] == jax_obs.pod_report(pod)
    assert diagnose.main(['--pod', pod, '--watch', '0.01', '--ticks', '2', '--json']) == 0
    ticks = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [t['tick'] for t in ticks] == [1, 2]


def test_pod_report_names_the_slow_reader_process(synthetic_dataset, tmp_path):
    """Two reader processes export JSONL into one directory; the one whose
    reads are slowed is named the straggler."""
    pod = tmp_path / 'pod'
    pod.mkdir()
    code = '\n'.join([
        'import sys, time',
        'from petastorm_tpu_torch import make_reader, observability as obs',
        'from petastorm_tpu_torch.torch import TorchDataLoader',
        'url, path, host, sleep_s = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])',
        'reader = make_reader(url, schema_fields=["id"], reader_pool_type="dummy",',
        '                     output="columnar", num_epochs=4, telemetry="counters")',
        'loader = TorchDataLoader(reader, batch_size=10)',
        # the exporter takes a registry-shaped snapshot: the loader's counts
        'def snapshot():',
        '    return {"counters": {k: v for k, v in loader.diagnostics.items()',
        '                         if isinstance(v, (int, float))}}',
        'with loader:',
        '    with obs.JsonlExporter(path, interval_s=0.1, host_key=host, snapshot_fn=snapshot):',
        '        for batch in loader:',
        '            time.sleep(sleep_s)',
    ])
    procs = [subprocess.Popen([sys.executable, '-c', code, synthetic_dataset.url,
                               str(pod / '{}.jsonl'.format(host)), host, str(sleep_s)],
                              env=dict(os.environ, PSTPU_FLIGHT='0'))
             for host, sleep_s in (('fast', 0.005), ('slow', 0.05))]
    for proc in procs:
        assert proc.wait(timeout=120) == 0
    report = obs.pod_report(str(pod))
    assert report == jax_obs.pod_report(str(pod))
    assert report['straggler'] is not None and report['straggler']['host'] == 'slow'


# ---------------------------------------------------------------------------
# --postmortem and --serve
# ---------------------------------------------------------------------------

def test_diagnose_postmortem_flag(tmp_path, capsys):
    rec = blackbox.FlightRecorder(os.path.join(str(tmp_path), 'flight-d-1-1.torch.bin'),
                                  label='d')
    rec.close()
    assert diagnose.main(['--postmortem', str(tmp_path)]) == 0
    assert 'post-mortem of' in capsys.readouterr().out
    assert diagnose.main(['--postmortem', str(tmp_path / 'none')]) == 1


def test_diagnose_serve_without_a_daemon(tmp_path, capsys):
    assert diagnose.main(['--serve', str(tmp_path)]) == 1
    assert 'no serve daemon endpoint' in capsys.readouterr().out


def test_serve_tenant_table_equals_jax():
    from petastorm_tpu.observability import diagnose as jax_diagnose
    stats = {'evictions': 1, 'streams': {'0123456789abcdef': {
        'dataset_url': 'file:///d', 'fair_share': {'occupancy': 0.5},
        'tenants': {'t0': {'batches_served': 3, 'bytes_served': 2_500_000,
                           'shared_decode_hits': 2, 'weight': 2, 'evicted': True}}}}}
    assert diagnose.serve_tenant_table(stats) == jax_diagnose.serve_tenant_table(stats)
    assert diagnose.format_serve_tenants(stats) == jax_diagnose.format_serve_tenants(stats)
    diag = {'fused_fallback_column:image:compression': 2, 'rows': 1}
    assert diagnose.fused_fallback_table(diag) == jax_diagnose.fused_fallback_table(diag)
    assert diagnose.format_fused_fallbacks(diag) == jax_diagnose.format_fused_fallbacks(diag)


# ---------------------------------------------------------------------------
# the offline autotune replay: the JAX decisions on the same files
# ---------------------------------------------------------------------------

def _without_ts(doc):
    """A replay document less the decisions' wall-clock stamps."""
    return dict(doc, decisions=[{k: v for k, v in d.items() if k != 'ts'}
                                for d in doc['decisions']])


def _write_history(path, windows=6, stage='stage_decode_s'):
    """A stalled run: each 1 s window accumulates 0.9 s of pool wait
    dominated by ``stage``."""
    with open(path, 'w') as f:
        wait = busy = 0.0
        for i in range(windows + 1):
            f.write(json.dumps({'ts': 1000.0 + i, 'diag': {
                'stage_pool_wait_s': wait, stage: busy, 'rows_emitted': i * 100}}) + '\n')
            wait += 0.9
            busy += 0.85


@pytest.mark.parametrize('stage', ['stage_decode_s', 'stage_read_io_s', 'stage_transform_s'])
def test_offline_replay_equals_jax(tmp_path, stage):
    path = str(tmp_path / 'history.jsonl')
    _write_history(path, stage=stage)
    ours = replay(hist.history_windows(hist.load_history(path)),
                  config=AutotuneConfig(interval_s=1.0, cooldown_s=1.0, max_workers=4),
                  workers=1)
    theirs = jax_replay(jax_hist.history_windows(jax_hist.load_history(path)),
                        config=JaxAutotuneConfig(interval_s=1.0, cooldown_s=1.0, max_workers=4),
                        workers=1)
    assert ours[0] == theirs[0]
    assert [{k: v for k, v in d.items() if k != 'ts'} for d in ours[1]] == \
        [{k: v for k, v in d.items() if k != 'ts'} for d in theirs[1]]
    if stage == 'stage_decode_s':
        assert 1 < ours[0]['workers_count'] <= 4
        assert all(d['knob'] == 'workers' for d in ours[1])


def test_offline_cli_json_and_text(tmp_path, capsys):
    path = str(tmp_path / 'history.jsonl')
    _write_history(path)
    args = [path, '--workers', '1', '--interval-s', '1.0', '--json']
    assert autotune_main(args) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_autotune_main(args) == 0
    assert _without_ts(ours) == _without_ts(json.loads(capsys.readouterr().out))
    assert ours['proposal']['workers_count'] > 1 and ours['windows'] == 6
    assert autotune_main(args[:-1]) == 0
    out = capsys.readouterr().out
    assert 'proposed configuration' in out and 'workers_count' in out


def test_offline_cli_trace_replay(tmp_path, capsys):
    events = []
    for second in range(5):
        base = int((1000 + second) * 1e6)
        events.append({'name': 'pool_wait', 'cat': 'pool', 'ph': 'X',
                       'ts': base, 'dur': int(0.9e6), 'pid': 1, 'tid': 1})
        events.append({'name': 'decode', 'cat': 'worker', 'ph': 'X',
                       'ts': base, 'dur': int(0.85e6), 'pid': 1, 'tid': 2})
    trace = tmp_path / 'trace.json'
    trace.write_text(json.dumps({'traceEvents': events}))
    windows = windows_from_trace(str(trace), interval_s=1.0)
    assert windows == jax_windows_from_trace(str(trace), interval_s=1.0)
    assert len(windows) == 5 and windows[0]['wait_proxy'] == 'pool_wait'
    args = ['--trace', str(trace), '--interval-s', '1.0', '--workers', '1', '--json']
    assert autotune_main(args) == 0
    ours = json.loads(capsys.readouterr().out)
    jax_autotune_main(args)
    assert _without_ts(ours) == _without_ts(json.loads(capsys.readouterr().out))
    assert ours['proposal']['workers_count'] > 1


def test_offline_cli_usage_errors(tmp_path):
    with pytest.raises(SystemExit):
        autotune_main([])  # neither a history nor --trace
    empty = tmp_path / 'empty.jsonl'
    empty.write_text('')
    assert autotune_main([str(empty)]) == 1
    proc = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.autotune.cli',
                           str(empty)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
