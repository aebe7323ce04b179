"""Port parity: the reader throughput tool of petastorm_tpu_torch against the
JAX package's ``petastorm_tpu/tools/throughput.py``.

The same store (the suite's 100-row ``synthetic_dataset``, 10 rows per row
group, written by the JAX package) is read by both tools with the same
arguments: the port's ``'python'``, ``'columnar'`` and ``'torch'`` methods
against the JAX ``'python'``, ``'columnar'`` and ``'jax'``, the port staging
on the CPU (``device='cpu'``). Rates are noise, so the tests compare what is
not: the samples counted, the keys of ``extra``, whether a stall fraction
is reported and that it is a fraction, the printed line's format, and the
process statistics against psutil. Every reader is stopped by the tool
itself; the module leaves no flight recorder, telemetry state or thread
behind."""

import json
import re
import threading
import time

import psutil
import pytest

from petastorm_tpu import observability as jax_obs
from petastorm_tpu.tools import throughput as jax_throughput
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.tools import throughput

#: the port's read methods beside the JAX tool's
METHODS = [('python', 'python'), ('columnar', 'columnar'), ('torch', 'jax')]

#: the line ``BenchmarkResult.__str__`` prints in both packages
LINE = re.compile(r'^\d+\.\d{2} samples/sec; \d+\.\d{2} MB RSS; \d+\.\d{2}% CPU'
                  r'(; \d+\.\d{2}% input stall)?$')


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
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
    # every reader was closed: none of their threads is left running
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


@pytest.fixture
def _restore_telemetry():
    """``--trace-out`` sets both packages' process-wide level to spans."""
    saved = (jax_obs.current_config(), obs.current_config())
    yield
    jax_obs.configure(saved[0])
    obs.configure(saved[1])


def _kwargs(pool):
    return dict(field_regex=['id', 'matrix'], warmup_cycles=16, measure_cycles=64,
                pool_type=pool, workers_count=2, batch_size=16)


#: every method on both pools, but the JAX ``'jax'`` method on the dummy pool
#: only: on a thread pool the JAX tool stops the reader before its
#: prefetcher, whose pump then waits in the stopped reader for good (the
#: port's tool closes the prefetcher first; its thread-pool run is below)
CASES = [(method, jax_method, pool) for method, jax_method in METHODS
         for pool in ('dummy', 'thread') if (jax_method, pool) != ('jax', 'thread')]


@pytest.mark.parametrize('method,jax_method,pool', CASES)
def test_reader_throughput_matches_jax(synthetic_dataset, method, jax_method, pool):
    ours = throughput.reader_throughput(synthetic_dataset.url, read_method=method,
                                        device='cpu', **_kwargs(pool))
    theirs = jax_throughput.reader_throughput(synthetic_dataset.url, read_method=jax_method,
                                              **_kwargs(pool))
    assert ours.samples == theirs.samples == 64
    assert set(ours.extra) == set(theirs.extra)
    assert (ours.input_stall_fraction is None) == (theirs.input_stall_fraction is None)
    if ours.input_stall_fraction is not None:
        assert 0.0 <= ours.input_stall_fraction <= 1.0
    assert ours.memory_rss_mb > 0 and theirs.memory_rss_mb > 0
    assert ours.samples_per_second > 0 and ours.duration_s > 0
    if method != 'python':
        report = ours.extra['stall_report']
        assert set(report) == set(theirs.extra['stall_report'])
    assert LINE.match(str(ours)) and LINE.match(str(theirs))


def _output_lines(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize('method,jax_method', METHODS)
def test_main_prints_the_jax_lines(synthetic_dataset, capsys, method, jax_method):
    argv = [synthetic_dataset.url, '-f', 'id', '-m', '8', '-n', '32', '-p', 'dummy', '-w', '1',
            '--batch-size', '8']
    ours = _output_lines(capsys, throughput.main, argv + ['-d', method, '--device', 'cpu'])
    theirs = _output_lines(capsys, jax_throughput.main, argv + ['-d', jax_method])
    assert LINE.match(ours[0]) and LINE.match(theirs[0])
    assert ('input stall' in ours[0]) == ('input stall' in theirs[0]) == (method == 'torch')
    for lines in (ours, theirs):
        rest = '\n'.join(lines[1:])
        if method == 'python':
            assert rest == ''
        else:
            assert rest.startswith('stall report: ') and 'bottleneck' in rest
            assert 'attributed' in rest


def test_fresh_process_runs_the_measurement_in_a_child(synthetic_dataset, capfd):
    rc = throughput.main([synthetic_dataset.url, '-m', '2', '-n', '10', '-w', '1',
                          '-d', 'torch', '--batch-size', '5', '--device', 'cpu',
                          '--fresh-process'])
    assert rc == 0
    lines = capfd.readouterr().out.splitlines()
    assert LINE.match(lines[0]) and 'input stall' in lines[0]


def test_trace_out_writes_a_chrome_trace(synthetic_dataset, tmp_path, capsys,
                                         _restore_telemetry):
    trace = tmp_path / 'trace.json'
    lines = _output_lines(capsys, throughput.main, [
        synthetic_dataset.url, '-f', 'id', 'matrix', '-m', '8', '-n', '32', '-w', '2',
        '-d', 'torch', '--batch-size', '8', '--device', 'cpu', '--trace-out', str(trace)])
    assert lines[-1].startswith('wrote ') and str(trace) in lines[-1]
    n = int(lines[-1].split()[1])
    events = json.loads(trace.read_text())['traceEvents']
    assert n == len(events) > 0
    for event in events:
        assert {'ph', 'ts', 'pid', 'tid', 'name'} <= set(event)
    assert 'stall report' in '\n'.join(lines)


def test_jax_read_method_is_refused(synthetic_dataset, capsys):
    with pytest.raises(ValueError, match='Unknown read_method'):
        throughput.reader_throughput(synthetic_dataset.url, read_method='jax', device='cpu')
    with pytest.raises(SystemExit) as exc:
        throughput.main([synthetic_dataset.url, '-d', 'jax'])
    assert exc.value.code == 2
    assert "invalid choice: 'jax'" in capsys.readouterr().err


def test_process_stats_agree_with_psutil():
    proc = psutil.Process()
    throughput._process_stats()
    proc.cpu_percent(interval=None)
    t0 = time.perf_counter()
    x = 0
    while time.perf_counter() - t0 < 0.25:  # a busy loop on this thread
        x += 1
    rss_mb, cpu = throughput._process_stats()
    their_cpu = proc.cpu_percent(interval=None)
    their_rss_mb = proc.memory_info().rss / (1 << 20)
    assert abs(rss_mb - their_rss_mb) <= 0.03 * their_rss_mb
    # psutil counts clock ticks of 10 ms: a loose bound over a quarter second
    assert cpu > 0 and abs(cpu - their_cpu) <= 20


def test_first_process_stats_call_reports_no_cpu(monkeypatch):
    monkeypatch.setattr(throughput, '_last_cpu_times', None)
    rss_mb, cpu = throughput._process_stats()
    assert rss_mb > 0 and cpu == 0.0


def test_torch_method_leaves_no_prefetch_thread(synthetic_dataset):
    before = set(threading.enumerate())
    result = throughput.reader_throughput(synthetic_dataset.url, read_method='torch',
                                          device='cpu', **_kwargs('thread'))
    assert result.input_stall_fraction is not None
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive() and t.name.startswith('pstpu-torch-')]
    assert left == []


def test_torch_method_stages_onto_the_device(synthetic_dataset, monkeypatch):
    import petastorm_tpu_torch.torch as port_torch

    staged_to = []
    real = port_torch.prefetch_to_device

    def spy(iterator, device=None, size=2):
        staged_to.append((device, size))
        batches = real(iterator, device, size=size)
        try:
            for batch in batches:
                assert all(t.device == device for t in batch.values())
                yield batch
        finally:
            batches.close()

    monkeypatch.setattr(port_torch, 'prefetch_to_device', spy)
    throughput.reader_throughput(synthetic_dataset.url, read_method='torch', device='cpu',
                                 **_kwargs('dummy'))
    assert [(str(d), s) for d, s in staged_to] == [('cpu', 2)]
