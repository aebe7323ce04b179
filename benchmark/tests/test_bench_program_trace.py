"""The readers of the program's own stages and the reduction of a merged
trace (the profiler's file with the program's spans on its clock), on
hand-built contexts and traces with known answers."""

import json
import os

import pytest

from benchmark import harness, program_trace
from benchmark.trace import reduce_trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader(metric):
    return harness.Cell('rn50_petastorm.raw').metric_reader(metric)


#: a 10 s window of 100 steps (batches) by the program's counters
BEFORE = {'stage_prefetch_put_wait_s': 1.0, 'stage_shuffle.add_block_s': 0.5,
          'stage_shuffle.add_block_count': 40, 'stage_shuffle.emit_s': 1.0,
          'stage_shuffle.emit_count': 10, 'stage_infeed_s': 0.5, 'stage_infeed_count': 10,
          'stage_infeed_alloc_s': 0.1, 'stage_infeed_copy_s': 0.3, 'infeed_bytes_total': 3e8,
          'stage_collate_s': 0.2, 'stage_train_step_s': 0.01, 'stage_train_step_count': 10,
          'stage_shuffle.add_block_cpu_s': 0.5, 'stage_shuffle.emit_cpu_s': 0.9,
          'stage_collate_cpu_s': 0.2, 'stage_infeed_cpu_s': 0.4}
STEPS = {'stage_prefetch_put_wait_s': 2.5, 'stage_shuffle.add_block_s': 2.0,
         'stage_shuffle.add_block_count': 400, 'stage_shuffle.emit_s': 3.0,
         'stage_shuffle.emit_count': 100, 'stage_infeed_s': 1.2, 'stage_infeed_count': 100,
         'stage_infeed_alloc_s': 0.4, 'stage_infeed_copy_s': 0.6, 'infeed_bytes_total': 3.6e9,
         'stage_collate_s': 0.8, 'stage_train_step_s': 0.05, 'stage_train_step_count': 100,
         'stage_shuffle.add_block_cpu_s': 1.5, 'stage_shuffle.emit_cpu_s': 1.5,
         'stage_collate_cpu_s': 0.8, 'stage_infeed_cpu_s': 1.2}
EXPECTED = {
    'prefetch_full_wait_fraction': 25.0,       # 2.5 s of 10
    'shuffle_ms_per_batch': 50.0,              # (2 + 3) s over 100 batches
    'infeed_alloc_ms_per_batch': 4.0,          # 0.4 s over 100 stagings
    'infeed_copy_gb_per_s': 6.0,               # 3.6 GB in 0.6 s
    # wall 2 + 3 + 0.8 + 1.2 = 7 s, CPU 1.5 + 1.5 + 0.8 + 1.2 = 5 s
    'prefetch_off_cpu_fraction': (1.0 - 5.0 / 7.0) * 100.0,
    'step_dispatch_ms': 0.5,                   # 0.05 s over 100 replays
}


def _ctx(before, steps):
    after = {k: before.get(k, 0) + v for k, v in steps.items()}
    return harness.Context(window={'steps': 100, 'window_s': 10.0, 'stall_s': 0.0,
                                   'periods_ms': [1.0]}, config={'batch_size': 256},
                           diag0=before, diag1=after, trace=None)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_a_program_stage_reader_reads_its_stages(metric):
    assert _reader(metric)(_ctx(BEFORE, STEPS)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_a_program_without_the_stages_reads_nothing(metric):
    """A program that times none of these stages (the stage timers of an
    earlier version, without the CPU seconds) gives no number, and no error."""
    kept = {'stage_infeed_s', 'stage_infeed_count', 'stage_collate_s',
            'stage_collate_count', 'reader_wait_s'}
    older = {k: v for k, v in BEFORE.items() if k in kept}
    assert _reader(metric)(_ctx(older, {k: v for k, v in STEPS.items() if k in kept})) is None


def test_every_program_stage_metric_is_a_listed_per_layer_metric():
    with open(os.path.join(os.path.dirname(BENCH), 'BENCHMARK.json')) as f:
        spec = json.load(f)
    per_layer = {m['name']: m for m in spec['per_layer']}
    for name in EXPECTED:
        assert per_layer[name]['workloads'] == ['rn50_petastorm.raw']
        assert per_layer[name]['moves'] == 'examples_per_s'


# -- the merged trace ----------------------------------------------------------------

PID, CONSUMER, PREFETCH = 7, 10, 20   # the profiler's (OS) thread ids
RING_CONSUMER, RING_PREFETCH = 140001, 140002   # the ring's (Python) thread ids


def _x(name, cat, ts, dur, tid=CONSUMER):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur, 'pid': PID, 'tid': tid}


def _profiler_doc():
    """Kernels at 100-200, 250-300, 330-400 and 1000-1010 µs; a runtime call
    opens the slice at 90. Idle: 90-100, 200-250, 300-330, 400-1000."""
    events = [_x('cudaGraphLaunch', 'cuda_runtime', 90, 5),
              _x('bench.next', 'user_annotation', 95, 15),
              _x('k1', 'kernel', 100, 100, tid=0), _x('k2', 'kernel', 250, 50, tid=0),
              _x('k3', 'kernel', 330, 70, tid=0), _x('bench.next', 'user_annotation', 380, 600),
              _x('k4', 'kernel', 1000, 10, tid=0)]
    return {'traceEvents': events, 'baseTimeNanoseconds': 1_700_000_000_000_000_000}


def _ring_events():
    """The program's spans, in epoch µs (the base is 1.7e15 µs)."""
    base = 1_700_000_000_000_000

    def ring(name, ts, dur, tid):
        return {'name': name, 'cat': 'infeed', 'ph': 'X', 'ts': base + ts, 'dur': dur,
                'pid': PID, 'tid': tid}

    return [ring('train_step', 20, 60, RING_CONSUMER),
            ring('prefetch_get_wait', 500, 480, RING_CONSUMER),
            ring('prefetch_get_wait', 190, 20, RING_CONSUMER),
            ring('infeed', 450, 200, RING_PREFETCH),
            ring('infeed_copy', 460, 150, RING_PREFETCH),
            ring('prefetch_put_wait', 700, 250, RING_PREFETCH)]


def _merged():
    from petastorm_tpu_torch import observability as obs

    return obs.merge_profiler_trace(_profiler_doc(), _ring_events())


def test_idle_on_input_is_the_idle_time_under_the_queue_wait():
    reduced = program_trace.reduce_program_trace(_merged())
    # the slice is 90-1010 µs; the waits 190-210 and 500-980 cover the idle
    # 200-210 and 500-980: 490 µs of 920
    assert reduced['idle_on_input_share'] == pytest.approx(490 / 920 * 100)


def test_idle_gaps_name_the_consumer_and_prefetch_spans_at_their_middles():
    reduced = program_trace.reduce_program_trace(_merged())
    gaps = reduced['idle_gaps_program']
    # 400-1000 (middle 700: the consumer waits, the pump waits on a full
    # queue), 200-250 (225: neither), 300-330 (315: neither), 90-100
    assert [g[:2] for g in gaps] == [['prefetch_get_wait', 'prefetch_put_wait'],
                                     ['host.other', 'host.other'],
                                     ['host.other', 'host.other'],
                                     ['host.other', 'host.other']]
    assert [g[2] for g in gaps] == pytest.approx([600e-6, 50e-6, 30e-6, 10e-6])


def test_the_merged_gaps_are_the_profiler_files_and_its_reduction_is_unchanged(tmp_path):
    path = str(tmp_path / 'profiler.json')
    with open(path, 'w') as f:
        json.dump(_profiler_doc(), f)
    alone = reduce_trace(path, 'k1')
    merged = _merged()
    # merging reads the profiler's document and leaves its file as it was
    assert reduce_trace(path, 'k1') == alone
    assert merged['traceEvents'][:len(_profiler_doc()['traceEvents'])] == \
        _profiler_doc()['traceEvents']
    reduced = program_trace.reduce_program_trace(merged)
    assert [g[2] for g in reduced['idle_gaps_program']] == [g[1] for g in alone['idle_gaps']]
    assert reduced['idle_on_input_share'] <= (1 - alone['busy_s'] / alone['window_s']) * 100
    # the merged document read as a profiler file would count the program's
    # spans into the slice: the profiler's file is reduced alone
    with open(path, 'w') as f:
        json.dump(merged, f)
    assert reduce_trace(path, 'k1')['idle_gaps'] != alone['idle_gaps']


def test_a_document_without_program_events_reduces_to_nothing():
    assert program_trace.reduce_program_trace(_profiler_doc()) is None
    assert program_trace.reduce_program_trace({'traceEvents': [], 'programEvents':
                                               {'count': 0}}) is None
