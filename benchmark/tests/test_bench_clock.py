"""On the card, at the cell's own size: the program's spans and the
profiler's trace share one clock. One profiled window of the cell, with the
program at the ``spans`` level, merged by the program's
``merge_profiler_trace``: each replayed step's ``train_step_replay`` span
holds the ``cudaGraphLaunch`` its step made, each ``prefetch_get_wait`` and
``prefetch_hand_over`` span lies inside the loop's ``bench.next`` range, and
each ``train_step`` span inside its ``bench.step``. Skips without a card; run
there with ``python -m pytest -s benchmark/tests/test_bench_clock.py``
(``-s`` prints the offsets and the reductions of the slice)."""

import json
import os
import statistics

import pytest

from benchmark import duty, harness, program_trace
from benchmark.trace import reduce_trace

from .fixtures import cuda  # noqa: F401  (a fixture)

SEED = 2 ** 31 + 2626
#: how far apart the two clocks may read one instant: the ring stamps whole
#: µs, and the profiler's base time and its conversion of the CUDA runtime's
#: timestamps sit within some 15 µs of the ring's clock on the card (anchors
#: on both clocks bracket the offset)
CLOCK_US = 20


def _profiled_window(cell, device, seconds, path):
    """The profiler's document and the program's ring events of one window
    of ``seconds``, after a window that warms the graph up."""
    import torch

    from petastorm_tpu_torch import observability as obs

    seeds = harness.Seeds(SEED)
    store = harness.ensure_store(cell)
    weights = cell.model_module().make_weights(cell.config, seeds.weights, device)
    workers = cell.traffic.get('workers') or len(os.sched_getaffinity(0))
    program = harness.Program(cell, store, seeds, device, workers, weights, lambda name: None)
    del weights
    clock = duty.CudaClock(torch)
    saved = obs.current_config()
    try:
        # the eager warm-up, the capture and the first replays
        duty.run_window(program.it, program.step, 2.0, clock)
        obs.drain_trace_events()
        obs.configure('spans')
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        try:
            obs.clock_anchor()
            duty.run_window(program.it, program.step, seconds, clock, torch)
            obs.clock_anchor()
        finally:
            profiler.stop()
            obs.configure(saved)
        events = obs.drain_trace_events()
        profiler.export_chrome_trace(path)
    finally:
        obs.configure(saved)
        program.close()
    with open(path) as f:
        return json.load(f), events


def _spans(events, name, cat=None):
    """``[(start, end)]`` of the complete events called ``name`` (or, for a
    CUDA runtime call, a versioned name of it) in category ``cat``."""
    return sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0))) for e in events
                  if e.get('ph') == 'X' and e.get('name', '').split('_v')[0] == name
                  and (cat is None or e.get('cat') == cat))


def _quartiles(values):
    return [round(v, 2) for v in statistics.quantiles(values, n=4)] if len(values) > 1 else values


def _placed(inner, outer):
    """How many spans of ``inner`` lie inside one of ``outer`` (within the
    clocks' agreement), and the quartiles of the distances from the outer
    span's start to the inner's and from the inner's end to the outer's."""
    placed, heads, tails = 0, [], []
    for start, end in inner:
        around = [(a, b) for a, b in outer if a - CLOCK_US <= start and end <= b + CLOCK_US]
        if around:
            placed += 1
            heads.append(start - around[0][0])
            tails.append(around[0][1] - end)
    return placed, _quartiles(heads), _quartiles(tails)


@pytest.mark.gpu
def test_program_spans_share_the_profiler_clock(cuda, tmp_path):
    from petastorm_tpu_torch import observability as obs

    cell = harness.Cell('rn50_petastorm.raw')
    harness.set_environment()
    path = str(tmp_path / 'profiler.json')
    doc, events = _profiled_window(cell, cuda, 3.0, path)
    merged = obs.merge_profiler_trace(doc, events)
    program = merged['traceEvents'][-merged['programEvents']['count']:]
    anchored = obs.merge_profiler_trace({k: v for k, v in doc.items()
                                         if k != 'baseTimeNanoseconds'}, events)
    report = {'clock': merged['programEvents']['clock'],
              'anchor_minus_base_us': anchored['programEvents']['offset_us']
              - merged['programEvents']['offset_us']}

    # each replay's span holds its step's graph launch, a CUDA runtime call
    # the profiler times on its own clock
    launches = _spans(doc['traceEvents'], 'cudaGraphLaunch', 'cuda_runtime')
    replays = _spans(program, 'train_step_replay')
    held = sum(_placed([launch], replays)[0] for launch in launches)
    lead, tail = [], []
    for start, end in replays:
        near = min(launches, key=lambda ab: abs(ab[0] - start))
        lead.append(near[0] - start)
        tail.append(end - near[1])
    report.update(replays=len(replays), launches=len(launches), held=held,
                  launch_after_span_start_us=_quartiles(lead),
                  span_end_after_launch_end_us=_quartiles(tail))

    # the consumer's spans lie inside the loop's own ranges of the same call:
    # the queue's wait and the hand-over in next(), the step's dispatch in the
    # step; the time between them is the consumer's, outside these stages
    nexts = _spans(doc['traceEvents'], 'bench.next', 'user_annotation')
    steps = _spans(doc['traceEvents'], 'bench.step', 'user_annotation')
    inside = {}
    for name, outer in (('prefetch_get_wait', nexts), ('prefetch_hand_over', nexts),
                        ('train_step', steps)):
        spans = _spans(program, name)
        placed, heads, tails = _placed(spans, outer)
        inside[name] = (len(spans), placed)
        report[name] = {'spans': len(spans), 'placed': placed, 'after_outer_start_us': heads,
                        'before_outer_end_us': tails}

    # the two reductions of the slice agree on its gaps
    alone = reduce_trace(path, cell.model_module().STEP_MARKER)
    reduced = program_trace.reduce_program_trace(merged)
    idle_share = (1.0 - alone['busy_s'] / alone['window_s']) * 100.0
    report.update(device_idle_share=idle_share, **reduced)
    print('clock_check ' + json.dumps(report))

    assert len(replays) >= 10 and held >= 0.95 * len(replays), report
    for name, (count, placed) in inside.items():
        assert count >= 10 and placed == count, (name, report)
    assert reduced['idle_on_input_share'] <= idle_share
    assert [g[2] for g in reduced['idle_gaps_program']] == [g[1] for g in alone['idle_gaps']]
