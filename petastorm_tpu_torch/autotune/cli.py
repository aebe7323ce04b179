"""``python -m petastorm_tpu_torch.autotune.cli``: offline replay — propose a
config from a recorded run, without running the pipeline (twin of
``petastorm_tpu/autotune/cli.py``).

Feed it a telemetry history (recorded by ``HistoryRecorder.save``, a
``JsonlExporter`` file, or ``python -m petastorm_tpu_torch.observability.
diagnose --watch --json`` output — any JSONL of ``{"ts", "diag"|"metrics"}``
lines) or a Chrome trace JSON (``--trace``, e.g. from
``export_chrome_trace``)::

    python -m petastorm_tpu_torch.autotune.cli history.jsonl --workers 3
    python -m petastorm_tpu_torch.autotune.cli --trace pipeline.json --json

The recorded run's windows replay through the **identical**
:class:`~petastorm_tpu_torch.autotune.controller.Autotuner` decision path the
live controller runs — same bottleneck rules, same hysteresis, same clamps —
but against simulated knobs, so the output is the decision trajectory plus
the final proposed ``make_reader`` settings; the same file gives the JAX
package's decisions. See ``docs/autotune.md``.
"""

from __future__ import annotations

import argparse
import json
import sys

from petastorm_tpu_torch.autotune.controller import AutotuneConfig, Autotuner
from petastorm_tpu_torch.observability import history as _history

#: trace span names folded into each synthesized window's stage seconds
_TRACE_STAGES = ('pool_wait', 'read', 'chunk_fetch', 'fused_decode', 'decode',
                 'transform', 'collate', 'ventilate')


class _SimPool(object):
    """Simulated worker pool: counts slots, never spawns anything."""

    def __init__(self, workers_count):
        self.workers_count = workers_count

    def add_worker_slot(self):
        self.workers_count += 1
        return self.workers_count

    def retire_worker_slot(self):
        if self.workers_count > 1:
            self.workers_count -= 1
        return self.workers_count


class _SimChunkCache(object):
    """Simulated chunk-cache config: just the prefetch budget."""

    def __init__(self, prefetch_budget_bytes):
        self.prefetch_budget_bytes = prefetch_budget_bytes

    def set_prefetch_budget(self, n):
        self.prefetch_budget_bytes = int(n)


class _SimLoader(object):
    """Simulated loader: just the shuffle-buffer capacity knob."""

    def __init__(self, shuffle_capacity):
        self.shuffle_capacity = shuffle_capacity
        self.diagnostics = {}

    def set_shuffle_capacity(self, capacity):
        self.shuffle_capacity = int(capacity)


def windows_from_trace(path, interval_s=2.0):
    """Synthesize evidence windows from a Chrome trace: complete ('X') stage
    events bucket by wall time into ``interval_s`` windows; each window's
    ``stage_<name>_s`` is the sum of that stage's durations in the bucket.
    ``pool_wait`` doubles as the wait signal (``wait_proxy='pool_wait'``) —
    traces carry no loader wait counter."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get('traceEvents', []) if isinstance(doc, dict) else []
    stamped = [e for e in events
               if isinstance(e, dict) and e.get('ph') == 'X'
               and e.get('name') in _TRACE_STAGES and 'ts' in e]
    if not stamped:
        return []
    t0 = min(e['ts'] for e in stamped)
    buckets = {}
    for e in stamped:
        idx = int((e['ts'] - t0) / (interval_s * 1e6))
        bucket = buckets.setdefault(idx, {})
        key = 'stage_{}_s'.format(e['name'])
        bucket[key] = bucket.get(key, 0.0) + e.get('dur', 0) / 1e6
    windows = []
    for idx in sorted(buckets):
        win = dict(buckets[idx])
        wait = win.get('stage_pool_wait_s', 0.0)
        win['window_s'] = interval_s
        win['reader_wait_s'] = round(wait, 4)
        win['reader_wait_fraction'] = round(min(wait / interval_s, 1.0), 4)
        win['wait_proxy'] = 'pool_wait'
        win['rows_per_s'] = None
        windows.append(win)
    return windows


def replay(windows, config=None, workers=3, prefetch_bytes=64 << 20,
           shuffle_capacity=0):
    """Run the evidence windows through a dry Autotuner against simulated
    knobs. Returns ``(proposal_dict, decision_records, tuner)``."""
    config = config or AutotuneConfig()
    pool = _SimPool(workers)
    cache = _SimChunkCache(prefetch_bytes)
    loader = _SimLoader(shuffle_capacity) if shuffle_capacity > 0 else None
    tuner = Autotuner(config, pool=pool, chunk_cache=cache, loader=loader)
    now = 0.0
    for window in windows:
        now += float(window.get('window_s') or config.interval_s)
        tuner.evaluate(window, now=now)
    proposal = tuner.proposal()
    proposal.setdefault('prefetch_budget_bytes', cache.prefetch_budget_bytes)
    return proposal, tuner.decision_records(), tuner


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.autotune.cli',
        description='Replay a recorded telemetry history (or Chrome trace) '
                    'through the autotune decision path and propose a config '
                    'without running the pipeline.')
    parser.add_argument('history', nargs='?', default=None,
                        help='JSONL history file (HistoryRecorder.save / '
                             'JsonlExporter / diagnose --watch --json output)')
    parser.add_argument('--trace', default=None,
                        help='Chrome trace JSON instead of a history file')
    parser.add_argument('--interval-s', type=float, default=2.0,
                        help='evaluation window for --trace bucketing and the '
                             'replayed controller cadence')
    parser.add_argument('--workers', type=int, default=3,
                        help='workers_count the recorded run used')
    parser.add_argument('--prefetch-bytes', type=int, default=64 << 20,
                        help='prefetch in-flight byte budget the run used')
    parser.add_argument('--shuffle-capacity', type=int, default=0,
                        help='shuffling_queue_capacity the run used (0 = none)')
    parser.add_argument('--max-workers', type=int, default=None)
    parser.add_argument('--json', action='store_true', dest='as_json',
                        help='print the proposal as JSON')
    args = parser.parse_args(argv)

    if (args.history is None) == (args.trace is None):
        parser.error('give exactly one of: a history JSONL file, or --trace')
    if args.trace is not None:
        windows = windows_from_trace(args.trace, interval_s=args.interval_s)
    else:
        snaps = _history.load_history(args.history)
        windows = _history.history_windows(snaps)
    if not windows:
        print('no usable evidence windows in the input (need >= 2 history '
              'snapshots, or a trace with stage spans)', file=sys.stderr)
        return 1

    config = AutotuneConfig(interval_s=args.interval_s,
                            max_workers=args.max_workers)
    proposal, decisions, _tuner = replay(
        windows, config=config, workers=args.workers,
        prefetch_bytes=args.prefetch_bytes,
        shuffle_capacity=args.shuffle_capacity)

    if args.as_json:
        print(json.dumps({'windows': len(windows), 'proposal': proposal,
                          'decisions': decisions}))
        return 0
    print('replayed {} evidence window(s)'.format(len(windows)))
    if decisions:
        print('decision trajectory:')
        for d in decisions:
            print('  [{}] {} {}: {} -> {}  ({})'.format(
                d['ts'], d['action'], d['knob'], d['from'], d['to'],
                d['reason']))
    else:
        print('no knob changes proposed (no stalled window crossed the '
              'threshold, or hysteresis held every move)')
    print('proposed configuration:')
    for key in sorted(proposal):
        print('  {} = {}'.format(key, proposal[key]))
    print('apply with make_reader(..., workers_count={}) and the knobs above; '
          'see docs/autotune.md'.format(proposal.get('workers_count', '?')))
    return 0


if __name__ == '__main__':
    sys.exit(main())
