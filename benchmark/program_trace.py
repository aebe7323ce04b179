"""Reduction of one merged trace: the profiler's Chrome trace with the
program's own spans moved onto its clock
(``petastorm_tpu_torch.observability.merge_profiler_trace``, whose document
ends in the program's events, ``programEvents['count']`` of them). The
profiler's part is read as :func:`benchmark.trace.reduce_trace` reads the
profiler's file, so the slice and its idle gaps are the same; the program's
part says what the consumer and the prefetch thread were doing in them."""

from __future__ import annotations

from benchmark.trace import DEVICE_CATS, _union

#: the consumer's wait on the prefetch queue (the program's stage)
CONSUMER_WAIT = 'prefetch_get_wait'
#: a stage only the prefetch thread runs: the pump's wait on a full queue
PREFETCH_STAGE = 'prefetch_put_wait'
#: the label of a gap no program span covers
OTHER = 'host.other'


def _overlap(a, b):
    """The total overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(spans, t):
    """The name of the shortest span of ``spans`` that covers ``t``."""
    covering = [s for s in spans if s[0] <= t <= s[1]]
    return min(covering, key=lambda s: s[1] - s[0])[2] if covering else OTHER


def reduce_program_trace(doc, top=10):
    """Read a merged document (a dict); times in the result are seconds.
    None where it has no program events or the profiler saw no device work.

    - ``idle_on_input_share``: the device's idle time in the slice that lies
      under the consumer's ``prefetch_get_wait`` spans, over the slice, in
      percent (at most the slice's idle share);
    - ``idle_gaps_program``: the ``top`` longest idle gaps, ranked as
      ``reduce_trace`` ranks them, each ``[consumer span, prefetch thread
      span, seconds]``: the innermost program span at the gap's middle on
      the threads that wait on the queue and that fill it."""
    events = doc.get('traceEvents', [])
    count = (doc.get('programEvents') or {}).get('count', 0)
    if not count:
        return None
    device, first = [], None
    for e in events[:-count]:
        if e.get('ph') != 'X' or 'ts' not in e:
            continue
        ts = float(e['ts'])
        first = ts if first is None else min(first, ts)
        if e.get('cat', '') in DEVICE_CATS:
            device.append((ts, ts + float(e.get('dur', 0.0))))
    if not device:
        return None
    merged = _union(device)
    window = merged[-1][1] - first
    gaps = [(first, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps = [g for g in gaps if g[1] > g[0]]

    threads = {}
    for e in events[-count:]:
        if e.get('ph') == 'X':
            ts = float(e['ts'])
            threads.setdefault((e.get('pid'), e.get('tid')), []).append(
                (ts, ts + float(e.get('dur', 0.0)), e.get('name', '')))
    consumer = [s for spans in threads.values() if any(n == CONSUMER_WAIT for _, _, n in spans)
                for s in spans]
    prefetch = [s for spans in threads.values() if any(n == PREFETCH_STAGE for _, _, n in spans)
                for s in spans]
    waits = _union([(s, e) for s, e, n in consumer if n == CONSUMER_WAIT])
    on_input = _overlap(gaps, waits)

    ranked = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = [[_innermost(consumer, (s + e) / 2), _innermost(prefetch, (s + e) / 2),
              (e - s) * 1e-6] for s, e in ranked]
    return {'idle_on_input_share': on_input * 100.0 / window, 'idle_gaps_program': named}
