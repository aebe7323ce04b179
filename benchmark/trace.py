"""Reduction of a profiler trace (``torch.profiler``'s Chrome trace JSON) to
what the per-layer metrics and the result's ``breakdown`` read."""

from __future__ import annotations

import json

#: trace categories of work on the device
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: the benchmark's own host spans (:func:`benchmark.duty.span`)
HOST_SPAN_PREFIX = 'bench.'


def _union(intervals):
    """Merged ``[(start, end)]`` of ``intervals``, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _total(merged):
    return sum(end - start for start, end in merged)


def reduce_trace(path, step_kernel, top=10):
    """Read the trace at ``path``. Times are in seconds.

    - ``window_s``: from the first event to the last device event's end;
    - ``busy_s``: the union of the device's activities in it;
    - ``kernel_busy_per_step_s``: the union of kernels between the first and
      the last start of ``step_kernel`` (a kernel every step launches once),
      over the steps between them; None with fewer than two;
    - ``kernel_mean_s``: ``{name: mean duration}`` of every kernel;
    - ``device_ops``: the ``top`` kernels and copies by total time;
    - ``idle_gaps``: the ``top`` longest gaps between device activities, each
      named by the benchmark's host span that covers its middle."""
    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    device, kernels, spans, starts = [], [], [], []
    by_name = {}
    first = None
    for e in events:
        if e.get('ph') != 'X' or 'ts' not in e:
            continue
        ts, dur = float(e['ts']), float(e.get('dur', 0.0))
        first = ts if first is None else min(first, ts)
        cat, name = e.get('cat', ''), e.get('name', '')
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            total, count = by_name.get(name, (0.0, 0))
            by_name[name] = (total + dur, count + 1)
            if cat == 'kernel':
                kernels.append((ts, ts + dur))
                if step_kernel in name:
                    starts.append(ts)
        elif cat == 'user_annotation' and name.startswith(HOST_SPAN_PREFIX):
            spans.append((ts, ts + dur, name))
    if not device:
        return None
    merged = _union(device)
    last = merged[-1][1]
    window = (last - first) * 1e-6
    out = {'window_s': window, 'busy_s': _total(merged) * 1e-6,
           'kernel_mean_s': {n: t / c * 1e-6 for n, (t, c) in by_name.items()},
           'device_ops': [[n[:160], t * 1e-6] for n, (t, _) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]}
    starts.sort()
    if len(starts) >= 2:
        lo, hi = starts[0], starts[-1]
        clipped = [(max(s, lo), min(e, hi)) for s, e in kernels if e > lo and s < hi]
        out['kernel_busy_per_step_s'] = _total(_union(clipped)) * 1e-6 / (len(starts) - 1)
    else:
        out['kernel_busy_per_step_s'] = None
    gaps = [(first, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for start, end in gaps:
        mid = (start + end) / 2
        covering = [s for s in spans if s[0] <= mid <= s[1]]
        # the innermost span: the shortest that covers the middle
        label = min(covering, key=lambda s: s[1] - s[0])[2] if covering else 'host.other'
        named.append([label, (end - start) * 1e-6])
    out['idle_gaps'] = named
    return out
