"""Low-overhead metrics registry: named counters, gauges and histograms.

Twin of ``petastorm_tpu/observability/metrics.py``, the same names, levels,
snapshot layout and merge rules, so a snapshot of either package merges and
flattens the same in the other. The design constraints:

* **Cheap when off, cheap when on.** The telemetry *level* is a module-level
  int read without any lock; every instrumentation helper checks it first and
  returns before touching the registry. Updates happen at block/batch
  granularity (a row group, a batch), never per row.
* **Atomic in-process updates.** Each metric guards its state with its own
  lock: worker threads, the ventilator thread and the consumer update
  concurrently, and a torn float sum would skew the stall attribution.
* **Mergeable across processes.** :meth:`MetricsRegistry.snapshot` returns a
  picklable structured dict; :func:`merge_snapshots` sums counters,
  histograms and gauges, so the process pool's workers (which ship their
  snapshots over the results channel) aggregate into one view.

The registry is per process and shared by every reader in it: the
diagnostics surface is a view over it, so two concurrent readers see merged
numbers.
"""

from __future__ import annotations

import threading

#: telemetry levels, ordered: each level includes the previous one's work
LEVEL_OFF, LEVEL_COUNTERS, LEVEL_SPANS = 0, 1, 2

_LEVEL_NAMES = {'off': LEVEL_OFF, 'counters': LEVEL_COUNTERS, 'spans': LEVEL_SPANS}

#: process-wide level; plain int read (no lock) on every hot-path check
_level = LEVEL_COUNTERS


def set_level(name):
    """Set the process-wide telemetry level ('off' | 'counters' | 'spans')."""
    global _level
    if name not in _LEVEL_NAMES:
        raise ValueError("telemetry level must be 'off', 'counters' or 'spans', "
                         'got {!r}'.format(name))
    _level = _LEVEL_NAMES[name]


def level_name():
    for name, value in _LEVEL_NAMES.items():
        if value == _level:
            return name
    return 'counters'


def counters_on():
    return _level >= LEVEL_COUNTERS


def spans_on():
    return _level >= LEVEL_SPANS


class Counter(object):
    """Monotonic accumulator (ints or seconds-as-float)."""

    kind = 'counter'
    __slots__ = ('_lock', '_value')

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    add = inc  # seconds-accumulator alias; same atomicity

    @property
    def value(self):
        return self._value


class Gauge(object):
    """Last-written value (occupancy, depth)."""

    kind = 'gauge'
    __slots__ = ('_lock', '_value')

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


#: default histogram bucket upper bounds, in seconds (latency-shaped)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class Histogram(object):
    """Fixed-bucket histogram (cumulative-bucket Prometheus semantics)."""

    kind = 'histogram'
    __slots__ = ('_lock', '_bounds', '_counts', '_sum', '_count')

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self._bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        i = 0
        for bound in self._bounds:
            if v <= bound:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def state(self):
        with self._lock:
            return {'bounds': list(self._bounds), 'counts': list(self._counts),
                    'sum': self._sum, 'count': self._count}


class Timer(object):
    """Seconds-sum + call-count under ONE lock — the stage() hot path. In
    snapshots a timer flattens into the ``<name>_s`` / ``<name>_count``
    counter pair, so merge/flatten/Prometheus handling is unchanged."""

    kind = 'timer'
    __slots__ = ('_lock', '_sum', '_count')

    def __init__(self):
        self._lock = threading.Lock()
        self._sum = 0.0
        self._count = 0

    def record(self, seconds):
        with self._lock:
            self._sum += seconds
            self._count += 1

    @property
    def value(self):
        return self._sum


class MetricsRegistry(object):
    """Thread-safe name -> metric registry. Creation takes the registry lock
    once per metric name; subsequent lookups are a plain (GIL-safe) dict get."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        # stage name -> Timer: the per-call string concat + double lookup
        # measurably taxes small-row-group pipelines, so the hot stage() path
        # resolves its timer through this plain dict (benign race: concurrent
        # first calls both land on _get_or_create's locked creation)
        self._stage_timers = {}

    def _get_or_create(self, name, factory, kind):
        metric = self._metrics.get(name)  # noqa: PT1301 - double-checked locking; dict.get is GIL-atomic and a miss re-checks under _lock
        if metric is None:
            with self._lock:
                metric = self._metrics.get(name)
                if metric is None:
                    metric = factory()
                    self._metrics[name] = metric
        if metric.kind != kind:
            raise TypeError('metric {!r} already registered as a {}, not a {}'.format(
                name, metric.kind, kind))
        return metric

    def counter(self, name):
        return self._get_or_create(name, Counter, 'counter')

    def gauge(self, name):
        return self._get_or_create(name, Gauge, 'gauge')

    def histogram(self, name, buckets=DEFAULT_BUCKETS):
        return self._get_or_create(name, lambda: Histogram(buckets), 'histogram')

    def stage_timer(self, name):
        """The :class:`Timer` behind ``stage_<name>_s``/``stage_<name>_count``,
        cached for the hot path."""
        timer = self._stage_timers.get(name)
        if timer is None:
            timer = self._get_or_create('stage_' + name, Timer, 'timer')
            self._stage_timers[name] = timer
        return timer

    def value(self, name, default=0):
        """A counter's, gauge's or timer's current value, without creating
        the metric (the flight recorder's progress reads run at every level;
        one that created the metric would record it with telemetry off)."""
        metric = self._metrics.get(name)  # noqa: PT1301 - dict.get is GIL-atomic; a read-only probe that never creates
        return default if metric is None else metric.value

    def snapshot(self):
        """Picklable structured snapshot: ``{'counters': {name: value},
        'gauges': {...}, 'histograms': {name: state}}``."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {'counters': {}, 'gauges': {}, 'histograms': {}}
        for name, m in metrics.items():
            if m.kind == 'counter':
                out['counters'][name] = m.value
            elif m.kind == 'timer':
                with m._lock:
                    out['counters'][name + '_s'] = m._sum
                    out['counters'][name + '_count'] = m._count
            elif m.kind == 'gauge':
                out['gauges'][name] = m.value
            else:
                out['histograms'][name] = m.state()
        return out

    def reset(self):
        """Drop every metric (tests and fresh benchmark captures)."""
        with self._lock:
            self._metrics = {}
            self._stage_timers = {}


def merge_snapshots(snapshots):
    """Sum a list of :meth:`MetricsRegistry.snapshot` dicts into one: counters
    and histogram buckets add; gauges add too (per-worker occupancies are
    additive across a pool — the one cross-process gauge semantic we need)."""
    out = {'counters': {}, 'gauges': {}, 'histograms': {}}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for name, v in snap.get('counters', {}).items():
            out['counters'][name] = out['counters'].get(name, 0) + v
        for name, v in snap.get('gauges', {}).items():
            out['gauges'][name] = out['gauges'].get(name, 0) + v
        for name, h in snap.get('histograms', {}).items():
            agg = out['histograms'].get(name)
            if agg is None or agg['bounds'] != h['bounds']:
                out['histograms'][name] = {'bounds': list(h['bounds']),
                                           'counts': list(h['counts']),
                                           'sum': h['sum'], 'count': h['count']}
            else:
                agg['counts'] = [a + b for a, b in zip(agg['counts'], h['counts'])]
                agg['sum'] += h['sum']
                agg['count'] += h['count']
    return out


def flatten_snapshot(snapshot):
    """Structured snapshot -> flat ``{name: number}`` dict for the diagnostics
    surface (histograms contribute ``<name>_count``/``<name>_sum``)."""
    flat = {}
    flat.update(snapshot.get('counters', {}))
    flat.update(snapshot.get('gauges', {}))
    for name, h in snapshot.get('histograms', {}).items():
        flat[name + '_count'] = h['count']
        flat[name + '_sum'] = h['sum']
    return flat


#: the per-process default registry
_registry = MetricsRegistry()


def get_registry():
    return _registry
