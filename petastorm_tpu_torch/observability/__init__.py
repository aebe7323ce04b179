"""Pipeline telemetry: metrics registry, span tracing, stall attribution.

Twin of ``petastorm_tpu/observability/__init__.py``. Three levels, selected
with ``make_reader(telemetry=...)`` or :func:`configure`:

* ``'off'``: every instrumentation helper returns after one int compare;
  no counters, no spans, no per-row work anywhere.
* ``'counters'`` (the default): named counters, gauges and histograms
  updated at block/batch granularity; each stage's wall seconds, calls and
  the thread's CPU seconds (``stage_<name>_s``/``_count``/``_cpu_s``); the
  ``diagnostics`` surfaces are views over the registry; stall attribution
  works; the flight recorder is on (``PSTPU_FLIGHT=0`` switches it off).
* ``'spans'``: also one Chrome-trace event per pipeline stage execution in a
  bounded ring, exportable with :func:`export_chrome_trace`; with a
  ``torch.profiler`` trace beside it, as one document on the profiler's
  clock (:func:`merge_profiler_trace`)::

      obs.configure('spans')
      with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
          ...                                   # the steps to look at
      prof.export_chrome_trace('card.json')
      obs.export_chrome_trace('merged.json', profiler_trace='card.json')

The level and registries are per process: spawned process-pool workers get
the config through the pool's setup args and ship their snapshots and span
events back over the results channel. Instrument with::

    from petastorm_tpu_torch import observability as obs

    with obs.stage('decode', cat='worker'):       # timer + (at spans) an event
        ...
    obs.count('rows_decoded_total', n)            # block-granularity counter
    obs.gauge_set('shuffle_occupancy', size)

``stage`` and ``span`` must be closed on all paths: use them as context
managers. The pod view merges hosts' JSONL exports (:func:`pod_report`,
``observability/podagg.py``), and ``python -m
petastorm_tpu_torch.observability.diagnose`` is the one-shot and live CLI.
"""

from __future__ import annotations

import time as _time

from petastorm_tpu_torch.observability import blackbox as _blackbox
from petastorm_tpu_torch.observability import metrics as _metrics
from petastorm_tpu_torch.observability import trace as _trace
from petastorm_tpu_torch.observability.blackbox import (FlightRecorder,  # noqa: F401
                                                        format_postmortem, load_flight,
                                                        postmortem_report)
from petastorm_tpu_torch.observability.critical_path import (critical_path,  # noqa: F401
                                                             critical_path_summary,
                                                             format_critical_path,
                                                             format_slowest_batches,
                                                             format_span_tree,
                                                             slowest_batches, span_tree,
                                                             stage_breakdown, traces_in)
from petastorm_tpu_torch.observability.exporters import (JsonlExporter,  # noqa: F401
                                                         host_identity, to_prometheus_text,
                                                         write_prometheus)
from petastorm_tpu_torch.observability.history import (HistoryRecorder,  # noqa: F401
                                                       detect_regression, history_windows,
                                                       load_history, window_delta,
                                                       windowed_stall_report)
from petastorm_tpu_torch.observability.metrics import (counters_on,  # noqa: F401
                                                       flatten_snapshot, get_registry,
                                                       merge_snapshots, spans_on)
from petastorm_tpu_torch.observability.podagg import (format_pod_report,  # noqa: F401
                                                      load_host_series, load_pod,
                                                      pod_report)
from petastorm_tpu_torch.observability.report import (decode_collate_share,  # noqa: F401
                                                      format_stall_report, stall_report)
from petastorm_tpu_torch.observability.trace import (TraceContext, chrome_trace,  # noqa: F401
                                                     clock_anchor, current_trace,
                                                     export_chrome_trace, get_ring, instant,
                                                     merge_profiler_trace, mint_trace, root_of,
                                                     span, trace_root, use_trace)

_LEVELS = ('off', 'counters', 'spans')


class TelemetryConfig(object):
    """Picklable telemetry description, shipped into worker processes.

    :param level: 'off' | 'counters' | 'spans'
    :param trace_capacity: span ring size (events); oldest rotate out
    """

    def __init__(self, level='counters', trace_capacity=_trace.DEFAULT_TRACE_CAPACITY):
        if level not in _LEVELS:
            raise ValueError("telemetry level must be one of {}, got {!r}".format(
                _LEVELS, level))
        if trace_capacity < 1:
            raise ValueError('trace_capacity must be >= 1')
        self.level = level
        self.trace_capacity = trace_capacity

    def _key(self):
        return (self.level, self.trace_capacity)

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return 'TelemetryConfig(level={!r}, trace_capacity={})'.format(
            self.level, self.trace_capacity)


def resolve_telemetry(telemetry):
    """Normalize the ``make_reader`` argument: ``None`` -> None (keep the
    current process configuration), a level string -> config, a config ->
    itself."""
    if telemetry is None:
        return None
    if isinstance(telemetry, TelemetryConfig):
        return telemetry
    if isinstance(telemetry, str):
        return TelemetryConfig(level=telemetry)
    raise ValueError("telemetry must be None, 'off'/'counters'/'spans', or a "
                     'TelemetryConfig, got {!r}'.format(telemetry))


def configure(telemetry):
    """Apply a telemetry config (or level string) to THIS process. ``None`` is
    a no-op. Returns the effective :class:`TelemetryConfig`."""
    config = resolve_telemetry(telemetry)
    if config is not None:
        _metrics.set_level(config.level)
        _trace.get_ring().set_capacity(config.trace_capacity)
    return current_config()


def current_config():
    """The process's effective config (what a Reader ships to its workers when
    no explicit ``telemetry=`` was given)."""
    return TelemetryConfig(level=_metrics.level_name(),
                           trace_capacity=_trace.get_ring().capacity)


# -- instrumentation helpers (each starts with the one-int-compare fast path) --

class _StageTimer(object):
    """Counter + (at spans level) trace event for one pipeline-stage
    execution, accumulated into ``stage_<name>_s``/``stage_<name>_count``,
    and the thread's CPU seconds in it into ``stage_<name>_cpu_s``.

    At spans level the timer takes part in trace-context propagation as
    :class:`~petastorm_tpu_torch.observability.trace._Span` does: it stamps
    ``trace``/``span``/``parent`` from the thread's active
    :class:`TraceContext` and parents anything nested. :meth:`link` attaches
    the span to a context known only mid-flight (``pool_wait``)."""

    __slots__ = ('name', 'cat', 'args', '_t0', '_cpu0', '_wall0', '_spans', '_ctx',
                 '_link', '_sid', '_pushed', '_act', '_act_prev')

    def __init__(self, name, cat, args, spans):
        self.name = name
        self.cat = cat
        self.args = args
        self._spans = spans
        self._link = None
        self._pushed = False

    def __enter__(self):
        # the flight recorder's activity slot: one load + None compare when
        # recording is off
        act = _blackbox._ACTIVITY
        self._act = act
        if act is not None:
            self._act_prev = act.enter(self.cat + '.' + self.name)
        if self._spans:
            ctx = _trace.current_trace()
            self._ctx = ctx
            if ctx is not None:
                self._sid = _trace.next_span_id()
                _trace._push_trace(_trace.TraceContext(ctx.trace, self._sid))
                self._pushed = True
            else:
                self._sid = None
        self._cpu0 = _time.thread_time()
        if self._spans:
            # the event's start next to the timer's: a thread that loses the
            # interpreter lock between the two would shift its event early
            self._wall0 = _time.time()
        self._t0 = _time.perf_counter()
        return self

    def link(self, ctx):
        """Adopt ``ctx`` as this span's parent context (no-op below spans
        level or when ``ctx`` is None)."""
        if self._spans and ctx is not None:
            self._link = ctx

    def __exit__(self, exc_type, exc_value, tb):
        dur = _time.perf_counter() - self._t0
        cpu = _time.thread_time() - self._cpu0
        _metrics.get_registry().stage_timer(self.name).record(dur, cpu)
        if self._act is not None:
            self._act.exit(self._act_prev)
        if self._spans:
            if self._pushed:
                _trace._pop_trace()
            _trace.record_span(
                self.name, self.cat, self._wall0, dur,
                _trace.stamp_trace_args(self.args, self._link or self._ctx,
                                        self._sid))
        return False


def stage(name, cat='pipeline', **args):
    """Time one execution of a named pipeline stage: accumulates the
    ``stage_<name>_s``/``stage_<name>_count``/``stage_<name>_cpu_s`` counters
    (wall seconds, calls, the thread's CPU seconds) and, at level
    ``'spans'``, records a Chrome-trace event. No-op at ``'off'``. Use as a
    context manager."""
    if not _metrics.counters_on():
        return _trace._NOOP_SPAN
    return _StageTimer(name, cat, args or None, _metrics.spans_on())


def count(name, n=1):
    """Increment a counter (no-op at level 'off')."""
    if _metrics.counters_on():
        _metrics.get_registry().counter(name).inc(n)


def add_seconds(name, seconds):
    """Accumulate a float counter (no-op at level 'off')."""
    if _metrics.counters_on():
        _metrics.get_registry().counter(name).add(seconds)


def gauge_set(name, value):
    """Set a gauge (no-op at level 'off')."""
    if _metrics.counters_on():
        _metrics.get_registry().gauge(name).set(value)


def observe(name, value, buckets=_metrics.DEFAULT_BUCKETS):
    """Observe into a histogram (no-op at level 'off')."""
    if _metrics.counters_on():
        _metrics.get_registry().histogram(name, buckets).observe(value)


def snapshot():
    """This process's structured metrics snapshot (picklable)."""
    return _metrics.get_registry().snapshot()


def drain_trace_events():
    """Drain the process span ring (worker -> main shipping)."""
    return _trace.get_ring().drain()


def absorb_trace_events(events):
    """Merge span events shipped from another process into this ring."""
    if events:
        _trace.get_ring().extend(events)


__all__ = [
    'FlightRecorder', 'HistoryRecorder', 'JsonlExporter', 'TelemetryConfig', 'TraceContext',
    'absorb_trace_events', 'add_seconds', 'chrome_trace', 'clock_anchor', 'configure', 'count',
    'counters_on', 'critical_path', 'critical_path_summary', 'current_config', 'current_trace',
    'decode_collate_share', 'detect_regression', 'drain_trace_events',
    'export_chrome_trace', 'flatten_snapshot', 'format_critical_path', 'format_pod_report',
    'format_postmortem', 'format_slowest_batches', 'format_span_tree',
    'format_stall_report', 'gauge_set', 'get_registry', 'get_ring', 'history_windows',
    'host_identity', 'instant', 'load_flight', 'load_history', 'load_host_series',
    'load_pod', 'merge_profiler_trace', 'merge_snapshots', 'mint_trace', 'observe', 'pod_report',
    'postmortem_report', 'resolve_telemetry', 'root_of', 'slowest_batches', 'snapshot',
    'span', 'span_tree', 'spans_on', 'stage', 'stage_breakdown', 'stall_report',
    'to_prometheus_text', 'trace_root', 'traces_in', 'use_trace', 'window_delta',
    'windowed_stall_report', 'write_prometheus',
]
