"""Span tracing: a bounded ring buffer of Chrome-trace events.

Twin of ``petastorm_tpu/observability/trace.py`` (same event layout and
trace ids). Every instrumented pipeline stage (ventilator dispatch, worker
read/decode, shuffle add/emit, loader collate, device staging) records one
*complete* event (``ph='X'``) when the process-wide level is ``'spans'``. The
ring is bounded (``deque(maxlen=...)``): a long run rotates oldest-first
instead of growing without bound, so tracing is safe to leave on.

Events are stored directly in the Chrome trace-event format (the dict Perfetto
and ``chrome://tracing`` load), so export is a ``json.dump`` — no conversion
pass over a large buffer:

    {"name": ..., "cat": ..., "ph": "X", "ts": <epoch µs>, "dur": <µs>,
     "pid": ..., "tid": ..., "args": {...}}

``ts`` is wall-clock epoch microseconds (``time.time()``) so spans recorded in
worker *processes* land on the same timeline as the main process; ``dur`` is
measured with ``perf_counter`` for precision. Worker-process events travel to
the main process piggybacked on the pool's results channel (drained
incrementally with :meth:`TraceRing.drain`), keyed by their own ``pid`` so
Perfetto renders one track per process.

Causal tracing: every ventilated work
item is minted a :class:`TraceContext` — a trace id ``'<ns>:<seq>'`` (the
ventilator's 8-hex nonce plus the item's ventilation seq) and a parent span
id. The context is carried on a thread-local stack: spans opened while a
context is active stamp ``trace``/``span``/``parent`` into their event args
and push themselves as the parent of anything nested, so the ring holds a
reconstructable cross-process span TREE per batch, not a flat list. The trace
id itself doubles as the id of the (virtual) root node, so any process that
knows ``(ns, seq)`` can
derive the root with :func:`trace_root` and parent its own spans to it
without any extra bytes on the wire.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque, namedtuple

from petastorm_tpu_torch.observability import metrics as _metrics

DEFAULT_TRACE_CAPACITY = 65536

#: causal identity of one ventilated item: ``trace`` is the stable per-item
#: trace id (``'<ns>:<seq>'``), ``span`` the id new spans should parent to.
#: A plain namedtuple: picklable (it rides the process pool's existing
#: ventilation tuples) and cheap enough to mint per row group.
TraceContext = namedtuple('TraceContext', ('trace', 'span'))


class TraceRing(object):
    """Thread-safe bounded event buffer. ``add`` is O(1); when full the oldest
    event is rotated out (``deque(maxlen)`` semantics)."""

    def __init__(self, capacity=DEFAULT_TRACE_CAPACITY):
        self._lock = threading.Lock()
        self._events = deque(maxlen=capacity)
        self._dropped = 0

    @property
    def capacity(self):
        return self._events.maxlen  # noqa: PT1301 - atomic attr fetch; maxlen is immutable on whichever deque is current

    def set_capacity(self, capacity):
        with self._lock:
            if capacity != self._events.maxlen:
                self._events = deque(self._events, maxlen=capacity)

    def __len__(self):
        return len(self._events)  # noqa: PT1301 - len(deque) is GIL-atomic; lock-free diagnostics read

    @property
    def dropped(self):
        """Events rotated out since creation (ring-full overwrites)."""
        return self._dropped

    def add(self, event):
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(event)

    def extend(self, events):
        with self._lock:
            overflow = len(self._events) + len(events) - self._events.maxlen
            if overflow > 0:
                self._dropped += min(overflow, self._events.maxlen)
            self._events.extend(events)

    def snapshot(self):
        with self._lock:
            return list(self._events)

    def drain(self):
        """Return and clear the buffered events (incremental shipping from
        worker processes to the main-process ring)."""
        with self._lock:
            events, self._events = list(self._events), deque(maxlen=self._events.maxlen)
            return events

    def clear(self):
        with self._lock:
            self._events.clear()


#: the per-process default ring
_ring = TraceRing()


def get_ring():
    return _ring


def record_span(name, cat, ts_epoch_s, dur_s, args=None):
    """Append one complete event to the process ring (caller has already
    checked the level)."""
    event = {'name': name, 'cat': cat, 'ph': 'X',
             'ts': int(ts_epoch_s * 1e6), 'dur': int(dur_s * 1e6),
             'pid': os.getpid(), 'tid': threading.get_ident()}
    if args:
        event['args'] = args
    _ring.add(event)


# -- trace-context propagation ------------------------------------------------

#: per-process monotonic span ids, mixed with the pid so ids stay unique
#: across the processes whose events merge into one ring (``next`` on
#: ``itertools.count`` is atomic under the GIL — no lock needed)
_span_ids = itertools.count(1)

_tls = threading.local()


def next_span_id():
    """A span id unique across every process contributing to a trace."""
    return '{:x}.{:x}'.format(os.getpid(), next(_span_ids))


def trace_root(ns, seq):
    """The deterministic virtual-root context of item ``seq`` minted under
    namespace ``ns``: the trace id doubles as the root span id, so any process
    knowing ``(ns, seq)`` can parent spans to the root with zero extra wire
    bytes."""
    trace_id = '{}:{}'.format(ns, seq)
    return TraceContext(trace_id, trace_id)


def root_of(ctx):
    """The virtual-root context of ``ctx``'s trace (None in, None out) —
    consumer-side spans (pool wait, collate, infeed) parent to the root, as
    siblings of the dispatch chain, not under some arbitrary worker span."""
    return None if ctx is None else TraceContext(ctx.trace, ctx.trace)


def current_trace():
    """The innermost active :class:`TraceContext` on this thread (or None)."""
    stack = getattr(_tls, 'stack', None)
    return stack[-1] if stack else None


def _push_trace(ctx):
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def _pop_trace():
    stack = getattr(_tls, 'stack', None)
    if stack:
        stack.pop()


class _TraceScope(object):
    """Context manager installing one :class:`TraceContext` as this thread's
    active context (worker pools wrap ``worker.process`` in one so every stage
    inside lands in the item's span tree)."""

    __slots__ = ('_ctx',)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        _push_trace(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc_value, tb):
        _pop_trace()
        return False


def use_trace(ctx):
    """Install a propagated :class:`TraceContext` around a block (no-op when
    ``ctx`` is None or the level is below ``'spans'``)."""
    if ctx is None or not _metrics.spans_on():
        return _NOOP_SPAN
    return _TraceScope(ctx)


def mint_trace(ns, seq):
    """Mint the trace for one ventilated item and install its root context
    (the ventilators call this around their dispatch block, so the ventilate
    span becomes the root's first child and ``pool.ventilate`` — which runs
    inside — captures the context for propagation)."""
    if not _metrics.spans_on():
        return _NOOP_SPAN
    return _TraceScope(trace_root(ns, seq))


class _Span(object):
    """Context manager recording one complete event on exit. Use only via
    :func:`span`/:func:`petastorm_tpu_torch.observability.stage` so the off-level
    fast path stays a single int check.

    When a :class:`TraceContext` is active on the thread, the span stamps
    ``trace``/``span``/``parent`` into its event args and installs itself as
    the parent of anything opened inside it. :meth:`link` attaches the span to
    a context discovered only mid-flight (``pool_wait`` learns its item's
    identity from the frame it receives, after the span already opened)."""

    __slots__ = ('name', 'cat', 'args', '_t0', '_wall0', '_ctx', '_link',
                 '_sid', '_pushed')

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self._link = None

    def __enter__(self):
        self._wall0 = time.time()
        ctx = current_trace()
        self._ctx = ctx
        if ctx is not None:
            self._sid = next_span_id()
            _push_trace(TraceContext(ctx.trace, self._sid))
            self._pushed = True
        else:
            self._sid = None
            self._pushed = False
        self._t0 = time.perf_counter()
        return self

    def link(self, ctx):
        """Adopt ``ctx`` as this span's parent context (overrides whatever was
        active at entry; None is ignored)."""
        if ctx is not None:
            self._link = ctx

    def __exit__(self, exc_type, exc_value, tb):
        dur = time.perf_counter() - self._t0
        if self._pushed:
            _pop_trace()
        record_span(self.name, self.cat, self._wall0, dur,
                    stamp_trace_args(self.args, self._link or self._ctx, self._sid))
        return False


def stamp_trace_args(args, ctx, sid=None):
    """Event args with the causal identity stamped in (``args`` unchanged when
    no context is active)."""
    if ctx is None:
        return args
    out = dict(args) if args else {}
    out['trace'] = ctx.trace
    out['span'] = sid if sid is not None else next_span_id()
    out['parent'] = ctx.span
    return out


class _NoopSpan(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        return False

    def link(self, ctx):
        return None


_NOOP_SPAN = _NoopSpan()


def span(name, cat='pipeline', **args):
    """Trace-only span: records a Chrome-trace event at level ``'spans'``,
    no-op below. Must be used as a context manager."""
    if not _metrics.spans_on():
        return _NOOP_SPAN
    return _Span(name, cat, args or None)


def chrome_trace(events=None):
    """The Chrome trace-event JSON document (dict) for ``events`` (default:
    the process ring's current contents)."""
    if events is None:
        events = _ring.snapshot()
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


def export_chrome_trace(path, events=None):
    """Write a Perfetto/chrome://tracing-loadable JSON file; returns the
    number of events written."""
    doc = chrome_trace(events)
    with open(path, 'w') as f:
        json.dump(doc, f)
    return len(doc['traceEvents'])
