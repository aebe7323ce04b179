"""Windowed telemetry history: the time dimension of the stall report (twin
of ``petastorm_tpu/observability/history.py``).

Every counter the telemetry registry accumulates is cumulative-since-start, so
``stall_report`` over raw diagnostics answers "what dominated the whole run" —
useless for a controller (or an operator watching a live run) that needs to
know what dominates *right now*. This module adds the missing axis:

* :class:`HistoryRecorder` — a bounded time series of diagnostics snapshots,
  taken on a cadence (background thread) or on demand (``record_now``);
* **window deltas** — the diagnostics *difference* between two snapshots:
  counters subtract, gauges take their latest value, and derived rates
  (``rows_per_s``, a recomputed ``reader_wait_fraction``) are computed over
  the window's wall span, so :func:`windowed_stall_report` attributes the
  *last N seconds*, not the cumulative totals;
* **regression detection** — :func:`detect_regression` compares consecutive
  windows and names a throughput drop or stall rise between them;
* **persistence** — :meth:`HistoryRecorder.save`/:func:`load_history` write/
  read a JSONL file (one snapshot per line), the JAX package's layout, so
  its offline tools read the port's history. The
  :class:`~petastorm_tpu_torch.observability.exporters.JsonlExporter` format (``{"ts": ..., "metrics": {...}}``) is accepted too.

Readers with no loader attached have no ``reader_wait_s``; a window then
falls back to the pool-wait seconds as the wait signal and marks itself with
``wait_proxy='pool_wait'`` — the attribution stays honest about what it
measured. The recorder is cheap by construction: one ``diagnostics`` snapshot
per tick (dict merge + flatten, no per-row work), bounded deque storage, and
nothing at all when never started — ``autotune=False`` readers build no
recorder and pay zero.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from petastorm_tpu_torch.observability import report as _report

#: default snapshot cadence; at one flatten/merge per second the recorder
#: stays far under 1% of a pipeline's time
DEFAULT_INTERVAL_S = 1.0

#: default snapshot retention (covers 10 min at the default cadence)
DEFAULT_CAPACITY = 600

#: diagnostics keys that are point-in-time readings, not monotonic
#: accumulators: a window takes their LATEST value instead of a delta
_GAUGE_SUFFIXES = ('_fraction', '_occupancy', '_depth', '_in_flight',
                   '_age_s', '_pinned', '_count_current')
_GAUGE_KEYS = frozenset({'workers_count'})


def _is_gauge_key(name):
    return name in _GAUGE_KEYS or name.endswith(_GAUGE_SUFFIXES)


def window_delta(older, newer):
    """The windowed diagnostics dict between two snapshots (each a
    ``{'ts': epoch_s, 'diag': {...}}`` mapping): counter keys subtract
    (clamped at 0 — a reset registry must not produce negative seconds),
    gauge keys carry the newer reading, and the derived keys below are added:

    * ``window_s`` — wall span of the window;
    * ``rows_per_s`` — ``rows_emitted`` delta over the span (None without a
      loader);
    * ``reader_wait_s``/``reader_wait_fraction`` — recomputed over the window
      (falling back to the pool-wait stage seconds when no loader wait is
      recorded, marked ``wait_proxy='pool_wait'``).
    """
    span_s = max(float(newer['ts']) - float(older['ts']), 1e-9)
    old_d, new_d = older['diag'], newer['diag']
    out = {}
    for name, value in new_d.items():
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if _is_gauge_key(name):
            out[name] = value
        else:
            prev = old_d.get(name, 0)
            prev = prev if isinstance(prev, (int, float)) else 0
            out[name] = max(value - prev, 0)
    out['window_s'] = round(span_s, 4)
    rows = out.get('rows_emitted')
    out['rows_per_s'] = (round(rows / span_s, 2)
                         if isinstance(rows, (int, float)) and 'rows_emitted' in new_d
                         else None)
    wait = out.get('reader_wait_s', 0.0) or 0.0
    out['wait_proxy'] = None
    if wait <= 0.0 and 'reader_wait_s' not in new_d:
        # bare Reader (no loader): the consumer's blocked time is the
        # pool-wait stage, measured inside get_results
        wait = out.get('stage_pool_wait_s', 0.0) or 0.0
        out['reader_wait_s'] = round(wait, 4)
        out['wait_proxy'] = 'pool_wait'
    out['reader_wait_fraction'] = round(min(wait / span_s, 1.0), 4)
    return out


def windowed_stall_report(window):
    """:func:`petastorm_tpu_torch.observability.stall_report` over a window delta —
    attribution of the window's wait, not the run's. The window's derived
    keys (``window_s``, ``rows_per_s``, ``wait_proxy``) are carried along."""
    rep = _report.stall_report(window)
    rep['window_s'] = window.get('window_s')
    rep['rows_per_s'] = window.get('rows_per_s')
    rep['wait_proxy'] = window.get('wait_proxy')
    return rep


def detect_regression(prev_window, cur_window, throughput_ratio=0.7,
                      stall_rise=0.15):
    """Compare two consecutive windows; return a regression record or None.

    * ``throughput_drop`` — the newer window's ``rows_per_s`` fell below
      ``throughput_ratio`` of the older one's;
    * ``stall_rise`` — the windowed ``reader_wait_fraction`` rose by more
      than ``stall_rise`` absolute.
    """
    if prev_window is None or cur_window is None:
        return None
    prev_rate, cur_rate = prev_window.get('rows_per_s'), cur_window.get('rows_per_s')
    if prev_rate and cur_rate is not None and cur_rate < throughput_ratio * prev_rate:
        return {'kind': 'throughput_drop', 'from_rows_per_s': prev_rate,
                'to_rows_per_s': cur_rate,
                'ratio': round(cur_rate / prev_rate, 4)}
    prev_wait = prev_window.get('reader_wait_fraction') or 0.0
    cur_wait = cur_window.get('reader_wait_fraction') or 0.0
    if cur_wait - prev_wait > stall_rise:
        return {'kind': 'stall_rise', 'from_fraction': prev_wait,
                'to_fraction': cur_wait}
    return None


class HistoryRecorder(object):
    """Bounded time series of diagnostics snapshots.

    :param diagnostics_fn: zero-arg callable returning the flat diagnostics
        mapping to record (``Reader.diagnostics`` / ``TorchDataLoader.diagnostics``
        / any dict source)
    :param interval_s: background cadence for :meth:`start`; :meth:`record_now`
        works without a thread
    :param capacity: snapshots retained (oldest rotate out)
    """

    def __init__(self, diagnostics_fn, interval_s=DEFAULT_INTERVAL_S,
                 capacity=DEFAULT_CAPACITY):
        if interval_s <= 0:
            raise ValueError('interval_s must be > 0')
        if capacity < 2:
            raise ValueError('capacity must be >= 2 (a window needs two snapshots)')
        self._diagnostics_fn = diagnostics_fn
        self._interval_s = interval_s
        self._lock = threading.Lock()
        self._snapshots = deque(maxlen=capacity)
        self._stop_event = threading.Event()
        self._thread = None

    def __len__(self):
        with self._lock:
            return len(self._snapshots)

    @property
    def interval_s(self):
        return self._interval_s

    def record_now(self):
        """Take one snapshot immediately; returns it (``{'ts', 'diag'}``)."""
        try:
            diag = dict(self._diagnostics_fn())
        except Exception:  # noqa: BLE001 - a reader torn down mid-shutdown must not kill the thread
            return None
        snap = {'ts': time.time(), 'diag': diag}
        with self._lock:
            self._snapshots.append(snap)
        return snap

    def snapshots(self):
        with self._lock:
            return list(self._snapshots)

    # -- windows -------------------------------------------------------------

    def window(self, seconds=None):
        """Window delta between the newest snapshot and the oldest one within
        ``seconds`` of it (whole history when None). None with <2 snapshots."""
        with self._lock:
            snaps = list(self._snapshots)
        if len(snaps) < 2:
            return None
        newest = snaps[-1]
        older = snaps[0]
        if seconds is not None:
            horizon = newest['ts'] - seconds
            for snap in snaps[:-1]:
                if snap['ts'] >= horizon:
                    older = snap
                    break
            else:
                older = snaps[-2]
        return window_delta(older, newest)

    def window_last(self):
        """Delta between the two most recent snapshots — the controller's
        tick-to-tick evidence window."""
        with self._lock:
            if len(self._snapshots) < 2:
                return None
            older, newer = self._snapshots[-2], self._snapshots[-1]
        return window_delta(older, newer)

    def windowed_stall_report(self, seconds=None):
        win = self.window(seconds)
        return windowed_stall_report(win) if win is not None else None

    def regression(self, **kwargs):
        """Regression between the last two tick-to-tick windows, or None."""
        with self._lock:
            snaps = list(self._snapshots)[-3:]
        if len(snaps) < 3:
            return None
        return detect_regression(window_delta(snaps[0], snaps[1]),
                                 window_delta(snaps[1], snaps[2]), **kwargs)

    # -- background cadence --------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError('HistoryRecorder already started')
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pstpu-history')
        self._thread.start()
        return self

    def _loop(self):
        self.record_now()
        while not self._stop_event.wait(self._interval_s):
            self.record_now()

    def stop(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        return False

    # -- persistence ---------------------------------------------------------

    def save(self, path):
        """Write the retained snapshots as JSONL (one ``{'ts', 'diag'}`` per
        line), the JAX package's layout. Returns
        the number of lines written."""
        snaps = self.snapshots()
        with open(path, 'w') as f:
            for snap in snaps:
                f.write(json.dumps(snap) + '\n')
        return len(snaps)


def load_history(path):
    """Read a history JSONL file into a snapshot list. Accepts both the
    :meth:`HistoryRecorder.save` format (``{'ts', 'diag'}``) and the
    :class:`~petastorm_tpu_torch.observability.exporters.JsonlExporter` format
    (``{'ts', 'metrics'}``). Malformed lines are skipped."""
    snaps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or 'ts' not in rec:
                continue
            diag = rec.get('diag', rec.get('metrics'))
            if isinstance(diag, dict):
                snaps.append({'ts': float(rec['ts']), 'diag': diag})
    return snaps


def history_windows(snapshots):
    """Consecutive tick-to-tick window deltas over a snapshot list (the
    evidence stream of an offline replay)."""
    return [window_delta(a, b) for a, b in zip(snapshots, snapshots[1:])]
