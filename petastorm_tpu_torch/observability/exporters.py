"""Metric exporters: Prometheus text exposition and periodic JSONL flush (twin
of ``petastorm_tpu/observability/exporters.py``, the same line layout).

Both consume :meth:`MetricsRegistry.snapshot` dicts, so they work equally on
the live process registry and on cross-process merges
(:func:`petastorm_tpu_torch.observability.metrics.merge_snapshots`).
"""

from __future__ import annotations

import atexit
import json
import os
import re
import socket
import sys
import threading
import time

from petastorm_tpu_torch.observability import metrics as _metrics

_NAME_SANITIZE = re.compile(r'[^a-zA-Z0-9_:]')

#: when this process started exporting — lets the pod aggregator tell a
#: restarted host (fresh counters) from a stalled one (same counters)
_BOOT_TS = round(time.time(), 3)


def host_identity(key=None):
    """This process's identity stamp for exported telemetry records::

        {'host': <short key>, 'process_index': <int|None>,
         'hostname': ..., 'pid': ..., 'boot_ts': <epoch s>}

    ``process_index`` is the ``torch.distributed`` rank when a process group
    is initialized (the check is on ``sys.modules``, so an export never
    triggers the import). ``key`` overrides the short host key (the pod
    aggregator's grouping label)."""
    process_index = None
    dist = sys.modules.get('torch.distributed')
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                process_index = int(dist.get_rank())
        except Exception:  # noqa: BLE001 - a torn-down group must not break exporting
            process_index = None
    hostname = socket.gethostname()
    pid = os.getpid()
    if key is None:
        key = ('proc{}'.format(process_index) if process_index is not None
               else '{}:{}'.format(hostname, pid))
    return {'host': key, 'process_index': process_index, 'hostname': hostname,
            'pid': pid, 'boot_ts': _BOOT_TS}


def _prom_name(name, prefix):
    return prefix + _NAME_SANITIZE.sub('_', name)


def to_prometheus_text(snapshot=None, prefix='pstpu_'):
    """Render a snapshot in the Prometheus text exposition format (0.0.4).

    Counters keep their name (``pstpu_rows_decoded_total``), gauges likewise;
    histograms expand to cumulative ``_bucket{le=...}`` series plus ``_sum``
    and ``_count``, per the exposition contract.
    """
    if snapshot is None:
        snapshot = _metrics.get_registry().snapshot()
    lines = []
    for name in sorted(snapshot.get('counters', {})):
        metric = _prom_name(name, prefix)
        lines.append('# TYPE {} counter'.format(metric))
        lines.append('{} {}'.format(metric, snapshot['counters'][name]))
    for name in sorted(snapshot.get('gauges', {})):
        metric = _prom_name(name, prefix)
        lines.append('# TYPE {} gauge'.format(metric))
        lines.append('{} {}'.format(metric, snapshot['gauges'][name]))
    for name in sorted(snapshot.get('histograms', {})):
        h = snapshot['histograms'][name]
        metric = _prom_name(name, prefix)
        lines.append('# TYPE {} histogram'.format(metric))
        cumulative = 0
        for bound, count in zip(h['bounds'], h['counts']):
            cumulative += count
            lines.append('{}_bucket{{le="{}"}} {}'.format(metric, bound, cumulative))
        lines.append('{}_bucket{{le="+Inf"}} {}'.format(metric, h['count']))
        lines.append('{}_sum {}'.format(metric, h['sum']))
        lines.append('{}_count {}'.format(metric, h['count']))
    return '\n'.join(lines) + '\n'


def write_prometheus(path, snapshot=None, prefix='pstpu_'):
    """One-shot exposition dump (node-exporter textfile-collector style)."""
    with open(path, 'w') as f:
        f.write(to_prometheus_text(snapshot, prefix=prefix))


def _count_lines(path):
    """Lines in ``path`` (0 when absent/unreadable). Bounded work: only ever
    called on rotated exports, whose size is capped by ``max_bytes``."""
    try:
        with open(path, 'rb') as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


class JsonlExporter(object):
    """Background thread appending one JSON line per interval to ``path``:
    ``{"ts": <epoch s>, "host": {...}, "metrics": {<flat name: value>}}``.
    Deterministic release via :meth:`stop`/:meth:`close` (or the context
    manager); the final flush runs on stop so short-lived runs still record
    their last state. A started exporter also registers an atexit hook, so a
    process that exits without stopping it still flushes the tail interval
    (the window a post-mortem needs most).

    Every line carries this process's :func:`host_identity` stamp so exports
    from several hosts can be merged by the pod aggregator
    of the JAX package; ``host_key`` overrides the short key.

    Output growth is bounded when ``max_bytes`` is set: once the file would
    exceed the cap it rotates to ``path + '.1'`` (one backup generation, so
    on-disk use stays under ~2x the cap), and lines discarded with an
    overwritten backup are counted into ``telemetry_export_dropped_total`` —
    a silent gap in a telemetry series should itself be visible in telemetry.
    """

    def __init__(self, path, interval_s=5.0, snapshot_fn=None, max_bytes=None,
                 host_key=None):
        if interval_s <= 0:
            raise ValueError('interval_s must be > 0')
        if max_bytes is not None and max_bytes < 1:
            raise ValueError('max_bytes must be >= 1 (or None for unbounded)')
        self._path = path
        self._interval_s = interval_s
        self._snapshot_fn = snapshot_fn or (lambda: _metrics.get_registry().snapshot())
        self._max_bytes = max_bytes
        self._host = host_identity(host_key)
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self._stop_event = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            raise RuntimeError('JsonlExporter already started')
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pstpu-metrics-jsonl')
        self._thread.start()
        # a process that exits without stop() (crash-adjacent teardown, a
        # script that just returns) would otherwise silently drop the tail
        # interval — exactly the window a post-mortem needs most
        atexit.register(self._atexit_flush)
        return self

    def _atexit_flush(self):
        """Final-window flush at interpreter exit for exporters never
        stopped explicitly. Routed through :meth:`stop` so the behavior is
        identical to a deliberate shutdown."""
        if self._thread is not None:
            try:
                self.stop()
            except Exception:  # noqa: BLE001 - interpreter teardown must never raise from an atexit hook
                pass

    def _maybe_rotate(self, pending_bytes):
        if (self._max_bytes is None or self._bytes == 0
                or self._bytes + pending_bytes <= self._max_bytes):
            return
        backup = self._path + '.1'
        dropped = _count_lines(backup)  # about to be overwritten
        if dropped and _metrics.counters_on():
            _metrics.get_registry().counter('telemetry_export_dropped_total').inc(dropped)
        try:
            os.replace(self._path, backup)
        except OSError:
            return  # keep appending to the old file rather than losing the flush
        self._bytes = 0

    def _flush(self):
        line = json.dumps({'ts': round(time.time(), 3), 'host': self._host,
                           'metrics': _metrics.flatten_snapshot(self._snapshot_fn())}) + '\n'
        self._maybe_rotate(len(line))
        with open(self._path, 'a') as f:
            f.write(line)
        self._bytes += len(line)

    def _loop(self):
        while not self._stop_event.wait(self._interval_s):
            self._flush()

    def stop(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            try:
                atexit.unregister(self._atexit_flush)
            except Exception:  # noqa: BLE001 - interpreter-shutdown race
                pass
        self._flush()

    #: deliberate alias: `close()` is the conventional name callers reach for
    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
