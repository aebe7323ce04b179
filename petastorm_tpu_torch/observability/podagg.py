"""Pod-scale telemetry: merge per-host exports, find the straggler (twin of
``petastorm_tpu/observability/podagg.py``).

On a multi-host job every host runs the same input pipeline, and the
data-parallel step blocks on the *slowest* one — a single starving host caps the whole pod's
duty cycle while every per-host dashboard looks "fine on average". This
module is the fleet view: it merges the host-stamped JSONL series that
:class:`~petastorm_tpu_torch.observability.exporters.JsonlExporter` writes (one
file per host, each line carrying a :func:`host_identity` stamp), computes
per-host *windowed* throughput and stall attribution (reusing
``history.window_delta`` so counters delta correctly), measures the skew
across hosts, and names the straggler:

* **throughput straggler** — a host whose windowed ``rows_per_s`` fell below
  ``straggler_ratio`` (default 0.7) of the pod median;
* **stall straggler** — no throughput outlier, but a host whose windowed
  ``reader_wait_fraction`` exceeds the pod median by more than
  ``stall_margin`` absolute (default 0.15).

The straggler record carries the host's own stall-report bottleneck and hint,
so the callout is actionable ("host2 is starving: decode-bound, raise
workers_count") rather than just a name. Rendered by
``python -m petastorm_tpu_torch.observability.diagnose --pod <dir>`` (add
``--watch`` to re-render live). The report is the JAX package's, key for
key: the same exports give the same report in either package.
See docs/observability.md and docs/troubleshooting.md ("which host is
starving the pod?").
"""

from __future__ import annotations

import json
import os
from statistics import median

from petastorm_tpu_torch.observability import history as _history
from petastorm_tpu_torch.observability import report as _report

DEFAULT_STRAGGLER_RATIO = 0.7
DEFAULT_STALL_MARGIN = 0.15


def load_host_series(path):
    """Read one exporter JSONL file into a host series::

        {'host': <key>, 'identity': {...} | None, 'path': ...,
         'snapshots': [{'ts', 'diag'}, ...]}

    The host key comes from the newest line's identity stamp (exports written
    before host stamping existed fall back to the file's basename). A rotated
    backup (``path + '.1'``) is read first when present, so the series spans
    both generations. Malformed lines are skipped."""
    snapshots = []
    identity = None
    for source in (path + '.1', path):
        if not os.path.exists(source):
            continue
        with open(source) as f:
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
                if not isinstance(diag, dict):
                    continue
                snapshots.append({'ts': float(rec['ts']), 'diag': diag})
                if isinstance(rec.get('host'), dict):
                    identity = rec['host']
    key = (identity or {}).get('host') or os.path.basename(path).rsplit('.', 1)[0]
    return {'host': key, 'identity': identity, 'path': path,
            'snapshots': snapshots}


def load_pod(source):
    """Load every host series of a pod. ``source`` is a directory (all
    ``*.jsonl`` files in it, sorted) or an iterable of file paths. Series
    sharing a host key are merged by snapshot time (a host that restarted
    into a new file stays one host)."""
    if isinstance(source, str):
        paths = sorted(os.path.join(source, name) for name in os.listdir(source)
                       if name.endswith('.jsonl'))
    else:
        paths = list(source)
    by_key = {}
    for path in paths:
        series = load_host_series(path)
        prev = by_key.get(series['host'])
        if prev is None:
            by_key[series['host']] = series
        else:
            prev['snapshots'].extend(series['snapshots'])
            prev['snapshots'].sort(key=lambda s: s['ts'])
            prev['identity'] = prev['identity'] or series['identity']
    return [by_key[k] for k in sorted(by_key)]


def host_window(series, seconds=None):
    """Windowed diagnostics for one host series: newest snapshot vs the oldest
    within ``seconds`` of it (whole series when None). None with <2
    snapshots."""
    snaps = series['snapshots']
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
    return _history.window_delta(older, newest)


def pod_report(source, seconds=None, straggler_ratio=DEFAULT_STRAGGLER_RATIO,
               stall_margin=DEFAULT_STALL_MARGIN):
    """The pod-level stall report::

        {'hosts': [{'host', 'window_s', 'rows_per_s', 'reader_wait_fraction',
                    'bottleneck', 'hint', 'snapshots', 'identity'}, ...],
         'median_rows_per_s', 'throughput_skew', 'straggler': {...} | None}

    ``source`` is anything :func:`load_pod` accepts, or an already-loaded
    series list. ``throughput_skew`` is slowest/fastest windowed ``rows_per_s``
    (1.0 = perfectly even; None with <2 measurable hosts). The ``straggler``
    record names the host, the reason (``'throughput'`` or ``'stall'``), the
    measurement vs the pod median, and the host's own bottleneck attribution.
    """
    hosts = source if isinstance(source, list) else load_pod(source)
    rows = []
    for series in hosts:
        win = host_window(series, seconds)
        newest = series['snapshots'][-1]['diag'] if series['snapshots'] else {}
        entry = {'host': series['host'], 'identity': series['identity'],
                 'snapshots': len(series['snapshots']), 'window_s': None,
                 'rows_per_s': None, 'reader_wait_fraction': None,
                 'bottleneck': None, 'hint': None,
                 # elastic membership view (None = host not running elastic):
                 # a host stuck on an old generation after a reshard is the
                 # elastic analogue of a straggler (docs/parallelism.md)
                 'elastic_generation': newest.get('elastic_generation'),
                 'elastic_members': newest.get('elastic_member_count'),
                 # hang-watchdog evidence (observability/blackbox.py): a host
                 # with stall dumps is wedged, not merely slow — different
                 # remedy (post-mortem the flight files, not tune knobs)
                 'watchdog_stalls': int(newest.get('watchdog_stall_total', 0) or 0),
                 'watchdog_last_dump_ts': newest.get('watchdog_last_dump_ts')}
        if win is not None:
            rep = _report.stall_report(win)
            entry.update({'window_s': win.get('window_s'),
                          'rows_per_s': win.get('rows_per_s'),
                          'reader_wait_fraction': win.get('reader_wait_fraction'),
                          'bottleneck': rep.get('bottleneck'),
                          'hint': rep.get('hint')})
        rows.append(entry)
    rates = [r['rows_per_s'] for r in rows if r['rows_per_s']]
    med_rate = round(median(rates), 2) if rates else None
    skew = round(min(rates) / max(rates), 4) if len(rates) >= 2 and max(rates) else None
    generations = {r['host']: r['elastic_generation'] for r in rows
                   if r['elastic_generation'] is not None}
    elastic = None
    if generations:
        elastic = {'generations': generations,
                   'agreed': len(set(generations.values())) == 1}
    out = {'hosts': rows, 'median_rows_per_s': med_rate,
           'throughput_skew': skew, 'straggler': None, 'elastic': elastic}
    if med_rate:
        slow = [r for r in rows
                if r['rows_per_s'] is not None
                and r['rows_per_s'] < straggler_ratio * med_rate]
        if slow:
            worst = min(slow, key=lambda r: r['rows_per_s'])
            out['straggler'] = {'host': worst['host'], 'reason': 'throughput',
                                'rows_per_s': worst['rows_per_s'],
                                'pod_median_rows_per_s': med_rate,
                                'ratio': round(worst['rows_per_s'] / med_rate, 4),
                                'bottleneck': worst['bottleneck'],
                                'hint': worst['hint']}
            return out
    waits = [r['reader_wait_fraction'] for r in rows
             if r['reader_wait_fraction'] is not None]
    if len(waits) >= 2:
        med_wait = median(waits)
        stalled = [r for r in rows
                   if r['reader_wait_fraction'] is not None
                   and r['reader_wait_fraction'] - med_wait > stall_margin]
        if stalled:
            worst = max(stalled, key=lambda r: r['reader_wait_fraction'])
            out['straggler'] = {'host': worst['host'], 'reason': 'stall',
                                'reader_wait_fraction': worst['reader_wait_fraction'],
                                'pod_median_wait_fraction': round(med_wait, 4),
                                'bottleneck': worst['bottleneck'],
                                'hint': worst['hint']}
    return out


def format_pod_report(report):
    """Human-readable pod view (diagnose --pod)."""
    lines = ['pod: {} host(s), median {} rows/s, throughput skew {}'.format(
        len(report['hosts']),
        report['median_rows_per_s'] if report['median_rows_per_s'] is not None else '?',
        report['throughput_skew'] if report['throughput_skew'] is not None else '?')]
    show_elastic = bool(report.get('elastic'))
    lines.append('{:<16s} {:>12s} {:>8s} {:>7s}{}  {}'.format(
        'host', 'rows_per_s', 'wait', 'snaps',
        ' {:>9s}'.format('elastic') if show_elastic else '', 'bottleneck'))
    for r in report['hosts']:
        if show_elastic:
            gen = r.get('elastic_generation')
            cell = (' {:>9s}'.format('g{:.0f}/{:.0f}h'.format(
                gen, r.get('elastic_members') or 0))
                if gen is not None else ' {:>9s}'.format('-'))
        else:
            cell = ''
        lines.append('{:<16s} {:>12s} {:>8s} {:>7d}{}  {}'.format(
            r['host'],
            '{:.2f}'.format(r['rows_per_s']) if r['rows_per_s'] is not None else '-',
            '{:.1%}'.format(r['reader_wait_fraction'])
            if r['reader_wait_fraction'] is not None else '-',
            r['snapshots'], cell, r['bottleneck'] or '-'))
    if show_elastic and not report['elastic']['agreed']:
        lines.append('ELASTIC: hosts disagree on the shard-map generation {} — '
                     'a reshard is in progress, or a host cannot reach the '
                     'coordination directory'.format(
                         report['elastic']['generations']))
    wedged = [r for r in report['hosts'] if r.get('watchdog_stalls')]
    for r in wedged:
        lines.append('WATCHDOG {}: {} stall dump(s) recorded — the host stopped '
                     'making progress mid-stage; run `python -m petastorm_tpu_torch.observability.blackbox` '
                     'on its flight directory for the wedged stacks'.format(
                         r['host'], r['watchdog_stalls']))
    s = report['straggler']
    if s is None:
        lines.append('no straggler: the pod is balanced within thresholds')
    elif s['reason'] == 'throughput':
        lines.append('STRAGGLER {}: {:.2f} rows/s vs pod median {:.2f} '
                     '({}x)'.format(s['host'], s['rows_per_s'],
                                    s['pod_median_rows_per_s'], s['ratio']))
        if s['hint']:
            lines.append('  its bottleneck: {} — {}'.format(s['bottleneck'], s['hint']))
    else:
        lines.append('STRAGGLER {}: input-wait {:.1%} vs pod median {:.1%}'.format(
            s['host'], s['reader_wait_fraction'], s['pod_median_wait_fraction']))
        if s['hint']:
            lines.append('  its bottleneck: {} — {}'.format(s['bottleneck'], s['hint']))
    return '\n'.join(lines)
