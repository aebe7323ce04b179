"""``python -m petastorm_tpu_torch.observability.diagnose``: one-shot pipeline
health check for a dataset (twin of ``petastorm_tpu/observability/diagnose.py``).

Runs a short measured read through the full loader pipeline
(:class:`~petastorm_tpu_torch.torch.TorchDataLoader`, batches staged on the
card unless ``--device cpu``) with telemetry on and prints the input-stall
attribution report, the key pipeline counters, and (optionally) a Chrome
trace / Prometheus exposition dump::

    python -m petastorm_tpu_torch.observability.diagnose file:///data/train \\
        --batches 50 --trace-out /tmp/pipeline.json --prom-out /tmp/metrics.prom

``--watch SECONDS`` switches to live mode: the read keeps running and the
stall report + fused-fallback table re-render every interval from **windowed
history** (``observability/history.py``) — each tick attributes the last
interval's wait, not the cumulative totals, and regressions between windows
are called out. ``--json`` stays machine-readable per tick (one JSON line
each); every line also carries the tick's cumulative diagnostics under
``diag``, which makes the output a replayable history for
``python -m petastorm_tpu_torch.autotune.cli`` (the JAX package's lines lack
it, so its history loader finds no snapshot in them).

``--batch TRACE_ID`` (or ``--batch slowest``) adds per-batch causal tracing
to the one-shot read: the slowest-batches table, the chosen batch's full
cross-process span tree, and its critical path
(``observability/critical_path.py``).

``--pod DIR`` renders the fleet instead of reading a dataset: DIR holds the
host-stamped JSONL exports of a pod's hosts (one
:class:`~petastorm_tpu_torch.observability.exporters.JsonlExporter` file
each), and the pod report names per-host throughput/stall and the straggler
host (``observability/podagg.py``). Combine with ``--watch SECONDS`` to
re-render live as the hosts keep exporting.

``--postmortem [DIR]`` reconstructs a dead or hung run from the flight
recorder's crash-persistent files (``observability/blackbox.py``): per-process
crash cause, the stage each process died in, and the last window's stall
report, as ``python -m petastorm_tpu_torch.observability.blackbox`` does.

``--serve DIR`` prints the per-tenant table of the serve daemon under DIR.
``--fabric DIR`` (the chunk fabric's per-peer table) waits for the port of
the fabric (ROADMAP.md, "fabric") and raises :class:`NotImplementedError`.

Open traces in https://ui.perfetto.dev (or chrome://tracing). See
``docs/observability.md`` for how to read the output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from petastorm_tpu_torch import observability as obs


def _loader(reader, batch_size, device):
    """The measured loader, staging its batches on ``device``."""
    from petastorm_tpu_torch.torch import TorchDataLoader
    return TorchDataLoader(reader, batch_size=batch_size, drop_last=False, to_device=device)


def diagnose(dataset_url, batch_size=64, batches=50, pool_type='thread',
             workers_count=3, telemetry='spans', use_batch_reader=False,
             reader_kwargs=None, device=None):
    """Read ``batches`` batches, staged on ``device`` (None: the card), and
    return ``(stall_report_dict, diagnostics)``."""
    from petastorm_tpu_torch.device import resolve_device
    device = resolve_device(device)  # no CUDA and no device='cpu': fail before any read

    obs.configure(telemetry)
    if use_batch_reader:
        from petastorm_tpu_torch.reader import make_batch_reader as factory
        extra = {}
    else:
        from petastorm_tpu_torch.reader import make_reader as factory
        extra = {'output': 'columnar'}
    reader = factory(dataset_url, reader_pool_type=pool_type,
                     workers_count=workers_count, num_epochs=None,
                     telemetry=telemetry, **dict(extra, **(reader_kwargs or {})))
    # the loader context owns the reader: its exit stops and joins it
    with _loader(reader, batch_size, device) as loader:
        it = iter(loader)
        for _ in range(batches):
            next(it)
        diag = loader.diagnostics
        return obs.stall_report(diag), diag


def fused_fallback_table(diagnostics):
    """``{column: {reason: count}}`` parsed from the labelled
    ``fused_fallback_column:<col>:<reason>`` counters — the per-column answer
    to "why is this column still on the Arrow path" (docs/native.md lists the
    reason catalog). Empty when every requested column fused (or the store
    predates the counters)."""
    table = {}
    for key, value in diagnostics.items():
        if not key.startswith('fused_fallback_column:'):
            continue
        try:
            _prefix, column, reason = key.split(':', 2)
        except ValueError:
            continue
        table.setdefault(column, {})[reason] = int(value)
    return table


#: fallback reason -> one-line remedy appended under the table when present
_FALLBACK_REMEDIES = {
    'predicate': 'predicate shape not natively evaluable — see docs/native.md '
                 'qualification matrix (in_lambda, string sets and partition-key '
                 'predicates stay on the Python path)',
    'compression': 'codec off the fused path (GZIP/BROTLI/LZO) — rewrite the '
                   'store with snappy/zstd/lz4 (materialize_dataset compression=)',
}


def format_fused_fallbacks(diagnostics):
    """Human-readable per-column fallback section (empty string when every
    column rode the fused/zero-copy native path)."""
    table = fused_fallback_table(diagnostics)
    if not table:
        return ''
    lines = ['fused-decode fallbacks (column -> reason x count; see '
             'docs/native.md for the reason catalog):']
    seen_reasons = set()
    for column in sorted(table):
        reasons = ', '.join('{} x{}'.format(r, c)
                            for r, c in sorted(table[column].items()))
        lines.append('  {:<24s} {}'.format(column, reasons))
        seen_reasons.update(table[column])
    for reason in sorted(seen_reasons & set(_FALLBACK_REMEDIES)):
        lines.append('  remedy[{}]: {}'.format(reason, _FALLBACK_REMEDIES[reason]))
    return '\n'.join(lines)


def serve_tenant_table(stats):
    """``{tenant_id: row}`` parsed from a serve daemon's stats document
    (``ReaderService.stats()`` / the control-plane ``stats`` op): per-tenant
    batches/bytes served, shared-decode hits, eviction flag, and the owning
    stream's fair-share occupancy (docs/serve.md)."""
    table = {}
    for stream_id, stream in (stats or {}).get('streams', {}).items():
        occupancy = stream.get('fair_share', {}).get('occupancy')
        for tenant_id, t in stream.get('tenants', {}).items():
            table[tenant_id] = {
                'stream': stream_id[:8],
                'dataset': stream.get('dataset_url'),
                'batches': t.get('batches_served', 0),
                'mbytes': round(t.get('bytes_served', 0) / 1e6, 1),
                'shared_hits': t.get('shared_decode_hits', 0),
                'weight': t.get('weight', 1),
                'occupancy': occupancy,
                'evicted': t.get('evicted', False),
            }
    return table


def format_serve_tenants(stats):
    """Human-readable per-tenant serving table (empty string when the daemon
    serves no tenants)."""
    table = serve_tenant_table(stats)
    if not table:
        return ''
    lines = ['serve tenants (batches / MB served, shared-decode hits, '
             'fair-share occupancy; docs/serve.md):',
             '  {:<8} {:<9} {:>8} {:>9} {:>12} {:>7} {:>10} {:>8}'.format(
                 'tenant', 'stream', 'batches', 'MB', 'shared_hits', 'weight',
                 'occupancy', 'evicted')]
    for tenant_id in sorted(table):
        row = table[tenant_id]
        lines.append('  {:<8} {:<9} {:>8} {:>9} {:>12} {:>7} {:>10} {:>8}'.format(
            tenant_id, row['stream'], row['batches'], row['mbytes'],
            row['shared_hits'], row['weight'],
            '-' if row['occupancy'] is None else row['occupancy'],
            'YES' if row['evicted'] else ''))
    lines.append('  evictions total: {}'.format((stats or {}).get('evictions', 0)))
    return '\n'.join(lines)


def diagnose_serve(service_dir, as_json=False, stream=None):
    """Connect to the serve daemon under ``service_dir`` and print its
    per-tenant serving table + pool diagnostics. Returns 0, or 1 when no
    daemon is reachable."""
    stream = stream if stream is not None else sys.stdout
    from petastorm_tpu_torch.serve.service import read_endpoint
    endpoint = read_endpoint(service_dir)
    if endpoint is None:
        print('no serve daemon endpoint under {} (is the daemon running?)'
              .format(service_dir), file=stream)
        return 1
    from multiprocessing.connection import Client
    try:
        conn = Client(endpoint['address'], family='AF_UNIX')
    except (OSError, ConnectionError) as e:
        print('serve daemon endpoint {} unreachable: {}'.format(
            endpoint['address'], e), file=stream)
        return 1
    try:
        conn.send({'op': 'stats'})
        reply = conn.recv()
    finally:
        conn.close()
    stats = reply.get('stats', {}) if reply.get('ok') else {}
    if as_json:
        print(json.dumps({'serve_stats': stats,
                          'tenants': serve_tenant_table(stats)}), file=stream)
        return 0
    table = format_serve_tenants(stats)
    print(table if table else 'serve daemon pid {} is up with no tenants'.format(
        stats.get('pid')), file=stream)
    pool = stats.get('pool', {})
    if pool:
        print('daemon pool:', file=stream)
        for key in sorted(pool):
            print('  {} = {}'.format(key, pool[key]), file=stream)
    return 0


def show_batch(batch_id='slowest', events=None, stream=None, top=10):
    """Render the slowest-batches table plus the selected batch's span tree
    and critical path from ``events`` (default: this process's trace ring).
    ``batch_id`` is a trace id (``'<ns>:<seq>'``) or ``'slowest'``. Returns 0,
    or 1 when no traced batches / no such trace exist."""
    stream = stream if stream is not None else sys.stdout
    if events is None:
        events = obs.get_ring().snapshot()
    rows = obs.slowest_batches(events, top=top)
    if not rows:
        print('no traced batches in the ring (tracing needs telemetry=spans)',
              file=stream)
        return 1
    print(obs.format_slowest_batches(rows), file=stream)
    trace_id = rows[0]['trace'] if batch_id in (None, 'slowest') else batch_id
    tree = obs.span_tree(events, trace_id)
    if tree is None:
        print('trace {} not found in the ring (rotated out, or never traced)'
              .format(trace_id), file=stream)
        return 1
    print(obs.format_span_tree(tree), file=stream)
    print(obs.format_critical_path(obs.critical_path(tree)), file=stream)
    return 0


def watch_pod(pod_dir, interval_s=2.0, ticks=None, window_s=None,
              as_json=False, stream=None):
    """Re-render the pod report from the exports under ``pod_dir`` every
    ``interval_s`` while the hosts keep appending. ``ticks`` bounds the run
    (None = until interrupted). Returns the number of ticks rendered."""
    stream = stream if stream is not None else sys.stdout
    rendered = 0
    try:
        while ticks is None or rendered < ticks:
            report = obs.pod_report(pod_dir, seconds=window_s)
            rendered += 1
            if as_json:
                print(json.dumps({'tick': rendered, 'ts': round(time.time(), 3),
                                  'pod': report}), file=stream, flush=True)
            else:
                print('--- pod tick {} ---'.format(rendered), file=stream)
                print(obs.format_pod_report(report), file=stream)
                stream.flush()
            if ticks is None or rendered < ticks:
                time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return rendered


def watch(dataset_url, interval_s=2.0, ticks=None, batch_size=64,
          pool_type='thread', workers_count=3, telemetry='counters',
          use_batch_reader=False, reader_kwargs=None, as_json=False,
          stream=None, device=None):
    """Live mode: pump the loader on a background thread and re-render the
    WINDOWED stall report + fused-fallback table every ``interval_s``. Each
    tick covers only the last window (``observability/history.py``), so a
    bottleneck that appears mid-run shows up within one interval instead of
    being diluted by the cumulative totals. ``ticks`` bounds the run (None =
    until interrupted). Batches are staged on ``device`` (None: the card).
    Returns the number of ticks rendered."""
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.observability import history as _history

    device = resolve_device(device)  # no CUDA and no device='cpu': fail before any read

    stream = stream if stream is not None else sys.stdout
    obs.configure(telemetry)
    if use_batch_reader:
        from petastorm_tpu_torch.reader import make_batch_reader as factory
        extra = {}
    else:
        from petastorm_tpu_torch.reader import make_reader as factory
        extra = {'output': 'columnar'}
    reader = factory(dataset_url, reader_pool_type=pool_type,
                     workers_count=workers_count, num_epochs=None,
                     telemetry=telemetry, **dict(extra, **(reader_kwargs or {})))
    stop = threading.Event()
    rendered = 0
    with _loader(reader, batch_size, device) as loader:

        def pump():
            try:
                for _ in loader:
                    if stop.is_set():
                        return
            except Exception:  # noqa: BLE001 - shutdown race on stop(): the watch loop already ended
                pass

        pump_thread = threading.Thread(target=pump, daemon=True,
                                       name='pstpu-torch-watch-pump')
        pump_thread.start()
        recorder = _history.HistoryRecorder(lambda: loader.diagnostics,
                                            interval_s=interval_s)
        recorder.record_now()
        try:
            while ticks is None or rendered < ticks:
                time.sleep(interval_s)
                snap = recorder.record_now()
                window = recorder.window_last()
                if window is None:
                    continue
                rendered += 1
                report = _history.windowed_stall_report(window)
                regression = recorder.regression()
                fallbacks = fused_fallback_table(
                    {k: v for k, v in window.items()
                     if not (k.startswith('fused_fallback_column:') and not v)})
                if as_json:
                    print(json.dumps({'tick': rendered, 'ts': round(time.time(), 3),
                                      'host': obs.host_identity(),
                                      'window': report,
                                      'fused_fallbacks': fallbacks,
                                      'regression': regression,
                                      'diag': snap['diag'] if snap else None}),
                          file=stream, flush=True)
                    continue
                print('--- watch tick {} (window {:.1f}s, {} rows/s) ---'.format(
                    rendered, window['window_s'],
                    window['rows_per_s'] if window['rows_per_s'] is not None else '?'),
                    file=stream)
                print(obs.format_stall_report(report), file=stream)
                if fallbacks:
                    lines = ['fused-decode fallbacks this window:']
                    for column in sorted(fallbacks):
                        lines.append('  {:<24s} {}'.format(column, ', '.join(
                            '{} x{}'.format(r, c)
                            for r, c in sorted(fallbacks[column].items()))))
                    print('\n'.join(lines), file=stream)
                if regression is not None:
                    print('  REGRESSION between windows: {}'.format(regression),
                          file=stream)
                stream.flush()
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
    # the loader context has stopped the reader: the pump's next() unblocks
    # with StopIteration; join it so no thread outlives this call mid-teardown
    pump_thread.join(timeout=10)
    return rendered


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.observability.diagnose',
        description='Measure a short read of the dataset and attribute input '
                    'stalls to pipeline stages.')
    parser.add_argument('dataset_url', nargs='?', default=None)
    parser.add_argument('--serve', metavar='SERVICE_DIR', default=None,
                        help='instead of reading a dataset, connect to the '
                             'serve daemon under SERVICE_DIR and print its '
                             'per-tenant serving table (docs/serve.md)')
    parser.add_argument('--pod', metavar='DIR', default=None,
                        help='instead of reading a dataset, merge the '
                             'host-stamped JSONL exports under DIR and print '
                             'the pod report (per-host throughput/stall, '
                             'straggler callout); combine with --watch to '
                             're-render live')
    parser.add_argument('--fabric', metavar='DIR', default=None,
                        help='instead of reading a dataset, merge the fabric '
                             'client stats under the pod coordination dir DIR '
                             'and print the per-peer table (docs/fabric.md); '
                             'not ported yet: raises NotImplementedError '
                             '(ROADMAP.md, "fabric")')
    parser.add_argument('--postmortem', metavar='DIR', nargs='?', const='',
                        default=None,
                        help='instead of reading a dataset, merge the crash-'
                             'persistent flight files under DIR (default: the '
                             'PSTPU_FLIGHT_DIR run dir) and print the post-'
                             'mortem: per-process crash cause, dying stage, '
                             'windowed stall report (docs/troubleshooting.md)')
    parser.add_argument('--last', type=float, default=30.0, metavar='SECONDS',
                        help='with --postmortem: the stall-report window')
    parser.add_argument('--batch', metavar='TRACE_ID', default=None,
                        help="after the measured read, print the slowest-"
                             "batches table plus this batch's span tree and "
                             "critical path ('slowest' picks the worst; "
                             "implies --telemetry spans)")
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--batches', type=int, default=50)
    parser.add_argument('-p', '--pool-type', choices=('thread', 'process', 'dummy'),
                        default='thread')
    parser.add_argument('-w', '--workers-count', type=int, default=3)
    parser.add_argument('--batch-reader', action='store_true',
                        help='use make_batch_reader (plain Parquet stores)')
    parser.add_argument('--telemetry', choices=('counters', 'spans'), default='spans')
    parser.add_argument('--device', default=None,
                        help="where the loader stages batches (default: the CUDA "
                             "card; 'cpu' to measure the host pipeline alone)")
    parser.add_argument('--trace-out', default=None,
                        help='write a Perfetto-loadable Chrome trace JSON here')
    parser.add_argument('--prom-out', default=None,
                        help='write a Prometheus text exposition snapshot here')
    parser.add_argument('--json', action='store_true', dest='as_json',
                        help='print the report as JSON instead of text (in '
                             '--watch mode: one JSON line per tick)')
    parser.add_argument('--watch', type=float, default=None, metavar='SECONDS',
                        help='live mode: re-render the stall report from '
                             'windowed history every SECONDS instead of one '
                             'cumulative snapshot')
    parser.add_argument('--ticks', type=int, default=0,
                        help='with --watch: stop after this many rendered '
                             'ticks (0 = run until interrupted)')
    args = parser.parse_args(argv)

    if args.postmortem is not None:
        from petastorm_tpu_torch.observability import blackbox
        run_dir = args.postmortem or blackbox.default_dir()
        if not os.path.isdir(run_dir):
            print('no flight directory at {} (was recording enabled? '
                  'PSTPU_FLIGHT_DIR relocates it)'.format(run_dir),
                  file=sys.stderr)
            return 1
        report = blackbox.postmortem_report(run_dir, last_s=args.last)
        if args.as_json:
            print(json.dumps(report, default=repr))
        else:
            print(blackbox.format_postmortem(report))
        return 0
    if args.fabric is not None:
        raise NotImplementedError('diagnose --fabric is not yet ported to petastorm_tpu_torch '
                                  '(ROADMAP.md, "fabric")')
    if args.serve is not None:
        return diagnose_serve(args.serve, as_json=args.as_json)
    if args.pod is not None:
        if args.watch is not None:
            watch_pod(args.pod, interval_s=args.watch, ticks=args.ticks or None,
                      as_json=args.as_json)
            return 0
        report = obs.pod_report(args.pod)
        if args.as_json:
            print(json.dumps({'pod': report, 'host': obs.host_identity()}))
        else:
            print(obs.format_pod_report(report))
        return 0
    if args.dataset_url is None:
        parser.error('dataset_url is required (or pass --serve SERVICE_DIR / '
                     '--pod DIR / --fabric DIR)')

    if args.watch is not None:
        watch(args.dataset_url, interval_s=args.watch,
              ticks=args.ticks or None, batch_size=args.batch_size,
              pool_type=args.pool_type, workers_count=args.workers_count,
              telemetry=args.telemetry, use_batch_reader=args.batch_reader,
              as_json=args.as_json, device=args.device)
        return 0

    telemetry = 'spans' if (args.trace_out or args.batch) else args.telemetry
    report, diag = diagnose(args.dataset_url, batch_size=args.batch_size,
                            batches=args.batches, pool_type=args.pool_type,
                            workers_count=args.workers_count, telemetry=telemetry,
                            use_batch_reader=args.batch_reader, device=args.device)
    # every snapshot names the host that measured it, so dumps collected
    # across a pod stay attributable after they leave the machine
    ident = obs.host_identity()
    if args.as_json:
        print(json.dumps({'host': ident, 'stall_report': report,
                          'fused_fallbacks': fused_fallback_table(diag),
                          'diagnostics': {k: v for k, v in sorted(diag.items())}}))
    else:
        print('host: {} (pid {})'.format(ident['host'], ident['pid']))
        print(obs.format_stall_report(report))
        fallbacks = format_fused_fallbacks(diag)
        if fallbacks:
            print(fallbacks)
        print('diagnostics:')
        for key in sorted(diag):
            print('  {} = {}'.format(key, diag[key]))
    if args.batch:
        show_batch(args.batch)
    if args.trace_out:
        n = obs.export_chrome_trace(args.trace_out)
        print('wrote {} trace events to {} (open in https://ui.perfetto.dev)'.format(
            n, args.trace_out))
    if args.prom_out:
        obs.write_prometheus(args.prom_out)
        print('wrote Prometheus exposition to {}'.format(args.prom_out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
