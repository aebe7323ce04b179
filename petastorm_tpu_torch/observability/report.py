"""Input-stall attribution: decompose the loader's ``reader_wait_s`` into
per-stage contributions and name the bottleneck (twin of
``petastorm_tpu/observability/report.py``).

The loader's ``reader_wait_s`` (time the consumer sat blocked in
``next(reader)``) is the online form of the BASELINE input-stall metric — but
a single number cannot say *why* the pipeline stalled. This module splits it
using the stage timers the telemetry layer accumulates:

* ``stage_pool_wait_s`` — measured **inside** ``pool.get_results`` (itself
  inside the reader-wait window): the share of the wait spent blocked on the
  worker pool's results transport.
* the remainder (``reader_wait_s - pool_wait``) is consumer-side assembly:
  row slicing / rebatching / ngram windowing in the results-queue reader.
* the pool-wait share is then attributed to the **worker** stages
  proportionally to their measured busy seconds (read IO, the fused native
  calls, decode, transform). For thread/dummy pools these
  timers live in the same process's registry; for the process pool they
  arrive merged from the workers' own registries.

The result attributes ~100% of the measured wait to *named* stages (the
acceptance bar is >=90%), so "is it IO, decode, shuffle starvation, or device
staging?" has a mechanical answer. The report is the JAX package's, key for
key, less what belongs to features the port lacks (the chunk cache's
``chunk_fetch`` stage and the mixture reader's per-source counts): one
diagnostics dict of a port reader gives the same report in either package.
"""

from __future__ import annotations

#: worker-side stage timers split proportionally under the pool wait, in
#: display order. 'read_io' is stage_read_s. 'fused_decode' is the
#: single-transition native read→decode→collate pass — its seconds INCLUDE
#: the page faults of cold chunks, so on cold storage it partially overlaps
#: what read_io would have shown.
_WORKER_STAGES = ('read_io', 'fused_predicate', 'fused_decode', 'decode', 'transform')

#: stage -> one-line remedy, surfaced next to the named bottleneck
#: the JAX package's hint texts, verbatim: one diagnostics dict gives one
#: report in either package
_HINTS = {
    'worker.read_io': 'storage-bound: enable chunk_cache for remote stores, or add IO parallelism (workers_count)',
    'worker.fused_predicate': 'fused predicate+decode dominates: tighten the predicate (page-stat skipping prunes more when clauses are selective) or add cores/workers (docs/native.md)',
    'worker.fused_decode': 'fused native decode dominates: add cores/workers — the pass is already one GIL-released call per batch (docs/native.md)',
    'worker.decode': 'decode-bound: more workers/cores, batched TransformSpec, image_decode_hints, or a RawTensorCodec store; check fused_fallback_reason:* counters for columns off the fused path',
    'worker.transform': 'transform-bound: vectorize with TransformSpec(batched=True)',
    'consumer.assembly': 'consumer-side slicing/rebatch: prefer output=columnar and larger batches',
    'pool.unattributed': 'workers idle or untimed: check ventilator starvation (items_in_flight) and results_queue_depth',
}


def stall_report(diagnostics):
    """Build the attribution dict from a diagnostics mapping (either
    ``TorchDataLoader.diagnostics`` or ``Reader.diagnostics`` merged with loader
    counters). Returns::

        {'reader_wait_s': ..., 'reader_wait_fraction': ...,
         'stages': {stage: seconds attributed},   # sums to ~reader_wait_s
         'attributed_s': ..., 'coverage': 0..1,
         'bottleneck': stage name or None, 'hint': str or None,
         'worker_busy_s': {stage: raw busy seconds}}
    """
    wait = float(diagnostics.get('reader_wait_s', 0.0) or 0.0)
    pool_wait = float(diagnostics.get('stage_pool_wait_s', 0.0) or 0.0)
    pool_wait = min(pool_wait, wait)
    assembly = max(wait - pool_wait, 0.0)

    busy = {
        'read_io': float(diagnostics.get('stage_read_s', 0.0) or 0.0),
        'fused_predicate': float(diagnostics.get('stage_fused_predicate_s', 0.0) or 0.0),
        'fused_decode': float(diagnostics.get('stage_fused_decode_s', 0.0) or 0.0),
        'decode': float(diagnostics.get('stage_decode_s', 0.0) or 0.0),
        'transform': float(diagnostics.get('stage_transform_s', 0.0) or 0.0),
    }
    total_busy = sum(busy.values())

    stages = {}
    if assembly > 0:
        stages['consumer.assembly'] = assembly
    if pool_wait > 0:
        if total_busy > 0:
            for name in _WORKER_STAGES:
                share = pool_wait * busy[name] / total_busy
                if share > 0:
                    stages['worker.' + name] = share
        else:
            # nothing timed on the worker side (telemetry off in workers, or
            # workers starved): name it rather than hide it
            stages['pool.unattributed'] = pool_wait

    attributed = sum(stages.values())
    coverage = (attributed / wait) if wait > 0 else 1.0
    bottleneck = max(stages, key=stages.get) if stages else None
    # supervision/recovery events: restarts and requeues
    # cost wall time that shows up as pool wait, so a stall report that hides
    # them would misattribute recovery overhead to IO/decode
    recovery = {k: int(diagnostics.get(k, 0) or 0)
                for k in ('worker_restarts', 'items_requeued', 'items_quarantined')}
    # hang-watchdog evidence (observability/blackbox.py): a run that STOPPED
    # making progress looks identical to a slow one in the rate counters —
    # the watchdog's stall dumps are the discriminator, so they ride along
    watchdog = {'stalls': int(diagnostics.get('watchdog_stall_total', 0) or 0)}
    last_dump = diagnostics.get('watchdog_last_dump_ts')
    if last_dump:
        import time as _time
        watchdog['last_dump_age_s'] = round(max(_time.time() - float(last_dump), 0.0), 1)
    return {
        'reader_wait_s': round(wait, 4),
        'reader_wait_fraction': diagnostics.get('reader_wait_fraction'),
        'stages': {k: round(v, 4) for k, v in sorted(
            stages.items(), key=lambda kv: -kv[1])},
        'attributed_s': round(attributed, 4),
        'coverage': round(coverage, 4),
        'bottleneck': bottleneck,
        'hint': _HINTS.get(bottleneck),
        'worker_busy_s': {k: round(v, 4) for k, v in busy.items()},
        'recovery': recovery,
        'watchdog': watchdog,
    }


def decode_collate_share(diagnostics):
    """The tentpole metric of the fused native path, machine-checkable from a
    diagnostics/flattened-snapshot mapping: Python decode + collate busy
    seconds as a fraction of pool wait (``None`` when nothing was timed).
    The fused pass itself is reported alongside (``fused_decode_share``) —
    it is GIL-released native work that replaces read+decode together, not a
    Python tail — so the pair shows WHERE the decode seconds went, not just
    that they left."""
    pool_wait = float(diagnostics.get('stage_pool_wait_s', 0.0) or 0.0)
    if pool_wait <= 0:
        return None
    tail = (float(diagnostics.get('stage_decode_s', 0.0) or 0.0) +
            float(diagnostics.get('stage_collate_s', 0.0) or 0.0))
    fused = float(diagnostics.get('stage_fused_decode_s', 0.0) or 0.0)
    return {'decode_collate_share': round(tail / pool_wait, 4),
            'fused_decode_share': round(fused / pool_wait, 4)}


def format_stall_report(report):
    """Human-readable rendering of :func:`stall_report`'s dict."""
    lines = ['stall report: reader_wait={:.3f}s'.format(report['reader_wait_s'])]
    frac = report.get('reader_wait_fraction')
    if frac is not None:
        lines[0] += ' ({:.1%} of loader wall time)'.format(frac)
    wait = report['reader_wait_s']
    for stage, seconds in report['stages'].items():
        pct = (seconds / wait * 100.0) if wait else 0.0
        lines.append('  {:<22s} {:>8.3f}s  {:5.1f}%'.format(stage, seconds, pct))
    lines.append('  attributed {:.1%} of the wait to named stages'.format(
        report['coverage']))
    if report['bottleneck'] is not None:
        lines.append('  bottleneck: {}'.format(report['bottleneck']))
        if report.get('hint'):
            lines.append('    hint: {}'.format(report['hint']))
    recovery = report.get('recovery') or {}
    if any(recovery.values()):
        lines.append('  recovery events: {} worker restart(s), {} item(s) requeued, '
                     '{} quarantined'.format(
                         recovery.get('worker_restarts', 0),
                         recovery.get('items_requeued', 0),
                         recovery.get('items_quarantined', 0)))
    watchdog = report.get('watchdog') or {}
    if watchdog.get('stalls'):
        age = watchdog.get('last_dump_age_s')
        lines.append('  watchdog: {} stall dump(s) recorded{} — run '
                     '`python -m petastorm_tpu_torch.observability.blackbox` on the '
                     'flight directory for the wedged stacks'.format(
                         watchdog['stalls'],
                         ', last {}s ago'.format(age) if age is not None else ''))
    return '\n'.join(lines)
