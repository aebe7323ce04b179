"""Reader throughput, and the input pipeline's duty cycle under a real
training step (twin of ``petastorm_tpu/tools/throughput.py``).

:func:`reader_throughput` measures the reader without a train step, in
samples/sec with the process's RSS and CPU share: ``'python'`` iterates the
reader's rows, ``'columnar'`` takes :class:`TorchDataLoader` batches on the
host block path, and ``'torch'`` (the JAX tool's ``'jax'``) stages them onto
the card through :func:`prefetch_to_device` and reports the input-stall
fraction. It is the reference's ``petastorm-throughput``; run it as::

    python -m petastorm_tpu_torch.tools.throughput file:///data/train -d torch

(``--device cpu`` stages on the CPU.) :func:`pipeline_duty_cycle` runs
reader -> :class:`TorchDataLoader` -> :func:`prefetch_to_device` -> ``step_fn``,
measuring examples/sec and the input-stall fraction (the share of wall time
the training loop spent blocked waiting for the next batch). Where the JAX
tool calls ``jax.block_until_ready``, this one calls
``torch.cuda.synchronize``. ``telemetry=`` sets the reader's level, and the
result carries the loader's stall attribution.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.native import read_routes
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.sequence.tail import TailFollowingReader
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

# torch is imported where it is used: the process pool's spawned workers
# import the main module, which is this one under ``python -m``, and a
# worker must not import torch


#: the environment variable that marks the child of ``--fresh-process``
_CHILD_ENV = '_PSTPU_TORCH_THROUGHPUT_CHILD'


@dataclass
class BenchmarkResult:
    samples_per_second: float
    duration_s: float
    samples: int
    memory_rss_mb: float = 0.0
    cpu_percent: float = 0.0
    input_stall_fraction: float = None
    extra: dict = field(default_factory=dict)

    def __str__(self):
        s = '{:.2f} samples/sec; {:.2f} MB RSS; {:.2f}% CPU'.format(
            self.samples_per_second, self.memory_rss_mb, self.cpu_percent)
        if self.input_stall_fraction is not None:
            s += '; {:.2f}% input stall'.format(100 * self.input_stall_fraction)
        return s


_last_cpu_times = None  # (process CPU seconds, monotonic seconds) at the previous call


def _process_stats():
    """This process's RSS in MB and its CPU percent since the previous call
    (0.0 at the first), the numbers psutil's ``memory_info().rss`` and
    ``cpu_percent(interval=None)`` give, without psutil: the resident pages
    of ``/proc/self/statm`` times the page size, and the change in
    ``time.process_time()`` over the change in the monotonic clock."""
    global _last_cpu_times
    with open('/proc/self/statm') as f:
        resident_pages = int(f.read().split()[1])
    rss_mb = resident_pages * os.sysconf('SC_PAGE_SIZE') / (1 << 20)
    now = (time.process_time(), time.monotonic())
    cpu = 0.0
    if _last_cpu_times is not None:
        wall = now[1] - _last_cpu_times[1]
        cpu = 100.0 * (now[0] - _last_cpu_times[0]) / wall if wall > 0 else 0.0
    _last_cpu_times = now
    return rss_mb, cpu


def _timed_items(it, warmup, measure, sync=None):
    """Take ``warmup`` then ``measure`` items from ``it``; returns the
    measured wall seconds and the seconds spent waiting for the items.
    ``sync()`` runs after each item, inside the wait (a staged batch is
    waited for until it is on its device)."""
    for _ in range(warmup):
        next(it)
        if sync is not None:
            sync()
    wait = 0.0
    t0 = time.perf_counter()
    for _ in range(measure):
        w0 = time.perf_counter()
        next(it)
        if sync is not None:
            sync()
        wait += time.perf_counter() - w0
    return time.perf_counter() - t0, wait


def reader_throughput(dataset_url, field_regex=None, warmup_cycles=200, measure_cycles=1000,
                      pool_type='thread', workers_count=3, shuffle_row_groups=True,
                      read_method='python', batch_size=64, make_reader_fn=None,
                      telemetry=None, device=None):
    """Measure read throughput in samples/sec.

    :param read_method: ``'python'``: iterate the reader's rows (the
        reference's measurement); ``'columnar'``: :class:`TorchDataLoader`
        batches on the host block path, no staging; ``'torch'``: the loader's
        batches staged onto ``device`` by :func:`prefetch_to_device`, with
        the input-stall fraction (the wait for a batch includes its
        ``torch.cuda.synchronize``). ``warmup_cycles``/``measure_cycles``
        count rows; the loader methods take ``cycles // batch_size``
        batches (at least one). The loader methods ask ``make_reader`` for
        ``output='columnar'`` unless ``make_reader_fn`` is given.
    :param telemetry: the reader's telemetry level (``None``: the
        process's). The loader methods put the
        :func:`~petastorm_tpu_torch.observability.stall_report` of the
        loader's wait in ``extra['stall_report']`` (None when telemetry is
        off).
    :param device: where ``'torch'`` stages; ``None`` is the card, and
        raises without CUDA. The other methods ignore it.
    """
    if read_method not in ('python', 'columnar', 'torch'):
        raise ValueError('Unknown read_method {!r}'.format(read_method))
    if read_method == 'torch':
        from petastorm_tpu_torch.device import resolve_device
        device = resolve_device(device)  # before any reader starts
    kwargs = {}
    if read_method != 'python' and make_reader_fn is None:
        kwargs['output'] = 'columnar'  # the loader methods read blocks, not rows
    if telemetry is not None:
        kwargs['telemetry'] = telemetry
    reader = (make_reader_fn or make_reader)(
        dataset_url, schema_fields=field_regex, reader_pool_type=pool_type,
        workers_count=workers_count, shuffle_row_groups=shuffle_row_groups, num_epochs=None,
        **kwargs)
    loader = staged = None
    extra = {}
    stall = None
    try:
        _process_stats()  # the CPU share is measured from here
        if read_method == 'python':
            duration, _ = _timed_items(iter(reader), warmup_cycles, measure_cycles)
            samples = measure_cycles
        else:
            # only the loader methods import torch
            from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
            loader = TorchDataLoader(reader, batch_size=batch_size)
            warmup = max(1, warmup_cycles // batch_size)
            measure = max(1, measure_cycles // batch_size)
            if read_method == 'columnar':
                duration, _ = _timed_items(iter(loader), warmup, measure)
            else:
                staged = prefetch_to_device(loader, device, size=2)
                duration, wait = _timed_items(staged, warmup, measure,
                                                sync=lambda: _sync(device))
                stall = wait / duration if duration > 0 else 0.0
            samples = measure * batch_size
            extra['stall_report'] = _loader_stall_report(loader)
        rss_mb, cpu = _process_stats()
        return BenchmarkResult(samples_per_second=samples / duration, duration_s=duration,
                               samples=samples, memory_rss_mb=rss_mb, cpu_percent=cpu,
                               input_stall_fraction=stall, extra=extra)
    finally:
        # the prefetcher's thread first, then the loader (or reader), as in
        # pipeline_duty_cycle: a reader stopped first leaves its pump behind
        if staged is not None:
            staged.close()
        (loader or reader).stop()
        reader.join()


def _loader_stall_report(loader):
    """The stage attribution of the loader's reader wait; None when
    telemetry is off (there are no stage timers to attribute it to)."""
    if not obs.counters_on():
        return None
    return obs.stall_report(loader.diagnostics)


def pool_counters(reader):
    """The ``diagnostics`` of the pool a reader reads through. A served
    reader decodes nothing itself: its ring facade's counters stand for a
    pool. A reader composition has no pool of its own: a mixture reports the
    list of its sources' counters, a tail follower those of its open delta
    epoch's reader, or None between deltas."""
    if isinstance(reader, WeightedSamplingReader):
        return [pool_counters(source) for source in reader._readers]
    if isinstance(reader, TailFollowingReader):
        return pool_counters(reader._inner) if reader._inner is not None else None
    pool = getattr(reader, '_pool', None) or reader._facade
    return pool.diagnostics


def _sync(device):
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)


def pipeline_duty_cycle(dataset_url, step_fn, batch_to_args, batch_size=64, steps=50,
                        warmup_steps=5, loader_kwargs=None, reader_kwargs=None, device=None,
                        reader_factory=make_reader, telemetry=None, to_device=None):
    """Run ``step_fn(*batch_to_args(batch))`` on ``warmup_steps`` then
    ``steps`` batches; stall = time blocked in ``next()`` / wall time of the
    measured steps. On CUDA, ``extra['step_ms']`` holds each measured step's
    time on the device's clock (CUDA events around the step on the
    consumer's stream), and ``extra['median_step_ms']`` their median.
    ``extra['cache']`` holds the reader's cache counters (``stats()``: hits
    and misses of a local-disk cache over the whole run), and
    ``extra['read_routes']`` the columns each read route served over the
    whole run (the change in :data:`~petastorm_tpu_torch.native.read_routes`;
    counts of other readers running at the same time land there too; a
    process pool adds its workers' counts as they arrive). ``extra['pool']``
    holds the pool's ``diagnostics`` at the end of the run
    (:func:`pool_counters`): for a process pool its transport, restarts,
    quarantined items, publishes per channel and live zero-copy borrows.
    ``reader_factory(dataset_url, num_epochs=None, **reader_kwargs)`` opens
    the reader: :func:`make_reader` (with ``output='columnar'`` unless
    ``reader_kwargs`` say otherwise or hold an ``ngram``),
    ``make_batch_reader``, or a factory of a reader composition (a
    ``MixtureReader`` over sources it opens, a ``TailFollowingReader``, which
    owns its epochs and is built without ``num_epochs``).
    ``telemetry`` is the reader's level (``None``: the process's).
    ``extra['stall']`` is the
    :func:`~petastorm_tpu_torch.observability.stall_report` of the loader's
    diagnostics at the end of the measured steps (its wait and the stage
    timers cover the whole run, warm-up included; None when telemetry is
    off), and ``extra['diagnostics']`` those diagnostics. The loader is
    stopped at the end, which writes its stall record into the flight
    file. ``to_device`` stages onto a
    :class:`~petastorm_tpu_torch.parallel.DataSharding` instead of
    ``device`` (the mesh path: the batch is this rank's rows)."""
    import torch

    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.parallel import DataSharding
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

    if to_device is not None and device is not None:
        raise ValueError('pass device or to_device, not both')
    target = to_device if to_device is not None else resolve_device(device)
    device = target.device if isinstance(target, DataSharding) else resolve_device(target)
    kwargs = {'num_epochs': None}
    if reader_factory is make_reader and (reader_kwargs or {}).get('ngram') is None:
        # the device-feed hot path; an NGram read keeps make_reader's row
        # output unless reader_kwargs ask for columnar windows
        kwargs['output'] = 'columnar'
    kwargs.update(reader_kwargs or {})
    if telemetry is not None:
        kwargs['telemetry'] = telemetry
    routes_before = read_routes.snapshot()
    reader = reader_factory(dataset_url, **kwargs)
    it = loader = None
    try:
        loader = TorchDataLoader(reader, batch_size=batch_size, **(loader_kwargs or {}))
        it = prefetch_to_device(loader, target, size=2)
        for _ in range(warmup_steps):
            step_fn(*batch_to_args(next(it)))
        _sync(device)
        events = []
        wait = 0.0
        t0 = time.perf_counter()
        for _ in range(steps):
            w0 = time.perf_counter()
            batch = next(it)
            wait += time.perf_counter() - w0
            if device.type == 'cuda':
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                step_fn(*batch_to_args(batch))
                end.record()
                events.append((start, end))
            else:
                step_fn(*batch_to_args(batch))
        _sync(device)
        duration = time.perf_counter() - t0
        routes = read_routes.snapshot()
        diagnostics = loader.diagnostics
        cache = getattr(reader, 'cache', None)
        extra = {'steps': steps, 'cache': cache.stats() if cache is not None else None,
                 'read_routes': {k: v - routes_before.get(k, 0) for k, v in routes.items()},
                 # the pool's own counters (the reader's diagnostics add the
                 # whole metrics registry)
                 'pool': pool_counters(reader), 'diagnostics': diagnostics,
                 'stall': obs.stall_report(diagnostics) if obs.counters_on() else None}
        if events:
            extra['step_ms'] = [s.elapsed_time(e) for s, e in events]
            extra['median_step_ms'] = statistics.median(extra['step_ms'])
        return BenchmarkResult(
            samples_per_second=steps * batch_size / duration, duration_s=duration,
            samples=steps * batch_size, input_stall_fraction=wait / duration, extra=extra)
    finally:
        # the prefetcher's thread first, while the reader still feeds it: its
        # pump then leaves the loader with the next batch; stopping the
        # reader ends a pump that is still waiting in it
        if it is not None:
            it.close()
        (loader or reader).stop()
        reader.join()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.tools.throughput',
        description='Measure reader throughput (the reference petastorm-throughput).')
    parser.add_argument('dataset_url')
    parser.add_argument('-f', '--field-regex', nargs='+', default=None,
                        help='only read fields matching these regexes')
    parser.add_argument('-m', '--warmup-cycles', type=int, default=200)
    parser.add_argument('-n', '--measure-cycles', type=int, default=1000)
    parser.add_argument('-p', '--pool-type', choices=('thread', 'process', 'dummy'),
                        default='thread')
    parser.add_argument('-w', '--workers-count', type=int, default=3)
    parser.add_argument('-d', '--read-method', choices=('python', 'columnar', 'torch'),
                        default='python')
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--no-shuffle', action='store_true')
    parser.add_argument('--telemetry', choices=('off', 'counters', 'spans'), default=None,
                        help='pipeline telemetry level (default: counters; '
                             '--trace-out implies spans)')
    parser.add_argument('--trace-out', default=None,
                        help='write a Perfetto-loadable Chrome trace of the run here '
                             '(implies --telemetry spans)')
    parser.add_argument('--fresh-process', action='store_true',
                        help='re-run the measurement in a new interpreter, so the '
                             'reported RSS is this benchmark\'s alone')
    parser.add_argument('--device', default=None,
                        help="where -d torch stages (default: the card; 'cpu' to run "
                             'without one)')
    args = parser.parse_args(argv)

    if args.fresh_process and not os.environ.get(_CHILD_ENV):
        child_argv = [a for a in (argv if argv is not None else sys.argv[1:])
                      if a != '--fresh-process']
        env = dict(os.environ, **{_CHILD_ENV: '1'})
        # the child imports this package from where this process did
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env['PYTHONPATH'] = pkg_parent + os.pathsep + env.get('PYTHONPATH', '')
        return subprocess.run(
            [sys.executable, '-m', 'petastorm_tpu_torch.tools.throughput'] + child_argv,
            env=env).returncode

    telemetry = args.telemetry
    if args.trace_out and telemetry in (None, 'off', 'counters'):
        telemetry = 'spans'
    result = reader_throughput(
        args.dataset_url, field_regex=args.field_regex, warmup_cycles=args.warmup_cycles,
        measure_cycles=args.measure_cycles, pool_type=args.pool_type,
        workers_count=args.workers_count, shuffle_row_groups=not args.no_shuffle,
        read_method=args.read_method, batch_size=args.batch_size, telemetry=telemetry,
        device=args.device)
    print(result)
    report = result.extra.get('stall_report')
    if report is not None:
        # the stall fraction says how long the consumer waited; the report
        # says which stage the wait went to
        print(obs.format_stall_report(report))
    if args.trace_out:
        n = obs.export_chrome_trace(args.trace_out)
        print('wrote {} trace events to {} (open in https://ui.perfetto.dev)'.format(
            n, args.trace_out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
