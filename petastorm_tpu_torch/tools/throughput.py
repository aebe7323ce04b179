"""Input-pipeline duty cycle under a real training step.

Twin of ``pipeline_duty_cycle`` in ``petastorm_tpu/tools/throughput.py``:
reader -> :class:`TorchDataLoader` -> :func:`prefetch_to_device` -> ``step_fn``,
measuring examples/sec and the input-stall fraction (the share of wall time
the training loop spent blocked waiting for the next batch). Where the JAX
version calls ``jax.block_until_ready``, this one calls
``torch.cuda.synchronize``. ``telemetry=`` sets the reader's level, and the
result carries the loader's stall attribution (``extra['stall']``).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.native import read_routes
from petastorm_tpu_torch.parallel import DataSharding
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.sequence.tail import TailFollowingReader
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader


@dataclass
class BenchmarkResult:
    samples_per_second: float
    duration_s: float
    samples: int
    input_stall_fraction: float = None
    extra: dict = field(default_factory=dict)


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
