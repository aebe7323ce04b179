"""Input-pipeline duty cycle under a real training step.

Twin of ``pipeline_duty_cycle`` in ``petastorm_tpu/tools/throughput.py``:
reader -> :class:`TorchDataLoader` -> :func:`prefetch_to_device` -> ``step_fn``,
measuring examples/sec and the input-stall fraction (the share of wall time
the training loop spent blocked waiting for the next batch). Where the JAX
version calls ``jax.block_until_ready``, this one calls
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device


@dataclass
class BenchmarkResult:
    samples_per_second: float
    duration_s: float
    samples: int
    input_stall_fraction: float = None
    extra: dict = field(default_factory=dict)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def pipeline_duty_cycle(dataset_url, step_fn, batch_to_args, batch_size=64, steps=50,
                        warmup_steps=5, loader_kwargs=None, reader_kwargs=None, device=None):
    """Run ``step_fn(*batch_to_args(batch))`` on ``warmup_steps`` then
    ``steps`` batches; stall = time blocked in ``next()`` / wall time of the
    measured steps. On CUDA, ``extra['step_ms']`` holds each measured step's
    time on the device's clock (CUDA events around the step on the
    consumer's stream), and ``extra['median_step_ms']`` their median.
    ``extra['cache']`` holds the reader's cache counters (``stats()``: hits
    and misses of a local-disk cache over the whole run)."""
    device = resolve_device(device)
    kwargs = {'num_epochs': None, 'output': 'columnar', **(reader_kwargs or {})}
    reader = make_reader(dataset_url, **kwargs)
    try:
        loader = TorchDataLoader(reader, batch_size=batch_size, **(loader_kwargs or {}))
        it = iter(prefetch_to_device(loader, device, size=2))
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
        extra = {'steps': steps, 'cache': reader.cache.stats()}
        if events:
            extra['step_ms'] = [s.elapsed_time(e) for s, e in events]
            extra['median_step_ms'] = statistics.median(extra['step_ms'])
        return BenchmarkResult(
            samples_per_second=steps * batch_size / duration, duration_s=duration,
            samples=steps * batch_size, input_stall_fraction=wait / duration, extra=extra)
    finally:
        reader.stop()
        reader.join()
