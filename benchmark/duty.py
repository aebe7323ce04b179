"""The measured window: the training loop the benchmark times.

A frozen copy of the arithmetic of the program's ``pipeline_duty_cycle``
(``petastorm_tpu_torch/tools/throughput.py``), extended: the window is a
time, not a step count; the stall is the time blocked in ``next()``; each
step's end is a CUDA event on the consumer's stream, so the period between
two ends carries the wait of a step whose input came late. The host runs at
most ``lag`` steps ahead of the device, as a loop that reads its losses
does.
"""

from __future__ import annotations

import time
from contextlib import nullcontext


class CudaClock(object):
    """Step ends as CUDA events on the current stream."""

    def __init__(self, torch):
        self._torch = torch

    def mark(self):
        event = self._torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, mark):
        mark.synchronize()

    def sync(self):
        self._torch.cuda.synchronize()

    def elapsed_ms(self, a, b):
        return a.elapsed_time(b)


class HostClock(object):
    """Step ends on the host's clock: the benchmark's own CPU tests only."""

    def mark(self):
        return time.perf_counter()

    def wait(self, mark):
        pass

    def sync(self):
        pass

    def elapsed_ms(self, a, b):
        return (b - a) * 1e3


def span(torch, name):
    """A span of the benchmark's own, seen by the profiler in a traced run."""
    return torch.profiler.record_function(name) if torch is not None else nullcontext()


def run_window(it, step, seconds, clock, torch=None, lag=2, on_step=None):
    """Step ``step(batch)`` on batches from ``it`` until ``seconds`` have
    passed, then wait for the device. Returns the window's record:
    ``steps``, ``window_s`` (host clock, ending after the device finished),
    ``stall_s`` (blocked in ``next()``), ``periods_ms`` (start to the first
    step's end, then end to end, on the device's clock)."""
    marks = [clock.mark()]
    stall = 0.0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    steps = 0
    while True:
        if len(marks) > lag:
            with span(torch, 'bench.lag_wait'):
                clock.wait(marks[-lag])
        with span(torch, 'bench.next'):
            w0 = time.perf_counter()
            batch = next(it)
            stall += time.perf_counter() - w0
        with span(torch, 'bench.step'):
            step(batch)
        marks.append(clock.mark())
        if on_step is not None:
            on_step(steps, batch)
        steps += 1
        if time.perf_counter() >= deadline:
            break
    with span(torch, 'bench.drain'):
        clock.sync()
    window = time.perf_counter() - t0
    periods = [clock.elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    return {'steps': steps, 'window_s': window, 'stall_s': stall, 'periods_ms': periods}
