"""Closed-loop autotuning: the stall report turns the knobs itself.

Twin of ``petastorm_tpu/autotune/``: :class:`Autotuner` watches windowed
telemetry history (``observability/history.py``) and, at runtime, grows or
retires worker slots of the pool and shrinks the loader's shuffle buffer,
each move clamped into :class:`AutotuneConfig`'s bounds, damped by its
hysteresis, rolled back when the next window regresses, and recorded as an
``autotune.decision`` span and a decision record. Enable with
``make_reader(..., autotune=True)`` or an :class:`AutotuneConfig`;
:class:`~petastorm_tpu_torch.torch.loader.TorchDataLoader` attaches itself,
so the controller sees the consumer's wait. Off by default, at no cost. The
JAX package's chunk-prefetch knob waits for the chunk cache, which is not
ported, and so does the offline CLI (ROADMAP.md).
"""

from __future__ import annotations

from petastorm_tpu_torch.autotune.controller import (AutotuneConfig, Autotuner,  # noqa: F401
                                                     DecisionLog, clamp, decision_span,
                                                     resolve_autotune)

__all__ = ['AutotuneConfig', 'Autotuner', 'DecisionLog', 'clamp',
           'decision_span', 'resolve_autotune']
