"""Deterministic interleaving exploration for the port's thread plane: twin
of ``petastorm_tpu/analysis/schedule/``.

The dynamic half of the race story (the static half, rules PT1300-PT1303,
is the JAX package's linter, which lints this package too):

* :mod:`~petastorm_tpu_torch.analysis.schedule.scheduler` — the loom-style
  cooperative scheduler (patched ``threading`` primitives, seeded +
  replayable schedules, vector-clock race detection, deadlock detection);
* :mod:`~petastorm_tpu_torch.analysis.schedule.explorer` — N random
  schedules + bounded-preemption DFS, with ``PSTPU_SCHEDULE=`` byte-for-byte
  replay;
* :mod:`~petastorm_tpu_torch.analysis.schedule.scenarios` — the port's
  real-component scenarios (its ventilators, shuffling buffer, slot
  registry and autotuner), plus seeded-defect fixtures proving the explorer
  has teeth;
* :mod:`~petastorm_tpu_torch.analysis.schedule.cli` — ``python -m
  petastorm_tpu_torch.analysis.schedule.cli``.

See docs/analysis.md ("reading a schedule trace") for how to act on a
failure report.
"""

from petastorm_tpu_torch.analysis.schedule.explorer import (ExploreReport, explore,
                                                      replay, run_one)
from petastorm_tpu_torch.analysis.schedule.scenarios import (DEFECT_SCENARIOS,
                                                       SCENARIOS, lookup)
from petastorm_tpu_torch.analysis.schedule.scheduler import (SCHEDULE_ENV,
                                                       PrefixStrategy, Race,
                                                       RandomStrategy,
                                                       ReplayStrategy,
                                                       RunResult,
                                                       ScheduleDivergence,
                                                       Scheduler,
                                                       SchedulerError,
                                                       current_scheduler,
                                                       parse_schedule,
                                                       schedule_from_env)

__all__ = [
    'DEFECT_SCENARIOS', 'ExploreReport', 'PrefixStrategy', 'Race',
    'RandomStrategy', 'ReplayStrategy', 'RunResult', 'SCENARIOS',
    'SCHEDULE_ENV', 'ScheduleDivergence', 'Scheduler', 'SchedulerError',
    'current_scheduler', 'explore', 'lookup', 'parse_schedule', 'replay',
    'run_one', 'schedule_from_env',
]
