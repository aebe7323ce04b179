"""Schedule exploration: N seeded random schedules + bounded-preemption DFS.

Twin of ``petastorm_tpu/analysis/schedule/explorer.py``; the same seeds and
budgets explore the same schedules in the same order. The exploration
contract (`docs/analysis.md`):

1. **Random phase** — ``schedules`` runs, each driven by
   ``RandomStrategy(seed + i)``.  Reproducible: the same seed explores the
   same schedules in the same order.
2. **DFS phase** — iterative-context-bounding over choice prefixes: each
   completed run contributes branch points (step, alternative thread), and
   a branch is explored only while its cumulative *preemption* count (a
   switch away from a thread that could have kept running) stays within
   ``max_preemptions``.  Small preemption bounds find most real concurrency
   bugs (the CHESS observation) while keeping the state space tractable.
3. **Replay** — when :data:`~petastorm_tpu_torch.analysis.schedule.scheduler.SCHEDULE_ENV`
   (``PSTPU_SCHEDULE``) is set, exploration is skipped and exactly that
   schedule runs, byte-for-byte.  Every failure report prints its schedule
   string so this is a copy-paste away.

A run *fails* on a detected race, a deadlock, or a thread exception; it is
*inconclusive* when the step budget runs out or a replayed schedule no
longer matches the code.  Both stop the exploration immediately — the
report carries the offending :class:`RunResult`.
"""

from __future__ import annotations

import os

from petastorm_tpu_torch.analysis.schedule.scheduler import (PrefixStrategy,
                                                       RandomStrategy,
                                                       ReplayStrategy,
                                                       Scheduler,
                                                       schedule_from_env)

#: cap on queued-but-unexplored DFS branches (memory guard; hitting it is
#: logged in the report, never silent)
_MAX_PENDING = 20000


class ExploreReport(object):
    """Outcome of one :func:`explore` call over a single scenario."""

    __slots__ = ('scenario', 'schedules_run', 'random_runs', 'dfs_runs',
                 'failure', 'replayed', 'dfs_truncated')

    def __init__(self, scenario):
        self.scenario = scenario
        self.schedules_run = 0
        self.random_runs = 0
        self.dfs_runs = 0
        self.failure = None      # the first failing/inconclusive RunResult
        self.replayed = False    # PSTPU_SCHEDULE drove a single replay
        self.dfs_truncated = False

    @property
    def ok(self):
        return self.failure is None

    def describe(self):
        if self.failure is None:
            extra = ' [DFS frontier truncated]' if self.dfs_truncated else ''
            return ('{}: ok ({} schedules: {} random + {} DFS){}'.format(
                self.scenario, self.schedules_run, self.random_runs,
                self.dfs_runs, extra))
        return ('{}: FAILED after {} schedules\n{}\nreplay with: '
                'PSTPU_SCHEDULE={}'.format(
                    self.scenario, self.schedules_run,
                    self.failure.describe(), self.failure.schedule))


def run_one(scenario_fn, strategy, max_steps=20000):
    """One scheduled run of ``scenario_fn`` under ``strategy``; the scenario
    receives the :class:`Scheduler` (for ``track``/``yield_now``)."""
    sched = Scheduler(strategy=strategy, max_steps=max_steps)
    result = sched.run(lambda: scenario_fn(sched))
    return sched, result


def _preemption_costs(decisions):
    """Cumulative preemption count *before* each decision.  A preemption is
    choosing a thread other than the previous one while the previous one was
    still in the runnable set."""
    costs = []
    total = 0
    for runnable, chosen, prev in decisions:
        costs.append(total)
        if prev is not None and prev in runnable and chosen != prev:
            total += 1
    return costs


def explore(scenario_fn, name='scenario', schedules=300, seed=0,
            dfs_budget=100, max_preemptions=2, max_steps=20000,
            environ=os.environ):
    """Explore ``scenario_fn`` and return an :class:`ExploreReport`.

    Stops at the first failure (its schedule string is the repro).  With
    ``PSTPU_SCHEDULE`` set in ``environ``, runs exactly that schedule once.
    """
    report = ExploreReport(name)

    env_schedule = schedule_from_env(environ)
    if env_schedule is not None:
        report.replayed = True
        _sched, result = run_one(scenario_fn, ReplayStrategy(env_schedule),
                                 max_steps)
        report.schedules_run = 1
        if not result.ok:
            report.failure = result
        return report

    # phase 1: seeded random schedules
    for i in range(schedules):
        _sched, result = run_one(scenario_fn, RandomStrategy(seed + i),
                                 max_steps)
        report.schedules_run += 1
        report.random_runs += 1
        if not result.ok:
            report.failure = result
            return report

    # phase 2: bounded-preemption DFS over choice prefixes
    pending = [()]
    seen = {()}
    while pending and report.dfs_runs < dfs_budget:
        prefix = pending.pop()
        sched, result = run_one(scenario_fn, PrefixStrategy(prefix),
                                max_steps)
        report.schedules_run += 1
        report.dfs_runs += 1
        if not result.ok:
            report.failure = result
            return report
        decisions = sched.decisions
        costs = _preemption_costs(decisions)
        trace = [chosen for _r, chosen, _p in decisions]
        # branch only past the forced prefix: earlier steps were explored
        # when their own prefixes were generated
        for i in range(len(prefix), len(decisions)):
            runnable, chosen, prev = decisions[i]
            for alt in runnable:
                if alt == chosen:
                    continue
                cost = costs[i] + (1 if prev is not None and prev in runnable
                                   and alt != prev else 0)
                if cost > max_preemptions:
                    continue
                branch = tuple(trace[:i]) + (alt,)
                if branch in seen:
                    continue
                if len(pending) >= _MAX_PENDING:
                    report.dfs_truncated = True
                    break
                seen.add(branch)
                pending.append(branch)
    return report


def replay(scenario_fn, schedule, max_steps=20000):
    """Replay one recorded schedule (a string or an index list) and return
    its :class:`RunResult` — the regression-test entry point."""
    if isinstance(schedule, str):
        from petastorm_tpu_torch.analysis.schedule.scheduler import parse_schedule
        schedule = parse_schedule(schedule)
    _sched, result = run_one(scenario_fn, ReplayStrategy(schedule), max_steps)
    return result


__all__ = ['ExploreReport', 'explore', 'replay', 'run_one']
