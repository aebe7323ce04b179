"""The port's race CLI: twin of ``petastorm_tpu/analysis/schedule/cli.py``.

::

    python -m petastorm_tpu_torch.analysis.schedule.cli explore [scenario ...] [options]
    python -m petastorm_tpu_torch.analysis.schedule.cli lint [paths ...] [options]
    python -m petastorm_tpu_torch.analysis.schedule.cli list

``explore`` runs the deterministic-schedule explorer over the named
scenarios (default: every real-component scenario).  A failure prints the
race/deadlock report plus its schedule string; re-running with
``PSTPU_SCHEDULE=<string>`` (and exactly one scenario) replays that
interleaving byte-for-byte.

``lint`` is the whole-program static pass: it delegates to the port's
linter (``python -m petastorm_tpu_torch.analysis --select PT13``) so only
the concurrency family (PT1300-PT1303) reports, with every lint flag
(``--format sarif``, ``--changed``, ``--cache``, ...) passed through.

Exit-code contract (the JAX CLI's; scripts and CI may rely on it):

* ``0`` — clean: every explored scenario passed / no open PT13xx findings.
* ``1`` — a finding: a data race, a deadlock, a scenario invariant
  failure, or an open static finding.
* ``2`` — usage error: unknown scenario/option, or ``PSTPU_SCHEDULE`` with
  zero or several scenarios.
* ``3`` — inconclusive: the step budget ran out, a replayed schedule
  diverged from the code, or a thread stalled outside the instrumentation
  — the component is neither proven nor disproven; fix the scenario or
  raise the budget.
"""

from __future__ import annotations

import argparse
import os
import sys

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2
EXIT_INCONCLUSIVE = 3


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.analysis.schedule.cli',
        description='Thread-plane race tooling for the port: deterministic '
                    'interleaving exploration (explore) and whole-program '
                    'lockset lints PT1300-PT1303 (lint). See docs/analysis.md.')
    sub = parser.add_subparsers(dest='mode')

    explore_p = sub.add_parser(
        'explore', help='run scenarios under the deterministic scheduler')
    explore_p.add_argument('scenarios', nargs='*',
                           help='scenario names (default: every '
                                'real-component scenario; see "list")')
    explore_p.add_argument('--schedules', type=int, default=300,
                           help='random schedules per scenario '
                                '(default: 300)')
    explore_p.add_argument('--seed', type=int, default=0,
                           help='base RNG seed (schedule i uses seed+i)')
    explore_p.add_argument('--dfs-budget', type=int, default=100,
                           help='bounded-preemption DFS runs per scenario '
                                '(default: 100)')
    explore_p.add_argument('--max-preemptions', type=int, default=2,
                           help='DFS preemption bound (default: 2)')
    explore_p.add_argument('--max-steps', type=int, default=20000,
                           help='per-run scheduling-step budget')

    sub.add_parser('list', help='list the scenario catalog')

    lint_p = sub.add_parser(
        'lint', help='run the PT13xx whole-program lints '
                     '(python -m petastorm_tpu_torch.analysis --select PT13 '
                     'passthrough)')
    lint_p.add_argument('args', nargs=argparse.REMAINDER,
                        help='paths and linter options')
    return parser


def _cmd_list():
    from petastorm_tpu_torch.analysis.schedule.scenarios import (DEFECT_SCENARIOS,
                                                           SCENARIOS)
    print('real-component scenarios (explored by default):')
    for name, fn in sorted(SCENARIOS.items()):
        doc = (fn.__doc__ or '').strip().split('\n')[0]
        print('  {:<24} {}'.format(name, doc))
    print('seeded-defect fixtures (run by explicit name only):')
    for name, fn in sorted(DEFECT_SCENARIOS.items()):
        doc = (fn.__doc__ or '').strip().split('\n')[0]
        print('  {:<24} {}'.format(name, doc))
    return EXIT_CLEAN


def _cmd_explore(args):
    from petastorm_tpu_torch.analysis.schedule.explorer import explore
    from petastorm_tpu_torch.analysis.schedule.scenarios import SCENARIOS, lookup
    from petastorm_tpu_torch.analysis.schedule.scheduler import SCHEDULE_ENV

    names = args.scenarios or sorted(SCENARIOS)
    targets = []
    for name in names:
        try:
            targets.append((name, lookup(name)))
        except KeyError:
            print('error: unknown scenario {!r} (see "python -m '
                  'petastorm_tpu_torch.analysis.schedule.cli list")'.format(name),
                  file=sys.stderr)
            return EXIT_USAGE
    if os.environ.get(SCHEDULE_ENV) and len(targets) != 1:
        print('error: {} replay needs exactly one scenario, got {}'.format(
            SCHEDULE_ENV, len(targets)), file=sys.stderr)
        return EXIT_USAGE

    worst = EXIT_CLEAN
    for name, fn in targets:
        report = explore(fn, name=name, schedules=args.schedules,
                         seed=args.seed, dfs_budget=args.dfs_budget,
                         max_preemptions=args.max_preemptions,
                         max_steps=args.max_steps)
        print(report.describe())
        if report.failure is not None:
            rc = (EXIT_INCONCLUSIVE if report.failure.inconclusive
                  and not report.failure.races
                  and report.failure.deadlock is None
                  and not report.failure.errors
                  else EXIT_FINDINGS)
            worst = max(worst, rc)
    return worst


def _cmd_lint(raw_args):
    from petastorm_tpu_torch.analysis.cli import main as lint_main
    return lint_main(['--select', 'PT13'] + list(raw_args))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == 'list':
        return _cmd_list()
    if args.mode == 'explore':
        return _cmd_explore(args)
    if args.mode == 'lint':
        return _cmd_lint(args.args)
    build_parser().print_help()
    return EXIT_USAGE


if __name__ == '__main__':
    sys.exit(main())
