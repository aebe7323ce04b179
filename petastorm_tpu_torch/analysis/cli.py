"""CLI for the port's linter: twin of ``petastorm_tpu/analysis/cli.py``.

::

    python -m petastorm_tpu_torch.analysis [paths ...] [options]

Default path is the installed ``petastorm_tpu_torch`` package. The port
declares no console script (as with its other CLIs).

Exit-code contract (stable; scripts and CI may rely on it):

* ``0`` — clean: no OPEN findings remain after noqa suppression, baseline
  absorption and ``--select``/``--ignore`` filtering (also: ``--rules`` and
  ``--write-baseline`` succeeded).
* ``1`` — open findings remain (each printed to stdout).
* ``2`` — usage error: unknown option, missing path, or a ``--select``/
  ``--ignore`` token that matches no known rule family.

``--format json`` emits ONE machine-readable finding object per line
(JSONL), so CI and the Admin tooling can annotate diffs line by line:

    {"rule": "PT900", "path": "native/fused.py", "line": 84,
     "message": "...", "snippet": "...", "status": "open"}

``status`` is ``open`` (actionable; these drive the exit code),
``noqa`` (suppressed on its line) or ``baselined`` (absorbed by
``--baseline``) — the JSON stream carries all three so a diff annotator can
show suppressed findings too; text output prints only open ones.

``--select``/``--ignore`` take comma-separated rule-id prefixes and make
staged rollouts possible: ship new rule families dark with ``--ignore PT9``,
or gate a single family with ``--select PT9``.

``--changed`` scans only files git considers modified (tracked files
differing from HEAD, staged or not, plus untracked non-ignored files) —
the edit-loop mode. ``--cache DIR`` keeps a content-addressed per-file
result store so untouched files cost one ``stat`` on re-runs; the
invalidation contract (file bytes + sibling native sources + the analysis
package itself) lives in :mod:`petastorm_tpu_torch.analysis.cache` and
docs/analysis.md. Both compose with every other flag: select/ignore/
baseline are re-applied per run, never baked into cached entries.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: the documented exit-code contract
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def _default_target():
    import petastorm_tpu_torch
    return os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.analysis',
        description='Repo-specific invariant linter: lock discipline (PT100), '
                    'resource lifecycle (PT200), exception hygiene (PT300), CUDA '
                    'graph capture purity (PT400), native-buffer safety (PT500), hashability '
                    '(PT600), telemetry/worker/autotune hygiene (PT7xx), '
                    'protocol discipline (PT8xx), cross-language ABI '
                    'conformance + C++ overflow/bounds (PT9xx). '
                    'See docs/analysis.md.')
    parser.add_argument('paths', nargs='*',
                        help='files/directories to scan (default: the installed '
                             'petastorm_tpu_torch package)')
    parser.add_argument('--format', choices=('text', 'json', 'sarif'),
                        default='text',
                        help='json = one finding object per line (JSONL; '
                             'includes noqa/baselined findings with their '
                             'status — only "open" ones affect the exit code); '
                             'sarif = one SARIF 2.1.0 document (suppressed '
                             'findings carry a "suppressions" entry) for CI '
                             'PR annotation')
    parser.add_argument('--baseline', metavar='FILE',
                        help='analysis_baseline.json absorbing known findings '
                             '(missing file = empty baseline)')
    parser.add_argument('--write-baseline', metavar='FILE',
                        help='write the current findings as a baseline and exit 0')
    parser.add_argument('--select', metavar='CODES',
                        help='comma-separated rule-id prefixes to report '
                             '(e.g. PT1,PT500); everything else is dropped')
    parser.add_argument('--ignore', metavar='CODES',
                        help='comma-separated rule-id prefixes to suppress '
                             '(applied after --select) — stage a new family '
                             'dark with e.g. --ignore PT8')
    parser.add_argument('--changed', action='store_true',
                        help='scan only files git reports as changed vs HEAD '
                             '(plus untracked) under the given paths — the '
                             'edit-loop mode; a clean git state exits 0 '
                             'without scanning anything')
    parser.add_argument('--cache', metavar='DIR',
                        help='content-addressed per-file result cache: '
                             'untouched files are served from DIR instead of '
                             're-analyzed (invalidation contract: the file, '
                             'its sibling .cpp/.cc sources, and the analysis '
                             'package itself — see docs/analysis.md; deleting '
                             'DIR is always safe)')
    parser.add_argument('--rules', action='store_true',
                        help='list the rule families and exit')
    return parser


def main(argv=None):
    from petastorm_tpu_torch.analysis import ALL_CHECKERS, run_analysis
    from petastorm_tpu_torch.analysis.core import load_baseline, write_baseline

    args = build_parser().parse_args(argv)

    if args.rules:
        for cls in ALL_CHECKERS:
            print('{:<7} {:<22} {}'.format(cls.code, cls.name, cls.description))
        return EXIT_CLEAN

    paths = args.paths or [_default_target()]
    for p in paths:
        if not os.path.exists(p):
            print('error: no such path: {}'.format(p), file=sys.stderr)
            return EXIT_USAGE

    def parse_prefixes(raw, flag):
        if not raw:
            return None
        prefixes = [c.strip().upper() for c in raw.split(',') if c.strip()]
        known = [c for cls in ALL_CHECKERS for c in cls.rule_codes()] + ['PT000']
        for prefix in prefixes:
            if not any(code.startswith(prefix) for code in known):
                print('error: {} prefix {!r} matches no known rule family '
                      '(see --rules)'.format(flag, prefix), file=sys.stderr)
                return EXIT_USAGE
        return prefixes

    select = parse_prefixes(args.select, '--select')
    if select == EXIT_USAGE:
        return EXIT_USAGE
    ignore = parse_prefixes(args.ignore, '--ignore')
    if ignore == EXIT_USAGE:
        return EXIT_USAGE
    baseline = load_baseline(args.baseline) if args.baseline else None
    keep_suppressed = args.format in ('json', 'sarif') and not args.write_baseline
    if args.changed or args.cache:
        from petastorm_tpu_torch.analysis.cache import (ResultCache,
                                                  changed_file_entries,
                                                  iter_file_entries,
                                                  run_analysis_incremental)
        try:
            entries = (changed_file_entries(paths) if args.changed
                       else iter_file_entries(paths))
        except RuntimeError as e:
            print('error: {}'.format(e), file=sys.stderr)
            return EXIT_USAGE
        cache = ResultCache(args.cache) if args.cache else None
        # the whole-program pass (PT13xx) always sees the FULL listing — a
        # changed-files subset cannot support cross-module analysis
        program_entries = iter_file_entries(paths) if args.changed else None
        findings = run_analysis_incremental(
            entries, cache=cache, baseline=baseline, select=select,
            ignore=ignore, keep_suppressed=keep_suppressed,
            program_entries=program_entries)
        if args.changed:
            print('{} changed file{} scanned'.format(
                len(entries), '' if len(entries) == 1 else 's'),
                file=sys.stderr)
        if cache is not None:
            print('cache: {} hit{}, {} miss{}'.format(
                cache.hits, '' if cache.hits == 1 else 's',
                cache.misses, '' if cache.misses == 1 else 'es'),
                file=sys.stderr)
    else:
        findings = run_analysis(paths, baseline=baseline, select=select,
                                ignore=ignore, keep_suppressed=keep_suppressed)
    open_findings = [f for f in findings if f.status == 'open']

    if args.write_baseline:
        write_baseline(args.write_baseline, open_findings)
        print('baseline with {} entr{} written to {}'.format(
            len(open_findings), 'y' if len(open_findings) == 1 else 'ies',
            args.write_baseline))
        return EXIT_CLEAN

    if args.format == 'json':
        # JSONL: one stable finding object per line (see the module docstring
        # for the schema); noqa/baselined findings ride along with their
        # status so machine consumers can annotate suppressions too
        for f in findings:
            print(json.dumps(f.to_dict(), sort_keys=True))
    elif args.format == 'sarif':
        from petastorm_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings, ALL_CHECKERS), indent=2,
                         sort_keys=True))
    else:
        for f in open_findings:
            print(f.format())
            if f.snippet:
                print('    {}'.format(f.snippet))
        print('{} finding{}'.format(len(open_findings),
                                    '' if len(open_findings) == 1 else 's'))
    return EXIT_FINDINGS if open_findings else EXIT_CLEAN


if __name__ == '__main__':
    sys.exit(main())
