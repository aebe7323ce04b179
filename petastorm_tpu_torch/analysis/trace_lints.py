"""PT703 — trace-context propagation discipline.

The causal span tree (``observability/trace.py``, docs/observability.md
"Causal tracing") only reconstructs if every span recorded on the data path
derives its ``trace``/``span``/``parent`` identity from the thread's active
:class:`TraceContext` — the one the pools propagate alongside the work item.
A span that mints its own identity is an **orphan**: it lands in the ring but
hangs off no batch's tree, so the critical-path view silently loses exactly
the stage someone hand-instrumented. Two spellings produce orphans, and both
are mechanical to catch:

* a direct ``record_span(...)`` call (any receiver): the low-level emitter
  stamps nothing — identity must come from a ``span``/``stage`` context
  manager (or ``instant``), which reads the active context;
* a ``span(...)``/``stage(...)``/``instant(...)`` call passing an explicit
  ``trace=``, ``span=``, or ``parent=`` keyword: hand-rolled identity
  diverges from the propagated context the moment a retry, requeue, or serve
  re-dispatch renumbers the item. Adopt a context discovered mid-flight with
  ``sp.link(ctx)``; install one around a block with ``obs.use_trace(ctx)``.

The rule binds the propagation path only — worker pools, the row/batch
workers, and the serve plane — where an orphan breaks the cross-process tree
acceptance (a batch must reconstruct ≥4 causally-linked stages). Framework
code (``observability/``) and tests construct raw events legitimately.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker

#: span-opening callables whose identity must come from the active context
_SPAN_OPENERS = frozenset({'span', 'stage', 'instant', 'decision_span'})

#: kwargs that hand-roll causal identity instead of inheriting it
_IDENTITY_KWARGS = frozenset({'trace', 'span', 'parent'})


def _call_name(call):
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class TraceContextChecker(Checker):
    code = 'PT703'
    name = 'trace-context-propagation'
    description = ('spans on the worker/serve data path must inherit the '
                   'propagated TraceContext: no raw record_span calls, no '
                   'hand-rolled trace=/span=/parent= identity — orphan spans '
                   'drop out of every batch tree')
    scope = ('*workers/*.py', '*serve/*.py', '*row_worker.py',
             '*batch_worker.py')

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == 'record_span':
                yield self.finding(
                    src, node.lineno,
                    'record_span(...) called directly on the propagation path: '
                    'the raw emitter stamps no TraceContext, so the span is an '
                    'orphan in every batch tree — open it with obs.span()/'
                    'obs.stage() (inside use_trace/link) instead')
            elif name in _SPAN_OPENERS:
                rolled = sorted(kw.arg for kw in node.keywords
                                if kw.arg in _IDENTITY_KWARGS)
                if rolled:
                    yield self.finding(
                        src, node.lineno,
                        '{}(...) passes hand-rolled causal identity ({}): '
                        'identity must come from the active TraceContext — '
                        'wrap the block in obs.use_trace(ctx) or adopt a '
                        'late-discovered parent with sp.link(ctx)'.format(
                            name, ', '.join('{}='.format(k) for k in rolled)))
