"""PT700 — telemetry span/timer hygiene.

Every span or stage timer opened in instrumented code must be closed on all
paths: an unclosed span never records its event (the trace silently loses the
stage), and an unclosed timer never accumulates its seconds (the stall
attribution under-counts exactly the stage that crashed or early-returned —
the worst possible skew). The observability API is shaped for this: ``span``
and ``stage`` return context managers, so ``with obs.stage('decode'): ...`` is
both the cheapest and the only lint-clean form.

A span-opening call is flagged unless one of these holds:

* it is the context expression of a ``with`` (the canonical form);
* it is assigned to a name that is later entered with ``with`` or explicitly
  closed (``.end()``/``.finish()``/``.close()``/``.stop()``/``.__exit__()``)
  inside a ``finally`` block of the same function;
* ownership escapes — the result is returned/yielded or passed to another
  call.

Matched openers: bare ``span(...)``/``stage(...)`` calls, the same names on
an observability-module receiver (``obs.stage(...)``,
``observability.span(...)``, ``trace.span(...)``), and the unambiguous
``start_span``/``begin_span``/``start_timer`` spellings on any receiver.
``m.span()`` on a regex match (or any other non-telemetry receiver) is not
matched.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, add_parents, walk_functions

#: names only matched as bare calls or on a telemetry-module receiver
_AMBIGUOUS_OPENERS = {'span', 'stage'}

#: names matched on any receiver (no non-telemetry meaning in this tree)
_UNAMBIGUOUS_OPENERS = {'start_span', 'begin_span', 'start_timer', 'begin_timer'}

#: module-style receivers that mark span/stage as telemetry calls
_TELEMETRY_RECEIVERS = {'obs', 'observability', 'telemetry', 'trace', 'tracing'}

_CLOSERS = {'end', 'finish', 'close', 'stop', '__exit__'}


def _opener_name(call):
    """The opener name when ``call`` opens a span/timer, else None."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in _AMBIGUOUS_OPENERS or func.id in _UNAMBIGUOUS_OPENERS:
            return func.id
        return None
    if isinstance(func, ast.Attribute):
        if func.attr in _UNAMBIGUOUS_OPENERS:
            return func.attr
        if func.attr in _AMBIGUOUS_OPENERS and isinstance(func.value, ast.Name) \
                and func.value.id in _TELEMETRY_RECEIVERS:
            return func.attr
    return None


def _closed_or_reentered(func, name):
    """Is the name (bound to an opened span) entered with ``with`` anywhere,
    or closed inside a ``finally`` block, within ``func``?"""
    for node in ast.walk(func):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return True
        elif isinstance(node, ast.Try) and node.finalbody:
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in _CLOSERS \
                            and isinstance(sub.func.value, ast.Name) \
                            and sub.func.value.id == name:
                        return True
    return False


class TelemetrySpanChecker(Checker):
    code = 'PT700'
    name = 'telemetry-span-hygiene'
    description = ('span/stage timers opened without a with-block or a '
                   'try/finally close: a leaked span skews stall attribution')
    scope = ('*.py',)

    def check(self, src):
        add_parents(src.tree)
        for func, _cls in walk_functions(src.tree):
            yield from self._check_function(src, func)

    def _check_function(self, src, func):
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            opener = _opener_name(node)
            if opener is None:
                continue
            parent = getattr(node, 'pt_parent', None)
            # `with span(...)`: canonical
            if isinstance(parent, ast.withitem):
                continue
            # ownership escapes: returned/yielded, passed to another call,
            # stored into an attribute/container (an owner manages it)
            if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom,
                                   ast.Call, ast.Starred, ast.keyword)):
                continue
            if isinstance(parent, ast.Assign):
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in parent.targets):
                    continue
                names = [t.id for t in parent.targets if isinstance(t, ast.Name)]
                if names and all(_closed_or_reentered(func, n) for n in names):
                    continue
                yield self.finding(
                    src, node.lineno,
                    "span/timer from {}(...) bound to {} but not closed on all "
                    "paths in {}(): use 'with', or close it in a try/finally".format(
                        opener, ' / '.join(repr(n) for n in names) or 'a target',
                        func.name))
                continue
            # bare expression (opened and dropped) or any other use: the span
            # can never be closed
            yield self.finding(
                src, node.lineno,
                '{}(...) opened without entering its context in {}() — the '
                'span/timer never closes and its stage is lost from '
                'attribution'.format(opener, func.name))
