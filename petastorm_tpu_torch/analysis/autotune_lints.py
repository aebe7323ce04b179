"""PT702 — autotune action discipline.

The autotuner exists to change a RUNNING pipeline's configuration, which is
exactly why its writes must be disciplined: a knob move that leaves no trace
is an unexplainable config change ("the autotuner changed my config — why?"
is a documented troubleshooting entry), and a knob write that skips the clamp
can push a pool or budget outside the bounds the user set. Both failure modes
are lexically checkable, so this rule checks them:

* every call to a knob **actuator** (``add_worker_slot``,
  ``retire_worker_slot``, ``set_prefetch_budget``, ``set_shuffle_capacity``,
  ``set_max_queue_size``, ``resize``) inside ``petastorm_tpu_torch/autotune/`` must
  sit lexically inside a ``with decision_span(...)`` (or ``obs.span(...)``)
  block — the change then lands in the trace ring as an ``autotune.decision``
  event next to the code that made it;
* every **value** passed to a value-bearing actuator must come from
  ``clamp(...)`` — either directly at the call site or via a name assigned
  from a ``clamp(...)`` call in the same function. Constants, raw arithmetic
  and config reads are rejected: the bounds live in one place and every write
  must pass through them.

The rule scopes to the autotune package only: the actuators themselves are
DEFINED elsewhere (pools, loader, chunk-cache config) and called freely by
tests and user code — the discipline applies to the controller, the one
caller that moves knobs autonomously.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, add_parents, walk_functions

#: knob actuators: calls that change a running pipeline's configuration
_ACTUATORS = frozenset({'add_worker_slot', 'retire_worker_slot',
                        'set_prefetch_budget', 'set_shuffle_capacity',
                        'set_max_queue_size', 'resize'})

#: actuators whose arguments are knob values and must be clamp-derived
_VALUE_ACTUATORS = frozenset({'set_prefetch_budget', 'set_shuffle_capacity',
                              'resize'})

#: span-context callables that satisfy the wrapping requirement
_SPAN_OPENERS = frozenset({'decision_span', 'span', 'stage'})


def _call_name(call):
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _inside_decision_span(node, stop_at):
    """Is ``node`` lexically inside a ``with`` whose context expression opens
    a span (``decision_span(...)`` / ``obs.span(...)``), before ``stop_at``?"""
    cur = node
    while cur is not None and cur is not stop_at:
        parent = getattr(cur, 'pt_parent', None)
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            for item in parent.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and _call_name(expr) in _SPAN_OPENERS:
                    return True
        cur = parent
    return False


def _clamp_assigned_names(func):
    """Names assigned from a ``clamp(...)`` call anywhere in ``func``."""
    names = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _call_name(node.value) == 'clamp':
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
    return names


def _is_clamped(arg, clamped_names):
    if isinstance(arg, ast.Call) and _call_name(arg) == 'clamp':
        return True
    return isinstance(arg, ast.Name) and arg.id in clamped_names


class AutotuneActionChecker(Checker):
    code = 'PT702'
    name = 'autotune-action-discipline'
    description = ('autotune knob actuations must be decision_span-wrapped '
                   'and pass their values through clamp() — unexplained or '
                   'unbounded knob writes are rejected')
    scope = ('*autotune/*.py',)

    def check(self, src):
        add_parents(src.tree)
        for func, _cls in walk_functions(src.tree):
            clamped = None  # lazy: most functions touch no actuator
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name not in _ACTUATORS:
                    continue
                if not _inside_decision_span(node, func):
                    yield self.finding(
                        src, node.lineno,
                        '{}() called outside a decision_span: the knob change '
                        'would leave no autotune.decision event to explain '
                        'it'.format(name))
                if name in _VALUE_ACTUATORS:
                    if clamped is None:
                        clamped = _clamp_assigned_names(func)
                    values = list(node.args) + [kw.value for kw in node.keywords]
                    for arg in values:
                        if not _is_clamped(arg, clamped):
                            yield self.finding(
                                src, node.lineno,
                                '{}() takes a value that did not pass through '
                                'clamp(): knob writes must be bounded by the '
                                "config's explicit [min, max]".format(name))
                            break
