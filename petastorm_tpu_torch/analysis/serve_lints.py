"""PT1000 — serve actuator discipline.

The serve daemon is a LONG-LIVED multi-tenant process whose admission /
eviction / detach decisions change other processes' behavior at a distance:
an eviction kills a training job's input stream, an admit changes everyone's
fair share. The debugging story for "my consumer was evicted — why?"
(``docs/troubleshooting.md``) is the daemon's trace ring, which only works if
every actuation leaves a span there naming the tenant it acted on. This rule
makes that discipline mechanical (the serve-plane analog of PT702):

* every call to a serve **actuator** — broadcast-ring slot operations
  (``<x>.ring.join()``, ``evict``, ``leave``) and scheduler tenancy
  operations (``add_tenant``, ``remove_tenant``) — inside
  ``petastorm_tpu_torch/serve/`` must sit lexically inside a ``with obs.span(...)``
  (or ``stage(...)``) block **whose span carries a ``tenant=`` argument**, so
  the decision lands in the trace next to the tenant it affected.

The rule scopes to the serve package only: the primitives themselves are
defined in ``native/shm_ring.py`` / ``workers/ventilator.py`` and are called
freely by tests; the discipline binds the daemon, the one caller that
actuates autonomously against other processes.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, add_parents, attr_chain, walk_functions

#: method names that are serve actuators wherever they appear in serve/
_ACTUATORS = frozenset({'evict', 'leave', 'add_tenant', 'remove_tenant'})

#: span-context callables that satisfy the wrapping requirement
_SPAN_OPENERS = frozenset({'span', 'stage', 'decision_span'})


def _call_name(call):
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_actuator(call):
    name = _call_name(call)
    if name in _ACTUATORS:
        return name
    if name == 'join':
        # only broadcast-ring joins (x.ring.join()) — never thread/pool joins
        chain = attr_chain(call.func) or ''
        if chain.endswith('.ring.join') or chain == 'ring.join':
            return 'ring.join'
    return None


def _tenant_span_around(node, stop_at):
    """Is ``node`` lexically inside a ``with`` opening a span that carries a
    ``tenant=`` keyword, before ``stop_at``?"""
    cur = node
    while cur is not None and cur is not stop_at:
        parent = getattr(cur, 'pt_parent', None)
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            for item in parent.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and _call_name(expr) in _SPAN_OPENERS \
                        and any(kw.arg == 'tenant' for kw in expr.keywords):
                    return True
        cur = parent
    return False


class ServeActuatorChecker(Checker):
    code = 'PT1000'
    name = 'serve-actuator-discipline'
    description = ('serve-path actuators (admit/evict/detach: ring.join, '
                   'evict, leave, add_tenant, remove_tenant) must run inside '
                   'a traced span carrying the tenant id — an unexplained '
                   'eviction is an undebuggable one')
    scope = ('*serve/*.py',)

    def check(self, src):
        add_parents(src.tree)
        for func, _cls in walk_functions(src.tree):
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = _is_actuator(node)
                if name is None:
                    continue
                if not _tenant_span_around(node, func):
                    yield self.finding(
                        src, node.lineno,
                        '{}() called outside a tenant-tagged span: wrap the '
                        'actuation in `with obs.span(..., tenant=<id>)` so the '
                        'decision is reconstructable from the daemon trace'
                        .format(name))
