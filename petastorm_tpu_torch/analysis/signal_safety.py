"""PT704 — signal-handler-reachable code must be async-signal-safe.

The flight recorder (``observability/blackbox.py``) stamps its crash-cause
footer from inside a Python signal handler: that code runs at an arbitrary
bytecode boundary of whatever the main thread was doing.  The rules there
are stricter than ordinary thread safety:

* **no lock acquisition** — if the interrupted code holds the lock, the
  handler deadlocks the process it was trying to forensically describe;
* **no logging** — the logging module takes a module-level lock and
  allocates handlers/records (same deadlock, plus reentrancy);
* **no imports** — the import system takes the import lock and runs
  arbitrary module code;
* **no allocation-heavy calls** — ``open()``, ``json``/``pickle``
  serialization and ``Struct.pack`` all allocate; an allocation while the
  interrupted frame is mid-``malloc`` corrupts the heap in the worst case
  and raises ``MemoryError`` inside the handler in the best.
  ``Struct.pack_into`` on a preallocated buffer is the sanctioned pattern.

The checker discovers handler entry points lexically — functions installed
with ``signal.signal(sig, fn)`` — then walks the intra-module call graph
(plain calls by name, method calls by attribute name) and reports the
violations reachable from any handler.  Code that is NOT handler-reachable
may freely lock and log; only the handler cone is constrained.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, attr_chain, walk_functions

#: dotted-call chains that allocate (or serialize, which allocates)
_ALLOCATING_CALLS = {'json.dumps', 'json.loads', 'json.dump', 'json.load',
                     'pickle.dumps', 'pickle.loads', 'pickle.dump',
                     'pickle.load', 'marshal.dumps', 'marshal.loads'}

#: call bases whose methods route through the logging module
_LOGGING_BASES = ('logger', 'logging', 'log')


def _call_name(call):
    """Dotted chain of a call's target ('signal.signal', 'self._lock.acquire',
    'open'), or None for computed targets."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    return attr_chain(call.func)


def _tail(chain):
    return chain.rsplit('.', 1)[-1]


def _handler_roots(tree):
    """Function names installed as signal handlers anywhere in the module:
    the second argument of ``signal.signal(sig, fn)`` when it names a local
    function or method (``SIG_DFL``/``SIG_IGN`` and foreign callables are
    not entry points we can check)."""
    roots = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _call_name(node)
        if chain is None or _tail(chain) != 'signal' or len(node.args) < 2:
            continue
        if not (chain == 'signal' or chain.endswith('.signal')):
            continue
        handler = node.args[1]
        name = None
        if isinstance(handler, ast.Name):
            name = handler.id
        elif isinstance(handler, ast.Attribute):
            name = handler.attr
        if name and name not in ('SIG_DFL', 'SIG_IGN'):
            roots.add(name)
    return roots


class SignalSafetyChecker(Checker):
    code = 'PT704'
    name = 'async-signal-safety'
    description = ('code reachable from a signal handler must not acquire '
                   'locks, log, import, open files, or allocate through '
                   'serializers/Struct.pack — the interrupted frame may hold '
                   'the very lock (or be mid-malloc), deadlocking or '
                   'corrupting the process the handler is trying to describe')
    scope = ('*observability/blackbox*.py',)

    def check(self, src):
        funcs = {}
        for func, _cls in walk_functions(src.tree):
            funcs.setdefault(func.name, []).append(func)
        roots = _handler_roots(src.tree) & set(funcs)
        if not roots:
            return
        # BFS over the intra-module call graph: plain calls by name, method
        # calls by attribute name (receiver types are not resolved — a
        # same-named local function is conservatively treated as reachable)
        reachable, frontier = set(roots), list(roots)
        while frontier:
            name = frontier.pop()
            for func in funcs[name]:
                for node in ast.walk(func):
                    if not isinstance(node, ast.Call):
                        continue
                    chain = _call_name(node)
                    if chain is None:
                        continue
                    callee = _tail(chain)
                    if callee in funcs and callee not in reachable:
                        reachable.add(callee)
                        frontier.append(callee)
        for name in sorted(reachable):
            for func in funcs[name]:
                yield from self._check_function(src, func)

    def _check_function(self, src, func):
        where = 'handler-reachable `{}`'.format(func.name)
        for node in ast.walk(func):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                yield self.finding(
                    src, node.lineno,
                    'import inside {}: the import system takes the import '
                    'lock and runs module code — hoist to module scope'.format(where))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    chain = attr_chain(expr) or ''
                    if 'lock' in chain.lower():
                        yield self.finding(
                            src, node.lineno,
                            '`with {}` inside {}: the interrupted frame may '
                            'already hold it — a signal handler that blocks '
                            'on a lock deadlocks the process'.format(chain, where))
            elif isinstance(node, ast.Call):
                yield from self._check_call(src, node, where)

    def _check_call(self, src, call, where):
        chain = _call_name(call)
        if chain is None:
            return
        tail = _tail(chain)
        if tail == 'acquire' and 'lock' in chain.lower():
            yield self.finding(
                src, call.lineno,
                '{}() inside {}: a signal handler must never block on a '
                'lock the interrupted frame may hold'.format(chain, where))
        elif chain.split('.', 1)[0] in _LOGGING_BASES and tail in (
                'debug', 'info', 'warning', 'error', 'exception', 'critical', 'log'):
            yield self.finding(
                src, call.lineno,
                '{}() inside {}: logging locks and allocates — stamp a '
                'preallocated buffer instead'.format(chain, where))
        elif chain == 'open':
            yield self.finding(
                src, call.lineno,
                'open() inside {}: allocates and may block — keep the fd '
                'open for the process lifetime instead'.format(where))
        elif chain in _ALLOCATING_CALLS:
            yield self.finding(
                src, call.lineno,
                '{}() inside {}: serialization allocates — the handler may '
                'interrupt a frame mid-malloc'.format(chain, where))
        elif tail == 'pack' and '.' in chain:
            yield self.finding(
                src, call.lineno,
                '{}() inside {}: Struct.pack allocates a fresh bytes object '
                'per call — use pack_into on a preallocated buffer'.format(
                    chain, where))
