"""PT1500 — fabric socket operations must be timeout-armed and deadline-bound.

The chunk fabric's failure contract (``docs/fabric.md``) rests on two
lexically checkable disciplines in ``petastorm_tpu_torch/fabric/``:

* **explicit per-operation timeouts** — a blocking socket call with no
  timeout turns one stalled peer into a wedged reader thread; every function
  that touches a socket primitive must either arm ``settimeout`` itself or
  receive the armed socket alongside a ``deadline`` parameter (the protocol
  helpers' shape: they re-arm the timeout from the deadline before every
  partial send/recv);
* **an end-to-end deadline context** — per-operation timeouts alone let N
  slow-but-not-stalled operations stack their budgets, so every data-moving
  socket primitive (everything but ``accept``) must run under a
  :class:`~petastorm_tpu_torch.fabric.protocol.Deadline`: either the function
  takes one as a parameter or it constructs one.

``accept`` is exempt from the deadline requirement — the accept loop is a
poll, not a transfer — but still needs its timeout (an un-armed ``accept``
cannot notice ``stop()``).
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, walk_functions

#: blocking socket primitives the rule recognizes (attribute-call tails)
_SOCKET_OPS = frozenset({'connect', 'recv', 'recv_into', 'recvfrom', 'send',
                         'sendall', 'sendto', 'accept'})

#: ops that move transfer data and therefore need the deadline context too
_DATA_OPS = _SOCKET_OPS - {'accept'}


def _socket_op_calls(func):
    """Every ``<expr>.<op>(...)`` call in ``func`` whose op is a blocking
    socket primitive, as (op name, call node) pairs."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _SOCKET_OPS:
                yield node.func.attr, node


def _param_names(func):
    args = func.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return frozenset(names)


def _arms_timeout(func):
    """Does ``func`` call ``.settimeout(...)`` anywhere?"""
    return any(isinstance(node, ast.Call)
               and isinstance(node.func, ast.Attribute)
               and node.func.attr == 'settimeout'
               for node in ast.walk(func))


def _builds_deadline(func):
    """Does ``func`` construct a Deadline (``Deadline(...)`` or
    ``P.Deadline(...)``)?"""
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id == 'Deadline':
            return True
        if isinstance(f, ast.Attribute) and f.attr == 'Deadline':
            return True
    return False


class FabricSocketChecker(Checker):
    code = 'PT1500'
    name = 'fabric-socket-discipline'
    description = ('socket operations in fabric/ must carry an explicit '
                   'per-operation timeout and run under an end-to-end '
                   'Deadline budget: an un-armed blocking call turns one '
                   'stalled peer into a wedged reader')
    scope = ('*fabric/*.py',)

    def check(self, src):
        for func, _cls in walk_functions(src.tree):
            ops = list(_socket_op_calls(func))
            if not ops:
                continue
            params = _param_names(func)
            has_deadline = ('deadline' in params) or _builds_deadline(func)
            armed = _arms_timeout(func) or 'deadline' in params
            for op, call in ops:
                if not armed:
                    yield self.finding(
                        src, call.lineno,
                        '.{}() in a function that neither arms settimeout '
                        'nor receives a deadline: a stalled peer blocks this '
                        'call forever — arm the socket or take the transfer '
                        'deadline as a parameter'.format(op))
                elif op in _DATA_OPS and not has_deadline:
                    yield self.finding(
                        src, call.lineno,
                        '.{}() outside a deadline context: per-operation '
                        'timeouts stack without an end-to-end budget — take '
                        'a deadline parameter or construct a protocol.'
                        'Deadline in this function'.format(op))
