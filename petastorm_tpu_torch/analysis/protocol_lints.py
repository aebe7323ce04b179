"""PT800/PT801 — worker-pool protocol lints.

The supervision protocol's correctness argument (``docs/protocol.md``) leans
on two source-level disciplines the model checker and runtime monitor cannot
see:

* **PT800 — exhaustive message-kind dispatch.** A consumer switch over the
  results-channel kind bytes (``if kind == MSG_DATA: ... elif ...``) that
  misses a declared kind silently drops that message class — the historical
  failure mode of hand-rolled ``if msg[0] == ...`` chains (a dropped
  ``MSG_METRICS`` loses telemetry; a dropped ``MSG_DONE`` wedges the epoch).
  Every dispatch chain comparing a common subject against two or more kind
  constants must either cover ALL kinds declared in
  ``workers/protocol.MESSAGE_KINDS`` or carry an explicit ``else`` default.
* **PT801 — canonical protocol constants.** ``workers/protocol.py`` is the
  single definition site for message-kind bytes, the control sentinel and the
  ring framing. A second definition (``_DATA = b'D'`` in a pool module, or a
  raw kind byte literal in a comparison) re-opens the drift the 2024-era
  petastorm forks suffered, where two modules disagreed about one byte.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker
from petastorm_tpu_torch.workers.protocol import KIND_CONSTANT_NAMES, MESSAGE_KINDS

#: canonical kind name (e.g. 'DATA') per recognized constant identifier:
#: the MSG_* names plus the legacy underscore spellings
_KIND_BY_IDENT = {}
for _name, _byte in KIND_CONSTANT_NAMES.items():
    _KIND_BY_IDENT[_name] = _name[len('MSG_'):]
    _KIND_BY_IDENT['_' + _name[len('MSG_'):]] = _name[len('MSG_'):]

_ALL_KIND_NAMES = frozenset(_KIND_BY_IDENT.values())

#: the reserved wire bytes (kind bytes + the control sentinel)
_RESERVED_BYTES = frozenset(MESSAGE_KINDS) | {b'FINISHED'}

#: identifiers PT801 treats as protocol-constant definitions
_PROTOCOL_IDENTS = frozenset(_KIND_BY_IDENT) | {
    'CONTROL_FINISHED', '_CONTROL_FINISHED', 'RING_HEADER_LEN'}

_CANONICAL_MODULE = 'workers/protocol.py'


def _ident_of(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _kind_names_in_test(test):
    """Canonical kind names a branch test handles, plus the comparison subject
    (unparsed) — or (None, ()) when the test is not a kind comparison.
    Understands ``x == K``, ``x == K1 or x == K2``, and ``x in (K1, K2)``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        subject = None
        names = []
        for value in test.values:
            s, n = _kind_names_in_test(value)
            if s is None:
                return None, ()
            if subject is None:
                subject = s
            elif s != subject:
                return None, ()
            names.extend(n)
        return subject, tuple(names)
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None, ()
    op = test.ops[0]
    comparator = test.comparators[0]
    if isinstance(op, ast.Eq):
        candidates = [comparator]
    elif isinstance(op, ast.In) and isinstance(comparator, (ast.Tuple, ast.List, ast.Set)):
        candidates = list(comparator.elts)
    else:
        return None, ()
    names = []
    for cand in candidates:
        kind = _KIND_BY_IDENT.get(_ident_of(cand) or '')
        if kind is None:
            return None, ()
        names.append(kind)
    return ast.unparse(test.left), tuple(names)


class ProtocolLintChecker(Checker):
    """PT800 (non-exhaustive kind dispatch) + PT801 (protocol constants
    defined outside ``workers/protocol.py``)."""

    code = 'PT800'
    codes = ('PT800', 'PT801')
    name = 'protocol-discipline'
    description = ('message-kind dispatch chains must cover every declared kind '
                   'or carry an else (PT800); protocol constants/bytes are '
                   'defined only in workers/protocol.py (PT801)')
    scope = ('*workers/*.py',)

    def _is_canonical_module(self, src):
        return src.relpath.endswith('protocol.py')

    def check(self, src):
        yield from self._check_dispatch_chains(src)
        if not self._is_canonical_module(src):
            yield from self._check_definition_site(src)

    # -- PT800 ---------------------------------------------------------------

    def _chain_heads(self, tree):
        """Top ``ast.If`` nodes of elif chains (an If that is some other If's
        sole orelse member is a link, not a head)."""
        links = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.If) and len(node.orelse) == 1 \
                    and isinstance(node.orelse[0], ast.If):
                links.add(id(node.orelse[0]))
        return [n for n in ast.walk(tree)
                if isinstance(n, ast.If) and id(n) not in links]

    def _check_dispatch_chains(self, src):
        for head in self._chain_heads(src.tree):
            node = head
            subject = None
            handled = []
            branches = 0
            has_default = False
            while True:
                s, names = _kind_names_in_test(node.test)
                if s is not None and (subject is None or s == subject):
                    subject = s
                    handled.extend(names)
                    branches += 1
                orelse = node.orelse
                if len(orelse) == 1 and isinstance(orelse[0], ast.If):
                    node = orelse[0]
                    continue
                has_default = bool(orelse)
                break
            if branches < 2:
                continue  # one comparison is a guard, not a dispatch
            missing = sorted(_ALL_KIND_NAMES - set(handled))
            if missing and not has_default:
                yield self.finding(
                    src, head.lineno,
                    'message-kind dispatch on {!r} misses declared kind(s) {} '
                    'and has no else — a message of a missing kind is silently '
                    'dropped; handle every workers/protocol.MESSAGE_KINDS entry '
                    'or add an explicit default'.format(subject, ', '.join(missing)),
                    code='PT800')

    # -- PT801 ---------------------------------------------------------------

    def _check_definition_site(self, src):
        imported = self._imported_protocol_names(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    elts = target.elts if isinstance(target, ast.Tuple) else [target]
                    for el in elts:
                        name = el.id if isinstance(el, ast.Name) else None
                        if name in _PROTOCOL_IDENTS and name not in imported:
                            yield self.finding(
                                src, node.lineno,
                                'protocol constant {!r} defined outside the '
                                'canonical module — import it from '
                                'petastorm_tpu_torch.{} instead'.format(
                                    name, _CANONICAL_MODULE.replace('/', '.')[:-3]),
                                code='PT801')
            elif isinstance(node, ast.Compare):
                for comp in node.comparators:
                    if isinstance(comp, ast.Constant) and comp.value in _RESERVED_BYTES:
                        yield self.finding(
                            src, node.lineno,
                            'raw protocol byte {!r} in a comparison — use the '
                            'named constant from petastorm_tpu_torch.{}'.format(
                                comp.value, _CANONICAL_MODULE.replace('/', '.')[:-3]),
                            code='PT801')

    @staticmethod
    def _imported_protocol_names(tree):
        """Names bound by ``from ...protocol import ...`` — rebinding an
        imported canonical name (e.g. an alias line) is not a definition."""
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.endswith('protocol'):
                names.update(alias.asname or alias.name for alias in node.names)
        return names
