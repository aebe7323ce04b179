"""PT100/PT101 — lock discipline in the concurrent data-plane modules.

**PT100** A class that guards shared state with a ``threading.Lock``/
``RLock``/``Condition`` must write that state under the lock everywhere: an
attribute is *lock-guarded* once any method writes or mutates it inside a
``with self._lock`` block, and any write to a guarded attribute outside such a
block (``__init__`` excepted — no second thread exists yet) is a torn-update
waiting for a scheduler interleaving. This is exactly the discipline the
pools/ventilator document by hand today.

**PT101** Nested lock acquisitions define a lock-order graph (edge A -> B when
B is acquired while A is held, including one level of ``self.method()``
indirection within the class). A cycle in that graph is a latent ABBA
deadlock: two threads entering from different edges block forever.

Scope: the concurrency domains named in the analysis brief — ``workers/``,
``shuffling_buffer.py``, ``cache.py``, ``reader.py`` — plus the other modules
that hold locks today (``torch/``, ``native/``, ``local_disk_cache.py``).
"""

from __future__ import annotations

import ast
from collections import defaultdict

from petastorm_tpu_torch.analysis.core import Checker, attr_chain, class_methods

#: constructors whose result is a lock-like guard
_LOCK_FACTORIES = {'Lock', 'RLock', 'Condition', 'Semaphore', 'BoundedSemaphore'}

#: method calls that mutate their receiver in place
_MUTATORS = {'append', 'appendleft', 'add', 'clear', 'discard', 'extend',
             'insert', 'pop', 'popitem', 'popleft', 'remove', 'update',
             'setdefault', 'sort', 'reverse'}


def _is_lock_ctor(node):
    """True for ``threading.Lock()``, ``Lock()``, ``mp_ctx.RLock()``, ..."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    return name in _LOCK_FACTORIES


def _self_attr(node):
    """'attr' when node is ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == 'self':
        return node.attr
    return None


def _with_lock_attrs(with_node, lock_attrs):
    """Lock attributes of ``self`` acquired by a ``with`` statement."""
    acquired = []
    for item in with_node.items:
        expr = item.context_expr
        # `with self._lock:` and `with self._cv:` (Condition) both guard
        attr = _self_attr(expr)
        if attr in lock_attrs:
            acquired.append(attr)
    return acquired


class _MethodScan(ast.NodeVisitor):
    """One pass over a method body tracking the held-locks stack. Records
    attribute writes/mutations with the lock set held at that point, direct
    ``self.m()`` calls under a lock, and nested acquisition edges."""

    def __init__(self, lock_attrs):
        self.lock_attrs = lock_attrs
        self.held = []           # stack of lock attr names
        self.writes = []         # (attr, frozenset(held), lineno, is_mutation)
        self.calls_under = []    # (method_name, frozenset(held), lineno)
        self.edges = []          # (outer_lock, inner_lock, lineno)
        self.acquired_any = False

    def visit_With(self, node):
        acquired = _with_lock_attrs(node, self.lock_attrs)
        if acquired:
            self.acquired_any = True
            for outer in self.held:
                for inner in acquired:
                    if outer != inner:
                        self.edges.append((outer, inner, node.lineno))
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()
        # with-items themselves are not re-visited: acquisition handled above

    visit_AsyncWith = visit_With

    def _record_write(self, target, lineno):
        attr = _self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)  # self.d[k] = v mutates self.d
        if attr is not None and attr not in self.lock_attrs:
            self.writes.append((attr, frozenset(self.held), lineno, False))

    def visit_Assign(self, node):
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                self._record_write(el, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._record_write(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._record_write(node.target, node.lineno)
            self.visit(node.value)

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            recv_attr = _self_attr(func.value)
            if func.attr in _MUTATORS and recv_attr is not None \
                    and recv_attr not in self.lock_attrs:
                self.writes.append((recv_attr, frozenset(self.held), node.lineno, True))
            if recv_attr is None and _self_attr(func) is not None and self.held:
                # self.m(...) while holding a lock: one indirection level for
                # the lock-order graph
                self.calls_under.append((func.attr, frozenset(self.held), node.lineno))
        self.generic_visit(node)

    # nested defs/lambdas run later, possibly on another thread or lock
    # context — their writes are not attributable to the current held set
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return


class LockDisciplineChecker(Checker):
    code = 'PT100'
    codes = ('PT100', 'PT101')
    name = 'lock-discipline'
    description = ('writes to lock-guarded shared state outside "with self._lock"; '
                   'lock-acquisition-order cycles (PT101)')
    scope = ('*workers/*.py', '*shuffling_buffer.py', '*cache.py', '*reader.py',
             '*/torch/*.py', '*native/*.py', '*local_disk_cache.py',
             '*chunkstore/*.py', '*fabric/*.py')

    def check(self, src):
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(src, node)

    def _check_class(self, src, classdef):
        methods = class_methods(classdef)
        lock_attrs = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            lock_attrs.add(attr)
        if not lock_attrs:
            return

        scans = {}
        for m in methods:
            scan = _MethodScan(lock_attrs)
            for stmt in m.body:
                scan.visit(stmt)
            scans[m.name] = scan

        # pass 1: attributes written/mutated at least once under a lock
        guarded = set()
        for scan in scans.values():
            for attr, held, _lineno, _mut in scan.writes:
                if held:
                    guarded.add(attr)

        # pass 2: writes to guarded attributes with no lock held
        for name, scan in scans.items():
            if name == '__init__':
                continue
            for attr, held, lineno, is_mutation in scan.writes:
                if attr in guarded and not held:
                    verb = 'mutation of' if is_mutation else 'write to'
                    yield self.finding(
                        src, lineno,
                        "{} lock-guarded attribute 'self.{}' outside a 'with' on {} "
                        '(class {})'.format(
                            verb, attr,
                            ' / '.join("'self.{}'".format(a) for a in sorted(lock_attrs)),
                            classdef.name))

        # pass 3: lock-order graph (direct nesting + one self-call indirection)
        edges = defaultdict(set)
        edge_lines = {}
        for scan in scans.values():
            for outer, inner, lineno in scan.edges:
                edges[outer].add(inner)
                edge_lines.setdefault((outer, inner), lineno)
            for callee, held, lineno in scan.calls_under:
                callee_scan = scans.get(callee)
                if callee_scan is None:
                    continue
                inner_locks = {a for _, h, _, _ in callee_scan.writes for a in h}
                for _, h, _ in callee_scan.calls_under:
                    inner_locks |= set(h)
                for outer in held:
                    for inner in inner_locks:
                        if outer != inner:
                            edges[outer].add(inner)
                            edge_lines.setdefault((outer, inner), lineno)
        for cycle in _find_cycles(edges):
            first = edge_lines.get((cycle[0], cycle[1]), classdef.lineno)
            yield self.finding(
                src, first,
                'lock-acquisition-order cycle {} in class {} — two threads entering '
                'from different edges deadlock'.format(
                    ' -> '.join("'self.{}'".format(a) for a in cycle + (cycle[0],)),
                    classdef.name),
                code='PT101')


def _find_cycles(edges):
    """Minimal distinct cycles of a small digraph, as node tuples."""
    cycles = []
    seen_cycles = set()

    def dfs(start, node, path):
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                canon = tuple(path)
                rotations = {canon[i:] + canon[:i] for i in range(len(canon))}
                if not rotations & seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(canon)
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for start in sorted(edges):
        dfs(start, start, [start])
    return cycles
