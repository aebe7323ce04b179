"""PT1300–PT1303 — whole-program race lints over the thread plane.

PT100/PT101 (:mod:`locks`) are deliberately *class-local*: they prove each
class's own lock discipline. But the pipeline's threads cross class and
module boundaries constantly — the autotune tick actuates pool knobs, pools
call back into the ventilator, slots call registry callbacks — and the
defects that survive class-local checking are exactly the cross-cutting
ones. This module builds ONE model over all the concurrency domains
(``workers/``, ``serve/``, ``elastic/``, ``autotune/``, ``chunkstore/``,
``observability/``, ``torch/``, ``shuffling_buffer.py``,
``native/lifetime.py``) and checks four whole-program properties:

**PT1300** cross-class lock-order cycles. Every ``with self._lock`` nesting
and every call made *while holding a lock* contributes edges to a global
lock-order graph; calls are resolved through ``self`` helpers (any depth —
superseding PT101's one-level limit), through attributes with a known
constructor type (``self._pool = ThreadPool(...)``), and — when a method
name is defined by at most a few scoped classes and is not a generic
container verb — by name. A cycle spanning two classes is an ABBA deadlock
no single class can see. Cycles PT101 already reports (single class, one
level of indirection) are deduplicated away: PT101 keeps class-local
cycles, PT1300 owns everything deeper or wider.

**PT1301** guarded reads. An attribute *mutated in place* (``.append``,
``self.d[k] = v``, ...) under a lock is a guarded mutable container;
reading it (iterating, subscripting, passing it on) with no lock held can
observe a torn view mid-mutation. Guarded-by inference follows ``self``
helper calls: a private helper invoked only under ``self._lock`` inherits
that lock for everything in its body (the ``# noqa: PT100 - caller holds
_cv`` convention, computed instead of annotated).

**PT1302** escaping guards. ``return self._items`` hands a caller a live
reference to a lock-guarded container — every use after the lock is
released is un-guarded. Copy out (``list(self._items)``) under the lock
instead.

**PT1303** blocking calls while holding a lock: ``queue.Queue.get/put``
without ``block=False``/``timeout``, ``Event.wait`` without a timeout,
``Condition.wait()`` without a timeout (unbounded — shutdown hangs; the
repo convention is ``wait(timeout=...)`` in a re-check loop), ``join``,
``time.sleep``, and lease/file I/O in ``elastic/`` — each stalls every
other thread that needs the lock for an unbounded time.

Scalar flag writes (``self._stop = True``) are PT100's domain and are
GIL-atomic; PT1301/PT1302 are deliberately restricted to *container
mutation* where a torn multi-step update is physically possible.
"""

from __future__ import annotations

import ast
from collections import defaultdict

from petastorm_tpu_torch.analysis.core import ProgramChecker, attr_chain, class_methods

#: constructors whose result is a lock-like guard (mirrors locks.py)
_LOCK_FACTORIES = {'Lock', 'RLock', 'Condition', 'Semaphore', 'BoundedSemaphore'}
_EVENT_FACTORIES = {'Event'}
_QUEUE_FACTORIES = {'Queue', 'SimpleQueue', 'LifoQueue', 'PriorityQueue',
                    'JoinableQueue'}

#: method calls that mutate their receiver in place (mirrors locks.py)
_MUTATORS = {'append', 'appendleft', 'add', 'clear', 'discard', 'extend',
             'insert', 'pop', 'popitem', 'popleft', 'remove', 'update',
             'setdefault', 'sort', 'reverse'}

#: wrappers that copy a container before it escapes — `return list(self._x)`
_COPY_WRAPPERS = {'list', 'dict', 'tuple', 'set', 'frozenset', 'sorted', 'len',
                  'sum', 'min', 'max', 'any', 'all', 'bool', 'str', 'repr'}

#: method names too generic to resolve by name across classes (container and
#: sync verbs every other type also defines) — resolving `x.get()` to every
#: class with a `get` would invent call edges that do not exist
_GENERIC_METHOD_NAMES = _MUTATORS | {
    'get', 'put', 'read', 'write', 'send', 'recv', 'close', 'open', 'copy',
    'items', 'keys', 'values', 'count', 'index', 'join', 'wait', 'notify',
    'notify_all', 'acquire', 'release', 'start', 'run', 'flush', 'seek',
    'format', 'split', 'strip', 'encode', 'decode', 'info', 'debug',
    'warning', 'error',
}

#: cap on name-based (untyped) resolution fan-out
_MAX_NAME_CANDIDATES = 3

#: call-graph propagation depth for lock-acquisition summaries
_MAX_CALL_DEPTH = 4

#: filesystem calls that are lease I/O when made in elastic/ modules
_FILE_IO_CHAINS = {'os.replace', 'os.fsync', 'os.rename', 'shutil.copy'}


def _self_attr(node):
    """'attr' when node is ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == 'self':
        return node.attr
    return None


def _ctor_name(value):
    """Class/type name constructed by ``value`` when it is a call like
    ``ClassName(...)`` / ``mod.ClassName(...)``, else None."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class _Scan(ast.NodeVisitor):
    """One pass over a method body: held-lock stack, reads/writes of ``self``
    attributes, calls (with enough receiver structure to resolve them), escape
    sites, and blocking calls."""

    def __init__(self, model):
        self.model = model
        self.held = []           # stack of held lock attr names
        self.acquired = set()    # every lock attr this method acquires
        self.writes = []         # (attr, frozenset(held), lineno, is_mutation)
        self.reads = []          # (attr, frozenset(held), lineno)
        self.calls = []          # (kind, recv, mname, frozenset(held), lineno)
        self.escapes = []        # (attr, frozenset(held), lineno, verb)
        self.blockers = []       # (kind, desc, frozenset(held), lineno)
        self.with_edges = []     # (outer, inner, lineno)
        self._skip = set()       # node ids consumed by a surrounding construct

    # -- lock acquisition ---------------------------------------------------

    def visit_With(self, node):
        acquired = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.model.lock_attrs:
                acquired.append(attr)
                self._skip.add(id(item.context_expr))
        if acquired:
            self.acquired.update(acquired)
            for outer in self.held:
                for inner in acquired:
                    if outer != inner:
                        self.with_edges.append((outer, inner, node.lineno))
        self.held.extend(acquired)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    # -- writes -------------------------------------------------------------

    def _record_write(self, target, lineno):
        attr = _self_attr(target)
        is_mutation = False
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)   # self.d[k] = v mutates self.d
            if attr is not None:
                is_mutation = True
                self._skip.add(id(target.value))
        if attr is not None and attr not in self.model.lock_attrs:
            self.writes.append((attr, frozenset(self.held), lineno, is_mutation))

    def visit_Assign(self, node):
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                self._record_write(el, node.lineno)
        self._record_store_escape(node)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._record_write(node.target, node.lineno)
        if isinstance(node.target, ast.Subscript):
            self.visit(node.target.value)
        self.visit(node.value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._record_write(node.target, node.lineno)
            self.visit(node.value)

    def _record_store_escape(self, node):
        """``other.x = self._items`` / ``d[k] = self._items`` stores a live
        reference into foreign state (PT1302 'store' flavor). ``self.x =
        self._y`` aliasing stays in-class and is not an escape."""
        values = (node.value.elts if isinstance(node.value, (ast.Tuple, ast.List))
                  else [node.value])
        stored = [a for a in (_self_attr(v) for v in values) if a is not None]
        if not stored:
            return
        for t in node.targets:
            base = None
            if isinstance(t, ast.Attribute):
                base = t.value
            elif isinstance(t, ast.Subscript):
                base = t.value
            if base is None or _self_attr(t) is not None:
                continue
            if isinstance(base, ast.Name) and base.id == 'self':
                continue
            for attr in stored:
                self.escapes.append((attr, frozenset(self.held), node.lineno,
                                     'stored into foreign state'))

    # -- escapes ------------------------------------------------------------

    def _escaping_attrs(self, value):
        """Bare ``self.attr`` references escaping via return/yield (tuples
        included; copy wrappers like ``list(...)`` do not escape)."""
        if value is None:
            return []
        values = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                  else [value])
        out = []
        for v in values:
            attr = _self_attr(v)
            if attr is not None and attr not in self.model.lock_attrs:
                out.append((attr, v))
        return out

    def visit_Return(self, node):
        for attr, v in self._escaping_attrs(node.value):
            self.escapes.append((attr, frozenset(self.held), node.lineno,
                                 'returned'))
            self._skip.add(id(v))
        if node.value is not None:
            self.visit(node.value)

    def visit_Yield(self, node):
        for attr, v in self._escaping_attrs(node.value):
            self.escapes.append((attr, frozenset(self.held), node.lineno,
                                 'yielded'))
            self._skip.add(id(v))
        if node.value is not None:
            self.visit(node.value)

    # -- calls / blockers ---------------------------------------------------

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            self._scan_method_call(node, func)
        elif isinstance(func, ast.Name) and func.id in _COPY_WRAPPERS:
            # `list(self._x)` copies — the attr read inside is still a read
            pass
        self.generic_visit(node)

    def _scan_method_call(self, node, func):
        mname = func.attr
        recv = func.value
        recv_attr = _self_attr(recv)
        held = frozenset(self.held)
        kwnames = {kw.arg for kw in node.keywords}

        # receiver bookkeeping --------------------------------------------
        if recv_attr is not None and mname in _MUTATORS \
                and recv_attr not in self.model.lock_attrs:
            self.writes.append((recv_attr, held, node.lineno, True))
            self._skip.add(id(recv))
        if _self_attr(func) is not None:
            # `self.m(...)` — a method fetch, not a state read
            self.calls.append(('self', None, mname, held, node.lineno))
            return
        if recv_attr is not None:
            self.calls.append(('attr', recv_attr, mname, held, node.lineno))
        elif isinstance(recv, ast.Name):
            self.calls.append(('var', recv.id, mname, held, node.lineno))

        # blocking-call detection -----------------------------------------
        has_timeout = 'timeout' in kwnames
        if mname == 'join':
            pos = node.args
            timeout_like = ((not pos and kwnames <= {'timeout'}) or
                            (len(pos) == 1 and not kwnames and
                             isinstance(pos[0], ast.Constant) and
                             isinstance(pos[0].value, (int, float))))
            if timeout_like:
                self.blockers.append(('join', '{}.join()'.format(
                    attr_chain(recv) or '<expr>'), held, node.lineno))
        elif mname == 'wait' and not node.args and not has_timeout:
            if recv_attr in self.model.lock_attrs:
                self.blockers.append(('cond-wait', 'self.{}.wait() without a '
                                      'timeout'.format(recv_attr), held,
                                      node.lineno))
            elif recv_attr in self.model.event_attrs:
                self.blockers.append(('event-wait', 'self.{}.wait() without a '
                                      'timeout'.format(recv_attr), held,
                                      node.lineno))
        elif recv_attr in self.model.queue_attrs:
            blocking = False
            if mname == 'get':
                blocking = not node.args and not has_timeout \
                    and 'block' not in kwnames
            elif mname == 'put':
                blocking = len(node.args) <= 1 and not has_timeout \
                    and 'block' not in kwnames
            if blocking:
                self.blockers.append(('queue', 'blocking self.{}.{}()'.format(
                    recv_attr, mname), held, node.lineno))
        else:
            chain = attr_chain(func)
            if chain == 'time.sleep':
                self.blockers.append(('sleep', 'time.sleep()', held,
                                      node.lineno))
            elif chain in _FILE_IO_CHAINS:
                self.blockers.append(('io', chain + '()', held, node.lineno))

    # -- reads --------------------------------------------------------------

    def visit_Attribute(self, node):
        if id(node) not in self._skip and isinstance(node.ctx, ast.Load):
            attr = _self_attr(node)
            if attr is not None and attr not in self.model.lock_attrs \
                    and attr not in self.model.event_attrs \
                    and attr not in self.model.queue_attrs:
                self.reads.append((attr, frozenset(self.held), node.lineno))
        self.generic_visit(node)

    # nested defs/lambdas run later, possibly on another thread or lock
    # context — their accesses are not attributable to the current held set
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return


class _ClassModel(object):
    """Per-class facts: lock/event/queue attributes, attribute constructor
    types, and one :class:`_Scan` per directly-defined method."""

    def __init__(self, src, classdef):
        self.src = src
        self.name = classdef.name
        self.lineno = classdef.lineno
        methods = class_methods(classdef)
        self.lock_attrs = set()
        self.event_attrs = set()
        self.queue_attrs = set()
        self.attr_types = {}
        for m in methods:
            for node in ast.walk(m):
                if not isinstance(node, ast.Assign):
                    continue
                ctor = _ctor_name(node.value)
                if ctor is None:
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if ctor in _LOCK_FACTORIES:
                        self.lock_attrs.add(attr)
                    elif ctor in _EVENT_FACTORIES:
                        self.event_attrs.add(attr)
                    elif ctor in _QUEUE_FACTORIES:
                        self.queue_attrs.add(attr)
                    elif ctor[:1].isupper():
                        self.attr_types[attr] = ctor
        self.scans = {}
        self.method_linenos = {}
        for m in methods:
            scan = _Scan(self)
            for stmt in m.body:
                scan.visit(stmt)
            self.scans[m.name] = scan
            self.method_linenos[m.name] = m.lineno
        self.ambient = self._infer_ambient()

    def _infer_ambient(self):
        """Locks held at EVERY internal call site of each private helper —
        the computed version of the tree's ``# noqa: PT100 - caller holds
        _cv`` annotations. Public methods (callable from outside the class)
        and helpers ever called lock-free get the empty set."""
        sites = defaultdict(list)
        for caller, scan in self.scans.items():
            for kind, _recv, mname, held, _lineno in scan.calls:
                if kind == 'self' and mname in self.scans:
                    sites[mname].append((caller, held))
        ambient = {mn: frozenset() for mn in self.scans}
        for _ in range(_MAX_CALL_DEPTH):
            nxt = {}
            for mn in self.scans:
                private = mn.startswith('_') and not mn.startswith('__')
                if not private or mn not in sites:
                    nxt[mn] = frozenset()
                    continue
                inter = None
                for caller, held in sites[mn]:
                    eff = held | ambient.get(caller, frozenset())
                    inter = eff if inter is None else (inter & eff)
                nxt[mn] = inter or frozenset()
            if nxt == ambient:
                break
            ambient = nxt
        return ambient

    def effective_held(self, method, held):
        return held | self.ambient.get(method, frozenset())


class RaceChecker(ProgramChecker):
    code = 'PT1300'
    codes = ('PT1300', 'PT1301', 'PT1302', 'PT1303')
    name = 'thread-races'
    description = ('whole-program lock-order cycles (PT1300), unguarded reads '
                   'of lock-guarded containers (PT1301), guarded containers '
                   'escaping their lock (PT1302), blocking calls under a lock '
                   '(PT1303)')
    scope = ('*workers/*.py', '*serve/*.py', '*elastic/*.py', '*autotune/*.py',
             '*chunkstore/*.py', '*observability/*.py', '*/torch/*.py',
             '*fabric/*.py', '*shuffling_buffer.py', '*native/lifetime.py')

    def check_program(self, sources):
        models = []
        for src in sources:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef):
                    models.append(_ClassModel(src, node))
        class_index = {}
        for m in models:
            class_index.setdefault(m.name, m)
        method_index = defaultdict(list)
        for m in models:
            for mn in m.scans:
                method_index[mn].append(m)

        for model in models:
            guarded = self._guarded_containers(model)
            yield from self._check_guarded_reads(model, guarded)
            yield from self._check_escapes(model, guarded)
            yield from self._check_blocking(model)
        yield from self._check_lock_order(models, class_index, method_index)

    # -- PT1301 / PT1302 ----------------------------------------------------

    @staticmethod
    def _guarded_containers(model):
        """attr -> set of guarding locks, for attrs mutated in place under a
        lock (outside __init__ — no second thread exists during __init__)."""
        guarded = defaultdict(set)
        for mn, scan in model.scans.items():
            if mn == '__init__':
                continue
            for attr, held, _lineno, is_mut in scan.writes:
                eff = model.effective_held(mn, held)
                if is_mut and eff:
                    guarded[attr] |= eff
        return guarded

    def _check_guarded_reads(self, model, guarded):
        for mn, scan in model.scans.items():
            if mn == '__init__':
                continue
            flagged = set()
            for attr, held, lineno in scan.reads:
                if attr not in guarded:
                    continue
                if model.effective_held(mn, held):
                    continue
                if (attr, lineno) in flagged:
                    continue
                flagged.add((attr, lineno))
                yield self.finding(
                    model.src, lineno,
                    "read of lock-guarded container 'self.{}' with no lock "
                    'held (guarded by {} in class {}) — a concurrent mutation '
                    'tears the view'.format(
                        attr,
                        ' / '.join("'self.{}'".format(a)
                                   for a in sorted(guarded[attr])),
                        model.name),
                    code='PT1301')

    def _check_escapes(self, model, guarded):
        for mn, scan in model.scans.items():
            for attr, _held, lineno, verb in scan.escapes:
                if attr not in guarded:
                    continue
                yield self.finding(
                    model.src, lineno,
                    "lock-guarded container 'self.{}' {} as a live reference "
                    '(guarded by {} in class {}) — callers touch it after the '
                    'lock is released; copy out under the lock instead'.format(
                        attr, verb,
                        ' / '.join("'self.{}'".format(a)
                                   for a in sorted(guarded[attr])),
                        model.name),
                    code='PT1302')

    # -- PT1303 -------------------------------------------------------------

    def _check_blocking(self, model):
        in_elastic = '/elastic/' in ('/' + model.src.relpath)
        for mn, scan in model.scans.items():
            for kind, desc, held, lineno in scan.blockers:
                eff = model.effective_held(mn, held)
                if kind == 'cond-wait':
                    # unbounded Condition.wait is flagged even though wait()
                    # releases its own lock: there is no bound on the stall and
                    # shutdown paths hang (tree convention: wait(timeout=...)
                    # inside a re-check loop)
                    yield self.finding(
                        model.src, lineno,
                        'unbounded {} (class {}) — wait(timeout=...) in a '
                        're-check loop is the shutdown-safe form'.format(
                            desc, model.name),
                        code='PT1303')
                    continue
                if kind == 'io' and not in_elastic:
                    continue
                if eff:
                    yield self.finding(
                        model.src, lineno,
                        '{} while holding {} (class {}) — every thread '
                        'needing the lock stalls for an unbounded time'.format(
                            desc,
                            ' / '.join("'self.{}'".format(a)
                                       for a in sorted(eff)),
                            model.name),
                        code='PT1303')

    # -- PT1300 -------------------------------------------------------------

    def _resolve_call(self, model, kind, recv, mname, class_index, method_index):
        """Possible (model, method) targets of one call site.

        Resolution order: exact (``self`` method / constructor-typed attr),
        then unique method name, then — only when the receiver's name
        correlates with the candidate class name (``self._pool`` vs
        ``ProcessPool``) — ambiguous names with a small candidate set.
        Uncorrelated ambiguous receivers resolve to nothing: inventing call
        edges (``tq.stats()`` -> every class with a ``stats``) would report
        deadlock cycles that cannot execute."""
        if kind == 'self':
            if mname in model.scans:
                return [(model, mname)]
            return []
        if kind == 'attr':
            tname = model.attr_types.get(recv)
            if tname and tname in class_index \
                    and mname in class_index[tname].scans:
                return [(class_index[tname], mname)]
        if mname in _GENERIC_METHOD_NAMES or mname.startswith('__'):
            return []
        cands = [m for m in method_index.get(mname, ())]
        if not cands or len(cands) > _MAX_NAME_CANDIDATES:
            return []
        if len(cands) == 1:
            return [(cands[0], mname)]
        tokens = [t for t in (recv or '').strip('_').lower().split('_')
                  if len(t) >= 3]
        return [(m, mname) for m in cands
                if any(t in m.name.lower() for t in tokens)]

    def _acq_summary(self, model, mname, class_index, method_index, memo,
                     stack=()):
        """{(class, lock): min call depth} of every lock the method may
        acquire, following resolved calls up to ``_MAX_CALL_DEPTH``."""
        key = (id(model), mname)
        if key in memo:
            return memo[key]
        memo[key] = {}                      # cycle guard during computation
        scan = model.scans[mname]
        out = {}
        for lock in scan.acquired:
            out[(model.name, lock)] = 1
        for kind, recv, cm, _held, _lineno in scan.calls:
            for tmodel, tmn in self._resolve_call(model, kind, recv, cm,
                                                 class_index, method_index):
                tkey = (id(tmodel), tmn)
                if tkey in stack:
                    continue
                sub = self._acq_summary(tmodel, tmn, class_index, method_index,
                                        memo, stack + (key,))
                for node, depth in sub.items():
                    if depth + 1 <= _MAX_CALL_DEPTH:
                        cur = out.get(node)
                        if cur is None or depth + 1 < cur:
                            out[node] = depth + 1
        memo[key] = out
        return out

    def _check_lock_order(self, models, class_index, method_index):
        edges = defaultdict(set)     # (cls, lock) -> {(cls, lock)}
        edge_info = {}               # (u, v) -> (src, lineno, pt101_visible)
        memo = {}
        for model in models:
            for mn, scan in model.scans.items():
                for outer, inner, lineno in scan.with_edges:
                    u, v = (model.name, outer), (model.name, inner)
                    edges[u].add(v)
                    edge_info.setdefault((u, v), (model.src, lineno, True))
                for kind, recv, cm, held, lineno in scan.calls:
                    eff = model.effective_held(mn, held)
                    if not eff:
                        continue
                    targets = self._resolve_call(model, kind, recv, cm,
                                                 class_index, method_index)
                    for tmodel, tmn in targets:
                        summary = self._acq_summary(tmodel, tmn, class_index,
                                                    method_index, memo)
                        for node, depth in summary.items():
                            for h in sorted(eff):
                                u = (model.name, h)
                                if u == node:
                                    continue
                                edges[u].add(node)
                                # PT101 sees: same class, direct self call,
                                # callee acquires the lock itself, and the
                                # outer lock is syntactically held (not
                                # ambient-inferred)
                                visible = (kind == 'self'
                                           and node[0] == model.name
                                           and depth == 1 and h in held)
                                prev = edge_info.get((u, node))
                                if prev is None or (visible and not prev[2]):
                                    edge_info[(u, node)] = (model.src, lineno,
                                                            visible)
        for cycle in _find_cycles(edges):
            cycle_classes = {cls for cls, _lock in cycle}
            cycle_edges = list(zip(cycle, cycle[1:] + (cycle[0],)))
            if len(cycle_classes) == 1 \
                    and all(edge_info[e][2] for e in cycle_edges):
                continue                      # PT101's class-local territory
            src, lineno, _vis = edge_info[cycle_edges[0]]
            names = ['{}.{}'.format(cls, lock) for cls, lock in cycle]
            names.append(names[0])
            yield self.finding(
                src, lineno,
                'cross-module lock-acquisition-order cycle {} — two threads '
                'entering from different edges deadlock (call-graph edges '
                'included; see docs/analysis.md PT1300)'.format(
                    ' -> '.join("'{}'".format(n) for n in names)),
                code='PT1300')


def _find_cycles(edges):
    """Minimal distinct cycles of a small digraph, as node tuples (rotation-
    deduplicated, deterministic order)."""
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
            elif nxt not in path and nxt > start:
                dfs(start, nxt, path + [nxt])

    for start in sorted(edges):
        dfs(start, start, [start])
    return cycles
