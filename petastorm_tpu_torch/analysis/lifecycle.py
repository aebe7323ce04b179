"""PT200/PT201 — resource lifecycle.

**PT200** Types exposing ``stop``/``join``/``close``/``shutdown`` (the
Reader, the pools, the shm ring, pagescan mmaps) own OS resources — threads,
spawned processes, shared-memory segments, file descriptors. Constructing one
at a call site and letting it fall out of scope leaves cleanup to the GC (or
to nothing at all: daemon threads and /dev/shm segments survive their Python
wrapper). A construction is *orphaned* when the result is not entered with
``with``, closed in the enclosing function, assigned to an attribute/
container, returned/yielded, or handed to another call that takes ownership.

**PT201** Cleanup reachable only through ``__del__`` is cleanup scheduled by
the GC: under CPython reference cycles or interpreter teardown it runs late,
never, or against half-torn module globals. A class defining ``__del__``
must also expose a deterministic release path (``close``/``stop``/``join``/
``shutdown``/``__exit__``), with ``__del__`` as the last-resort backstop only.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, add_parents, walk_functions

_RELEASE_METHODS = {'close', 'stop', 'join', 'shutdown', 'release', 'terminate',
                    '__exit__'}

#: resource types outside the scanned file set that call sites still construct
_KNOWN_RESOURCE_CLASSES = {'Reader', 'ThreadPool', 'ProcessPool', 'DummyPool',
                           'ShmRing', 'NativeParquetFile', 'TorchDataLoader'}


def _collect_resource_classes(src):
    """Class names in this module whose instances need explicit release:
    they define a release method (or __enter__/__exit__). Purely-protocol
    bases (all release methods empty/abstract) still count — the point is the
    call-site contract, not the body."""
    classes = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        defined = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if defined & _RELEASE_METHODS:
            classes.add(node.name)
    return classes


def _constructed_class(call, resource_classes):
    """Class name when ``call`` constructs a resource: ``Cls(...)`` or the
    ``Cls.create(...)``/``Cls.attach(...)``/``Cls.open(...)`` factory idiom."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in resource_classes:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in ('create', 'attach', 'open') \
            and isinstance(func.value, ast.Name) and func.value.id in resource_classes:
        return func.value.id
    return None


def _enclosing_function(node):
    cur = getattr(node, 'pt_parent', None)
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        cur = getattr(cur, 'pt_parent', None)
    return cur


def _under_with_or_try(node, stop_at):
    """True when ``node`` sits inside a ``with`` item, a ``with`` body, or a
    ``try`` that has a ``finally`` — before reaching ``stop_at``."""
    cur = node
    while cur is not None and cur is not stop_at:
        parent = getattr(cur, 'pt_parent', None)
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            return True
        if isinstance(parent, ast.Try) and parent.finalbody:
            return True
        cur = parent
    return False


def _name_released_or_escapes(func, name):
    """Within ``func``: does ``name`` get released, escape, or change owner?
    Escapes: returned/yielded, stored into an attribute/container, passed as a
    call argument, or re-raised into a with/try-finally via ``with name``."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == name and f.attr in _RELEASE_METHODS:
                return True
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == name:
                    return True
                if isinstance(arg, ast.Starred) and isinstance(arg.value, ast.Name) \
                        and arg.value.id == name:
                    return True
        elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)) \
                and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id == name:
                    return True
        elif isinstance(node, ast.Assign):
            uses_name = any(isinstance(s, ast.Name) and s.id == name
                            for s in ast.walk(node.value))
            stores_out = any(isinstance(t, (ast.Attribute, ast.Subscript))
                             for t in node.targets)
            if uses_name and stores_out:
                return True
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return True
    return False


class ResourceLifecycleChecker(Checker):
    code = 'PT200'
    codes = ('PT200', 'PT201')
    name = 'resource-lifecycle'
    description = ('resource types constructed without with/try-finally or a '
                   'release path; __del__-only cleanup (PT201)')
    scope = ('*.py',)

    def check(self, src):
        add_parents(src.tree)
        resource_classes = _collect_resource_classes(src) | _KNOWN_RESOURCE_CLASSES
        yield from self._check_del_only(src)
        yield from self._check_orphans(src, resource_classes)

    def _check_del_only(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            defined = {n.name for n in node.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            if '__del__' in defined and not (defined & _RELEASE_METHODS):
                yield self.finding(
                    src, node.lineno,
                    "class {} cleans up only in __del__ — add a deterministic "
                    'close()/stop() (GC may run it late, never, or at interpreter '
                    'teardown)'.format(node.name),
                    code='PT201')

    def _check_orphans(self, src, resource_classes):
        for func, cls in walk_functions(src.tree):
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                cls_name = _constructed_class(node, resource_classes)
                if cls_name is None:
                    continue
                if _enclosing_function(node) is not func:
                    continue  # belongs to a nested def: reported for that def
                parent = getattr(node, 'pt_parent', None)
                # `with Cls(...)` / `return Cls(...)` / `yield Cls(...)` /
                # `f(Cls(...))` / `x.append(Cls(...))` / self.attr = Cls(...):
                # ownership moves or release is structural
                if isinstance(parent, (ast.withitem, ast.Return, ast.Yield,
                                       ast.YieldFrom, ast.Call, ast.Starred)):
                    continue
                if isinstance(parent, ast.Assign):
                    targets = parent.targets
                    if any(isinstance(t, (ast.Attribute, ast.Subscript)) for t in targets):
                        continue  # owner object/container manages it
                    names = [t.id for t in targets if isinstance(t, ast.Name)]
                    if names and all(_name_released_or_escapes(func, n) for n in names):
                        continue
                    if _under_with_or_try(node, func):
                        continue
                    yield self.finding(
                        src, node.lineno,
                        '{} constructed but never released in {}(): call .close()/'
                        '.stop()+.join(), use "with", or hand it to an owner'.format(
                            cls_name, func.name))
                elif isinstance(parent, ast.Expr):
                    # bare `Cls(...)` statement: constructed and dropped
                    yield self.finding(
                        src, node.lineno,
                        '{} constructed and immediately discarded in {}() — its '
                        'threads/processes/fds leak until GC'.format(cls_name, func.name))
