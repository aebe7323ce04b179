"""PT1100–PT1103 — borrow-checking the shared-memory plane.

The zero-copy read path hands consumers *borrows*: views whose bytes belong
to a producer-owned resource with its own reclamation schedule — an shm-ring
message slot (``ShmRing.try_read_zero_copy``), a COW-mapped serve/pool blob
(``_map_blob``/``_read_blob``), a chunkstore mirror (``mmap_chunk``), or a
pagescan zero-copy column view. The runtime half
(``petastorm_tpu_torch/native/lifetime.py``) accounts every borrow through a slot
registry; this module is the static half — it proves, at lint time, that no
borrow leaks past the registry:

**PT1100** a borrow is stored into longer-lived state (``self.x``, a
container cell, a module global) in a function that never touches the
lifetime registry. The store outlives the frame, so nothing ties the view's
death to the slot's refcount — the runtime cannot see the borrow and will
reclaim under it.

**PT1101** a function *returns* a borrow without a ``:borrows:`` marker in
its docstring. Returning is a legitimate hand-off, but the caller inherits
the lifetime obligation — the convention (docs/analysis.md) is that every
borrow-returning function documents it with a ``:borrows:`` docstring
section, so the obligation is visible at every call site's definition.

**PT1102** a borrow crosses a process or serialization boundary —
``pickle.dumps``, ``queue.put``, a zmq ``send*``, a ring ``try_write``/
``publish`` — without being copied (``bytes()``, ``.copy()``,
``.tobytes()``, ``bytearray()``) first. The bytes on the wire would alias
memory the producer reclaims on its own schedule; the receiver gets torn
data (or a guard fault) with no local cause.

**PT1103** a borrow's release is not dominated: the function calls a
releaser (``release``/``close``/``seal``/``release_now``/``drop``/``end``)
on the borrow, but only on *some* paths — inside a conditional, outside any
``finally``, and the borrow is not a ``with`` context. An exception (or the
untaken branch) then leaks the slot's refcount and wedges the ring's FIFO
release ledger. Same shape as PT700's span hygiene, applied to borrows.
"""

from __future__ import annotations

import ast
import re

from petastorm_tpu_torch.analysis.core import Checker, add_parents, attr_chain, walk_functions

#: call names whose result is a borrow of shared-plane memory.  NOT here:
#: ``try_read_view``/``read_view`` (fresh per-message ctypes buffer, owned by
#: the view chain) and ``scan_mirrored_chunk`` (a page *plan* — offsets, not
#: memory).
_BORROW_CALLS = {
    'try_read_zero_copy',            # ShmRing: view straight into the ring slot
    '_map_blob', '_read_blob',       # serve/pool blob COW mappings
    'mmap_chunk',                    # chunkstore mirror mapping
    'read_mirrored_chunk', 'read_columns_zerocopy',  # views over mirrors/pool
    'memmap', 'mmap',                # raw np.memmap / mmap.mmap maps
}

#: wrapper calls that preserve borrow-ness (the result still aliases the
#: same memory); everything else consuming the value as an argument derives
#: fresh data or takes over the obligation
_VIEW_WRAPPERS = {'memoryview', 'frombuffer'}

#: attribute calls on a borrow that still alias the same memory
_VIEW_METHODS = {'reshape', 'cast', 'view', 'transpose', 'swapaxes', 'squeeze',
                 'ravel'}

#: copy-laundering: these produce owned data from a borrow
_COPY_CALLS = {'bytes', 'bytearray', 'list', 'loads'}
_COPY_METHODS = {'copy', 'tobytes', 'decode'}

#: serialization/process-boundary sinks (PT1102)
_BOUNDARY_METHODS = {'dumps', 'put', 'put_nowait', 'send', 'send_multipart',
                     'send_pyobj', 'publish', 'try_write', 'reserve_write'}

#: releaser methods whose call on a borrow marks manual lifetime management
_RELEASERS = {'release', 'release_now', 'close', 'seal', 'drop', 'end',
              '__exit__'}

#: a function mentioning the lifetime-registry API is handing its borrows to
#: the runtime half — registration is the sanctioned way to store a borrow
_REGISTRY_RE = re.compile(
    r'\b(open_slot|adopt|retain|RingBorrowLedger|lifetime_registry|'
    r'lifetime\.registry|registry\(\)|close_when_drained)\b')


def _call_name(node):
    """The bare callable name of ``node`` (``np.memmap`` -> 'memmap')."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_borrow_call(node):
    return _call_name(node) in _BORROW_CALLS


def _expr_carries_borrow(expr, borrow_names):
    """True when evaluating ``expr`` yields something aliasing a borrow: a
    designated borrow call, a borrow name, or either of those passed through
    view-preserving wrappers/slices — and NOT laundered through a copy."""
    for node in ast.walk(expr):
        is_source = _is_borrow_call(node) or (
            isinstance(node, ast.Name) and node.id in borrow_names)
        if not is_source:
            continue
        if not _laundered_on_path(node, expr):
            return True
    return False


def _laundered_on_path(node, stop):
    """Climb from ``node`` to ``stop``: True when some enclosing expression
    copies the value or consumes it as an argument of a non-view call."""
    cur = node
    while cur is not stop:
        parent = getattr(cur, 'pt_parent', None)
        if parent is None:
            return False
        if isinstance(parent, ast.Attribute) and parent.attr in _COPY_METHODS:
            return True
        if isinstance(parent, ast.Compare):
            return True  # the value is a bool, not the view
        if isinstance(parent, ast.IfExp) and cur is parent.test:
            return True  # tested, not propagated
        if isinstance(parent, ast.Call) and cur is not parent.func:
            name = _call_name(parent)
            if name in _COPY_CALLS:
                return True
            if name not in _VIEW_WRAPPERS:
                return True  # consumed by some other call: obligation moves
        if isinstance(parent, ast.Call) and cur is parent.func:
            if isinstance(cur, ast.Attribute) and cur.attr in _COPY_METHODS:
                return True
            if isinstance(cur, ast.Attribute) and cur.attr not in _VIEW_METHODS:
                return True  # .sum()/.astype()/...: fresh data
        cur = parent
    return False


def _borrow_bindings(fn):
    """Names bound (directly or by tuple unpack) to a borrow-source call."""
    names = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or not _contains_borrow_call(node.value):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                names.add(target.id)
            elif isinstance(target, (ast.Tuple, ast.List)):
                # (view, slot) = _map_blob(...): conservatively treat every
                # bound name as carrying the borrow
                for elt in target.elts:
                    if isinstance(elt, ast.Name):
                        names.add(elt.id)
    return names


def _contains_borrow_call(expr):
    return any(_is_borrow_call(n) for n in ast.walk(expr))


def _conditional_ancestors(node, fn):
    """Statement-level ancestors of ``node`` below ``fn`` that make its
    execution conditional (If/While/For/Try bodies; a ``finally`` suite does
    not count — it always runs)."""
    out = []
    cur = getattr(node, 'pt_parent', None)
    child = node
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.If, ast.While, ast.For, ast.AsyncFor)):
            out.append(cur)
        elif isinstance(cur, ast.Try):
            if not any(child is s or _is_descendant(child, s)
                       for s in cur.finalbody):
                out.append(cur)
        child = cur
        cur = getattr(cur, 'pt_parent', None)
    return out


def _is_descendant(node, root):
    return any(n is node for n in ast.walk(root))


def _in_finally(node, fn):
    cur = getattr(node, 'pt_parent', None)
    child = node
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.Try) and any(
                child is s or _is_descendant(child, s) for s in cur.finalbody):
            return True
        child = cur
        cur = getattr(cur, 'pt_parent', None)
    return False


def _used_as_context(fn, name):
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return True
    return False


class LifetimeChecker(Checker):
    code = 'PT1100'
    codes = ('PT1100', 'PT1101', 'PT1102', 'PT1103')
    name = 'shared-plane-borrow-check'
    description = ('borrows of shared-plane memory (ring slots, blob maps, '
                   'chunk mirrors) stored unregistered, returned undeclared, '
                   'serialized across a boundary, or released only on some '
                   'paths')
    scope = ('*native/*.py', '*workers/*.py', '*serve/*.py',
             '*chunkstore/*.py', '*/torch/*.py', '*serializers.py')

    def check(self, src):
        if not src.is_python:
            return
        add_parents(src.tree)
        seen = set()  # a closure's body is walked under its enclosing
        for fn, _cls in walk_functions(src.tree):  # function too: dedupe
            for f in self._check_function(src, fn):
                if (f.line, f.code) not in seen:
                    seen.add((f.line, f.code))
                    yield f

    def _check_function(self, src, fn):
        borrow_names = _borrow_bindings(fn)
        has_direct = any(_is_borrow_call(n) for n in ast.walk(fn))
        if not borrow_names and not has_direct:
            return
        seg = ast.get_source_segment(src.text, fn) or ''
        registers = bool(_REGISTRY_RE.search(seg))
        yield from self._check_stores(src, fn, borrow_names, registers)
        yield from self._check_returns(src, fn, borrow_names)
        yield from self._check_boundaries(src, fn, borrow_names)
        if not registers:
            # a function handing its borrows to the lifetime registry has
            # delegated release to the runtime half — the registry's
            # finalizers dominate every exit, so path analysis is moot
            yield from self._check_release_domination(src, fn, borrow_names)

    # -- PT1100: stored into longer-lived state without registration --------

    def _check_stores(self, src, fn, borrow_names, registers):
        if registers:
            return
        global_names = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                global_names.update(node.names)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not _expr_carries_borrow(node.value, borrow_names):
                continue
            for target in node.targets:
                escapes = (isinstance(target, (ast.Attribute, ast.Subscript))
                           or (isinstance(target, ast.Name)
                               and target.id in global_names))
                if escapes:
                    yield self.finding(
                        src, node.lineno,
                        'borrow of shared-plane memory stored into longer-lived '
                        'state in {}() without registering with the lifetime '
                        'registry (native/lifetime.py) — the runtime cannot see '
                        'this reference and will reclaim the bytes under it'
                        .format(fn.name))
                    break

    # -- PT1101: returned without a :borrows: docstring marker --------------

    def _check_returns(self, src, fn, borrow_names):
        doc = ast.get_docstring(fn) or ''
        if ':borrows:' in doc:
            return
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Return, ast.Yield)) or node.value is None:
                continue
            if _expr_carries_borrow(node.value, borrow_names):
                yield self.finding(
                    src, node.lineno,
                    '{}() returns a borrow of shared-plane memory without a '
                    '":borrows:" docstring section — the caller inherits the '
                    'lifetime obligation and must be able to see it '
                    '(docs/analysis.md)'.format(fn.name),
                    code='PT1101')
                return

    # -- PT1102: crosses a process/serialization boundary -------------------

    def _check_boundaries(self, src, fn, borrow_names):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name not in _BOUNDARY_METHODS:
                continue
            if name == 'dumps':
                chain = attr_chain(node.func) or ''
                if not chain.startswith('pickle'):
                    continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                carries = any(
                    (isinstance(n, ast.Name) and n.id in borrow_names
                     and not _laundered_on_path(n, arg))
                    or (_is_borrow_call(n) and not _laundered_on_path(n, arg))
                    for n in ast.walk(arg))
                if carries:
                    yield self.finding(
                        src, node.lineno,
                        'borrow of shared-plane memory crosses a process/'
                        'serialization boundary via {}() in {}() — the wire '
                        'bytes alias producer-owned memory; copy first '
                        '(bytes()/.tobytes()/.copy())'.format(name, fn.name),
                        code='PT1102')
                    break

    # -- PT1103: release not dominated on all paths -------------------------

    def _check_release_domination(self, src, fn, borrow_names):
        for bname in sorted(borrow_names):
            if _used_as_context(fn, bname):
                continue
            releasers = [
                node for node in ast.walk(fn)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RELEASERS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == bname]
            if not releasers:
                continue  # lifetime handed off (registry/ledger), not manual
            if any(_in_finally(node, fn) for node in releasers):
                continue
            if any(not _conditional_ancestors(node, fn) for node in releasers):
                continue  # a straight-line release dominates the exits
            yield self.finding(
                src, releasers[0].lineno,
                "borrow '{}' in {}() is released only on some paths (every "
                'releaser call sits inside a conditional, none in a finally) '
                '— the untaken branch or an exception leaks the slot refcount '
                'and wedges the FIFO release ledger'.format(bname, fn.name),
                code='PT1103')
