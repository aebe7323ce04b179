"""PT500/PT501/PT502 — safety of zero-copy views at the native boundary.

**PT500** ``np.frombuffer``/``memoryview`` results are views over transport
or file memory: over a zmq ``bytes`` they are read-only (an in-place image op
or ``torch.from_numpy`` then fails — or worse, behaves transport-dependently),
over a shared ring they alias memory with its own lifetime. A view that
*escapes* a function (returned, yielded, or stored into a container cell)
must either be ``.copy()``-ed or the function must gate on writability
(``.flags.writeable`` / ``memoryview.readonly``) — otherwise downstream
behavior depends on which transport the payload happened to ride (the
round-5 serializer defect class).

**PT501** A zero-copy Arrow view over an mmap'd Parquet page
(``pa.py_buffer(memoryview(mm)[off:off + n])``) trusts ``n`` — which derives
from footer metadata a third-party writer produced. Bounds-checking ``n``
against the *whole file* only means a wrong ``null_count``/short page silently
serves the next page's header bytes as tensor data. The function building such
views must compare the view length against a per-page bound (any comparison of
the length name with something other than the mmap's ``.size``) — the round-5
pagescan defect class.

**PT502** (C++ sources) Parsers at the native boundary consume untrusted
bytes; a recursive descent with no depth bound turns a corrupt/crafted
deeply-nested input into C++ stack exhaustion — a process crash no Python
``except`` can catch (the round-5 thrift ``skip_value`` defect class). Every
function participating in a recursion cycle in ``native/*.cpp`` must mention
a ``depth`` limit.

**PT503** The fused batch-buffer ABI (``native/fused.py`` ↔
``pstpu_read_fused``) carries raw pointers with explicit byte capacities.
Two invariants keep it memory-safe from the Python side:

* *lifetime anchored* — a raw address (``X.ctypes.data``) taken from a
  TEMPORARY expression (``np.empty(n).ctypes.data``) dies before or at the
  foreign call; the owning buffer must be bound to a name that outlives the
  call;
* *bounds arguments present* — a function that stores a descriptor pointer
  field (``.out`` / ``.chunk`` / ``.aux_buf``) must store its matching
  capacity field (``.out_cap`` / ``.chunk_len`` / ``.aux_cap``) in the same
  function, so the kernel always receives the bound it checks against.
"""

from __future__ import annotations

import ast
import re

from petastorm_tpu_torch.analysis.core import Checker, add_parents, attr_chain, walk_functions

_VIEW_CALLS = {'frombuffer', 'memoryview'}
_GUARD_TOKENS = ('writeable', 'readonly')

#: methods whose result is still (possibly) a read-only view over the same
#: memory; anything else (.sum(), .astype(), .tolist(), ...) derives fresh data
_VIEW_METHODS = {'reshape', 'cast', 'view', 'transpose', 'swapaxes', 'squeeze',
                 'ravel'}


def _is_view_call(node):
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in _VIEW_CALLS
    if isinstance(func, ast.Attribute):
        return func.attr in _VIEW_CALLS
    return False


def _chained_copy(node):
    """True when the view is immediately copied: np.frombuffer(...).copy()
    possibly through reshape/cast links."""
    cur = getattr(node, 'pt_parent', None)
    while isinstance(cur, (ast.Attribute, ast.Call)):
        if isinstance(cur, ast.Attribute) and cur.attr in ('copy', 'tobytes'):
            return True
        cur = getattr(cur, 'pt_parent', None)
    return False


def _function_has_guard(fn, src):
    """A writability gate anywhere in the function counts: the function is
    the review unit, and a guard like ``v if v.flags.writeable else v.copy()``
    covers sibling view expressions."""
    seg = ast.get_source_segment(src.text, fn) or ''
    return any(tok in seg for tok in _GUARD_TOKENS)


def _escape_kind(node, fn):
    """'returned' / 'stored' when the view expression escapes ``fn``."""
    view_names = set()
    cur, parent = node, getattr(node, 'pt_parent', None)
    # walk through wrapper chains (reshape/cast/slicing keep it a view); stop
    # when the view becomes an ARGUMENT of another call or the receiver of a
    # data-deriving method (consumed, not escaping)
    while True:
        if isinstance(parent, ast.Attribute):
            cur, parent = parent, getattr(parent, 'pt_parent', None)
        elif isinstance(parent, ast.Subscript) and parent.value is cur:
            cur, parent = parent, getattr(parent, 'pt_parent', None)
        elif isinstance(parent, ast.Call) and parent.func is cur:
            if isinstance(cur, ast.Attribute) and cur.attr not in _VIEW_METHODS:
                return None  # .sum()/.astype()/...: result is fresh data
            cur, parent = parent, getattr(parent, 'pt_parent', None)
        else:
            break
    if isinstance(parent, (ast.Return, ast.Yield)):
        return 'returned'
    if isinstance(parent, ast.Assign):
        if any(isinstance(t, ast.Subscript) for t in parent.targets):
            return 'stored'
        view_names = {t.id for t in parent.targets if isinstance(t, ast.Name)}
    if not view_names:
        return None
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.Return, ast.Yield)) and sub.value is not None:
            if _name_escapes_expr(sub.value, view_names):
                return 'returned'
        elif isinstance(sub, ast.Assign):
            stores_out = any(isinstance(t, ast.Subscript) for t in sub.targets)
            if stores_out and _name_escapes_expr(sub.value, view_names):
                return 'stored'
    return None


def _name_escapes_expr(expr, view_names):
    """A view name escapes through ``expr`` only when it is NOT consumed as an
    argument of some call on the way up (``pickle.loads(mv[1:])`` consumes the
    view; ``mv[1:]`` re-exports it)."""
    for n in ast.walk(expr):
        if not (isinstance(n, ast.Name) and n.id in view_names):
            continue
        cur = n
        consumed = False
        while cur is not expr and not consumed:
            parent = getattr(cur, 'pt_parent', None)
            if parent is None:
                break
            if isinstance(parent, ast.Call):
                if cur is not parent.func:
                    consumed = True  # argument of some call
                elif isinstance(cur, ast.Attribute) and cur.attr not in _VIEW_METHODS:
                    consumed = True  # .sum()/.astype()/...: fresh data
            cur = parent
        if not consumed:
            return True
    return False


class NativeBufferChecker(Checker):
    code = 'PT500'
    codes = ('PT500', 'PT501', 'PT502', 'PT503')
    name = 'native-buffer-safety'
    description = ('frombuffer/memoryview escaping without copy or writability '
                   'check; unbounded page views (PT501); unbounded native '
                   'recursion (PT502)')
    scope = ('*serializers.py', '*native/*.py', '*native/*.cpp', '*native/*.cc')

    def check(self, src):
        if src.is_python:
            add_parents(src.tree)
            yield from self._check_views(src)
            yield from self._check_page_bounds(src)
            yield from self._check_fused_abi(src)
        else:
            yield from self._check_cpp_recursion(src)

    # -- PT500 ---------------------------------------------------------------

    def _check_views(self, src):
        for fn, _cls in walk_functions(src.tree):
            has_guard = _function_has_guard(fn, src)
            for node in ast.walk(fn):
                if not _is_view_call(node) or _chained_copy(node):
                    continue
                kind = _escape_kind(node, fn)
                if kind is None or has_guard:
                    continue
                yield self.finding(
                    src, node.lineno,
                    'buffer view {} from {}() without .copy() or a writability '
                    'check — writability (and lifetime) depends on the transport '
                    'the bytes rode'.format(kind, fn.name))

    # -- PT501 ---------------------------------------------------------------

    def _check_page_bounds(self, src):
        for fn, _cls in walk_functions(src.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = attr_chain(node.func) or ''
                if chain.rsplit('.', 1)[-1] != 'py_buffer' or not node.args:
                    continue
                length_names = self._slice_length_names(node.args[0])
                if not length_names:
                    continue
                if not self._has_page_bound_compare(fn, length_names):
                    yield self.finding(
                        src, node.lineno,
                        'zero-copy page view built in {}() with no per-page bound '
                        'check on {} — a wrong null_count/short page serves '
                        "the next page's bytes as tensor data".format(
                            fn.name, ' / '.join(sorted(length_names))),
                        code='PT501')

    @staticmethod
    def _slice_length_names(arg):
        """Names participating in the slice bounds of ``memoryview(mm)[a:b]``
        (and plain ``mm[a:b]``) — the values a bound check must constrain."""
        names = set()
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Subscript) and isinstance(sub.slice, ast.Slice):
                for bound in (sub.slice.lower, sub.slice.upper):
                    if bound is None:
                        continue
                    for n in ast.walk(bound):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
        return names

    @staticmethod
    def _has_page_bound_compare(fn, length_names):
        """A comparison involving a slice-length name where the other side is
        NOT a whole-file ``.size``/``len()`` — i.e. an actual per-page bound."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            involves = any(isinstance(n, ast.Name) and n.id in length_names
                           for op in operands for n in ast.walk(op))
            if not involves:
                continue
            for op in operands:
                chain = attr_chain(op)
                if chain is not None and chain.endswith('.size'):
                    continue  # whole-file bound: not sufficient
                if any(isinstance(n, ast.Name) and n.id in length_names
                       for n in ast.walk(op)):
                    continue  # the length side itself
                return True
        return False

    # -- PT503 ---------------------------------------------------------------

    #: descriptor pointer field -> the capacity field the kernel bounds it by
    _PTR_BOUND_FIELDS = {'out': 'out_cap', 'chunk': 'chunk_len',
                         'aux_buf': 'aux_cap'}

    def _check_fused_abi(self, src):
        for fn, _cls in walk_functions(src.tree):
            assigned = set()
            for node in ast.walk(fn):
                # lifetime: <temporary>.ctypes.data — the array dies at the
                # end of the expression, before the kernel dereferences it
                if isinstance(node, ast.Attribute) and node.attr in ('data', 'data_as'):
                    inner = node.value
                    if isinstance(inner, ast.Attribute) and inner.attr == 'ctypes' \
                            and isinstance(inner.value, ast.Call):
                        yield self.finding(
                            src, node.lineno,
                            'raw pointer taken from a temporary expression in {}() '
                            '— bind the buffer to a name that outlives the native '
                            'call (the temporary is freed before the kernel '
                            'dereferences it)'.format(fn.name),
                            code='PT503')
                if isinstance(node, ast.Assign):
                    assigned.update(t.attr for t in node.targets
                                    if isinstance(t, ast.Attribute))
            for ptr, bound in self._PTR_BOUND_FIELDS.items():
                if ptr in assigned and bound not in assigned:
                    yield self.finding(
                        src, fn.lineno,
                        'fused-ABI descriptor pointer .{} is set in {}() without '
                        'its capacity field .{} — the kernel bounds every write '
                        'by that capacity, so a descriptor without it is an '
                        'unbounded native write'.format(ptr, fn.name, bound),
                        code='PT503')

    # -- PT502 ---------------------------------------------------------------

    #: a (loose) C++ function definition: identifier immediately before '(',
    #: with the body brace on the same or a following line
    _CPP_DEF_RE = re.compile(
        r'^[ \t]*(?:[A-Za-z_][\w:<>,*&\s]*?[\s*&])?'
        r'(?:[A-Za-z_][\w]*::)?(?P<name>~?[A-Za-z_]\w*)\s*\([^;{}]*\)'
        r'(?:\s*const)?(?:\s*noexcept)?\s*\{', re.MULTILINE)

    _CPP_KEYWORDS = {'if', 'for', 'while', 'switch', 'return', 'catch', 'sizeof',
                     'defined'}

    def _check_cpp_recursion(self, src):
        text = _strip_cpp_comments_and_strings(src.text)
        bodies = {}   # name -> (lineno, body text incl. signature)
        for m in self._CPP_DEF_RE.finditer(text):
            name = m.group('name')
            if name in self._CPP_KEYWORDS:
                continue
            open_brace = text.index('{', m.end() - 1)
            end = _match_brace(text, open_brace)
            if end is None:
                continue
            lineno = text.count('\n', 0, m.start()) + 1
            # keep the first definition; overloads share the identifier and
            # the depth requirement applies to the cycle either way
            bodies.setdefault(name, (lineno, text[m.start():end + 1]))
        calls = {}
        for name, (_lineno, body) in bodies.items():
            inner = body[body.index('{'):]  # calls in the BODY, not the signature
            calls[name] = {callee for callee in bodies
                           if re.search(r'\b{}\s*\('.format(re.escape(callee)), inner)}
        for name in sorted(bodies):
            if not _in_cycle(name, calls):
                continue
            lineno, body = bodies[name]
            if re.search(r'\bdepth\b', body, re.IGNORECASE):
                continue
            yield self.finding(
                src, lineno,
                'recursive native function {}() has no depth bound — corrupt '
                'deeply-nested input overflows the C++ stack and kills the '
                'process (no Python except can catch it)'.format(name),
                code='PT502')


def _strip_cpp_comments_and_strings(text):
    """Blank out // and /* */ comments and string/char literals, preserving
    line structure so reported linenos stay correct."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '/' and i + 1 < n and text[i + 1] == '/':
            j = text.find('\n', i)
            j = n if j == -1 else j
            out.append(' ' * (j - i))
            i = j
        elif c == '/' and i + 1 < n and text[i + 1] == '*':
            j = text.find('*/', i + 2)
            j = n if j == -1 else j + 2
            out.append(''.join('\n' if ch == '\n' else ' ' for ch in text[i:j]))
            i = j
        elif c in '"\'':
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == '\\' else 1
            j = min(j + 1, n)
            out.append(c + ' ' * (j - i - 2 if j - i >= 2 else 0) + (c if j - i >= 2 else ''))
            i = j
        else:
            out.append(c)
            i += 1
    return ''.join(out)


def _match_brace(text, open_idx):
    depth = 0
    for i in range(open_idx, len(text)):
        if text[i] == '{':
            depth += 1
        elif text[i] == '}':
            depth -= 1
            if depth == 0:
                return i
    return None


def _in_cycle(start, calls):
    """Is ``start`` on a call cycle (including self-recursion)?"""
    stack = [c for c in calls.get(start, ())]
    seen = set()
    while stack:
        cur = stack.pop()
        if cur == start:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(calls.get(cur, ()))
    return False
