"""PT900/PT901/PT902 — cross-language ABI conformance at the native boundary.

The fastest paths in the framework are the ones the type system cannot see:
``pstpu_read_fused`` and the shm-ring in-place mode are C structs and
``extern "C"`` signatures in ``native/*.cpp`` mirrored *by hand* as ctypes
layouts and ``argtypes``/``restype`` declarations in ``native/*.py``. Both
memory-safety bugs shipped since the fused kernel landed (the
multiplication-overflow bounds checks, the ``aux_bufs`` index misalignment)
were exactly this class of silent cross-language drift, caught by review
rather than tooling. This checker makes the drift mechanical:

**PT900 — struct-layout drift.** Every ``ctypes.Structure`` whose docstring
declares it a "mirror of ``struct X``" is checked field-for-field
against ``struct X`` parsed out of the sibling ``native/*.cpp`` sources:
the C field offsets and sizes are computed under C layout rules (natural
alignment, padding) and must be identical — same names, same order, same
offset, same size, same kind (pointer / signed / unsigned / float / bytes).
A reordered field, a widened type, or a field added on one side only is a
finding. The ``pstpu_abi_version()`` C literal must equal the Python
``EXPECTED_ABI`` literal (the version gate is itself checked, not trusted).

**PT901 — function-signature drift.** Every ``lib.NAME.argtypes = [...]`` /
``lib.NAME.restype = ...`` declaration is checked against the ``extern "C"``
definition of ``NAME``: argument count must match, each C scalar must map to
a ctypes type of the same size and signedness class, each C pointer must map
to a pointer ctype (``c_void_p``/``c_char_p``/``POINTER(...)``) — and a
pointer to a mirrored struct must map to ``POINTER(<its mirror>)`` or
``c_void_p``. A non-``int`` return type must have an explicit compatible
``restype`` (ctypes' silent default truncates a 64-bit return to 32 bits).

**PT902 — pointer parameter without a traveling capacity bound.** Every
``extern "C"`` function taking a buffer pointer must also take a
capacity/length parameter (the generalization of PT503 from fused
descriptors to the whole call surface): the kernel can only bounds-check
what the caller hands it. NUL-terminated ``const char*`` strings and opaque
``void*`` handles (named ``h``/``*handle``) are exempt.

Suppress a single finding with ``# noqa: PT90x - <reason>`` (Python) or
``// noqa: PT90x - <reason>`` (C++) on its line. See ``docs/analysis.md`` — "the ABI is
checked, not trusted".
"""

from __future__ import annotations

import ast
import glob
import os
import re

from petastorm_tpu_torch.analysis.buffers import _strip_cpp_comments_and_strings
from petastorm_tpu_torch.analysis.core import Checker, attr_chain

#: docstring marker binding a ctypes.Structure to the C struct it mirrors
_MIRROR_RE = re.compile(r'mirror of\s+`*struct\s+(\w+)`*')

#: the C ABI version literal (rowgroup_reader.cpp)
_ABI_VERSION_RE = re.compile(
    r'\bpstpu_abi_version\s*\(\s*(?:void)?\s*\)\s*\{\s*return\s+(\d+)\s*;')

# -- C type model -----------------------------------------------------------

#: C scalar type -> (size, kind); kind in int/uint/float (LP64 Linux targets,
#: the only ABI the native kernels build for)
_C_SCALARS = {
    'bool': (1, 'uint'), 'char': (1, 'bytes'), 'signed char': (1, 'int'),
    'unsigned char': (1, 'uint'), 'int8_t': (1, 'int'), 'uint8_t': (1, 'uint'),
    'short': (2, 'int'), 'unsigned short': (2, 'uint'),
    'int16_t': (2, 'int'), 'uint16_t': (2, 'uint'),
    'int': (4, 'int'), 'unsigned': (4, 'uint'), 'unsigned int': (4, 'uint'),
    'int32_t': (4, 'int'), 'uint32_t': (4, 'uint'), 'float': (4, 'float'),
    'long': (8, 'int'), 'unsigned long': (8, 'uint'),
    'long long': (8, 'int'), 'unsigned long long': (8, 'uint'),
    'int64_t': (8, 'int'), 'uint64_t': (8, 'uint'), 'size_t': (8, 'uint'),
    'ssize_t': (8, 'int'), 'off_t': (8, 'int'), 'double': (8, 'float'),
    'png_size_t': (8, 'uint'),
}

_POINTER_SIZE = 8


class CField(object):
    """One parsed C struct field."""

    __slots__ = ('name', 'ctype', 'count', 'offset', 'size', 'kind')

    def __init__(self, name, ctype, count):
        self.name = name
        self.ctype = ctype
        self.count = count  # None for scalars, int for arrays
        self.offset = self.size = 0
        self.kind = 'int'


class CFunc(object):
    """One parsed ``extern "C"`` function definition."""

    __slots__ = ('name', 'ret', 'params', 'lineno')

    def __init__(self, name, ret, params, lineno):
        self.name = name
        self.ret = ret          # normalized C type string
        self.params = params    # [(normalized type, name)]
        self.lineno = lineno


def _normalize_ctype(raw):
    """Canonical C type string: const/struct/volatile stripped, ``std::atomic<T>``
    unwrapped, pointer stars separated (``'uint8_t *'``/``'void * *'``)."""
    t = raw.strip()
    t = re.sub(r'\bstd::atomic\s*<\s*([^>]+?)\s*>', r'\1', t)
    t = re.sub(r'\b(const|volatile|struct|restrict)\b', ' ', t)
    stars = t.count('*')
    t = t.replace('*', ' ')
    t = ' '.join(t.split())
    return t + ' *' * stars


def _is_pointer(ctype):
    return ctype.endswith('*')


def _scalar_info(ctype):
    """(size, kind) of a normalized scalar C type, or None when unknown."""
    return _C_SCALARS.get(ctype)


def _eval_array_count(expr):
    """Evaluate a constant array-size expression (digits, + - * / ( ), and
    ``sizeof(type)``); None when it isn't that simple."""
    def sizeof_sub(m):
        info = _scalar_info(_normalize_ctype(m.group(1)))
        if info is None:
            return 'X'  # poison: unknown type makes the eval fail below
        return str(info[0])

    expr = re.sub(r'sizeof\s*\(\s*([^)]+?)\s*\)', sizeof_sub, expr)
    if not re.fullmatch(r'[0-9+\-*/() ]+', expr):
        return None
    try:
        value = eval(expr, {'__builtins__': {}})  # noqa: S307 - digits/ops only, checked above
    except Exception:  # noqa: BLE001 - malformed constant: caller skips the struct
        return None
    return int(value) if isinstance(value, (int, float)) and value == int(value) else None


_FIELD_RE = re.compile(
    r'^(?P<type>[\w:<>\s]+?(?:\s*\*+)?)\s*(?P<name>\w+)\s*'
    r'(?:\[(?P<count>[^\]]+)\])?$')


def parse_cpp_structs(text):
    """``{name: [CField]}`` for every ``struct NAME { ... };`` whose body
    parses as plain data fields; structs with methods/initializers simply
    yield the fields that do parse (a mirror check against one fails loudly
    on the count mismatch, never silently passes)."""
    structs = {}
    for m in re.finditer(r'\bstruct\s+(\w+)\s*\{', text):
        name = m.group(1)
        open_idx = text.index('{', m.end() - 1)
        end = _match_brace(text, open_idx)
        if end is None:
            continue
        body = text[open_idx + 1:end]
        fields = []
        for decl in body.split(';'):
            decl = ' '.join(decl.split())
            # parens inside [..] are array-size arithmetic (sizeof), not a
            # method signature — judge "is this a method?" outside brackets
            outside = re.sub(r'\[[^\]]*\]', '[]', decl)
            if not decl or '(' in outside or '{' in decl or '}' in decl:
                continue  # methods, nested types, default-init expressions
            decl = decl.split('=')[0].strip()  # strip default member init
            declarators = [p.strip() for p in decl.split(',')]
            fm = _FIELD_RE.match(declarators[0])
            if not fm:
                continue
            ctype = _normalize_ctype(fm.group('type'))
            entries = [(fm.group('name'), fm.group('count'))]
            for extra in declarators[1:]:
                # C attaches '*'/[n] to the declarator, not the type — plain
                # additional names share the base type, anything fancier bails
                em = re.match(r'^(?P<name>\w+)\s*(?:\[(?P<count>[^\]]+)\])?$',
                              extra)
                if not em:
                    entries = None
                    break
                entries.append((em.group('name'), em.group('count')))
            if entries is None:
                continue
            for fname, raw_count in entries:
                count = None
                if raw_count is not None:
                    count = _eval_array_count(raw_count)
                    if count is None:
                        break
                fields.append(CField(fname, ctype, count))
        structs[name] = fields
    return structs


def layout_struct(fields):
    """Assign offset/size/kind to ``fields`` under C layout rules (natural
    alignment, tail padding). Returns total struct size, or None when a field
    type is unknown."""
    offset = 0
    max_align = 1
    for f in fields:
        if _is_pointer(f.ctype):
            size, kind = _POINTER_SIZE, 'ptr'
        else:
            info = _scalar_info(f.ctype)
            if info is None:
                return None
            size, kind = info
        align = min(size, 8)
        if f.count is not None:
            size *= f.count
            if kind != 'ptr':
                kind = 'bytes' if f.ctype == 'char' else kind
        offset = (offset + align - 1) // align * align
        f.offset, f.size, f.kind = offset, size, kind
        offset += size
        max_align = max(max_align, align)
    return (offset + max_align - 1) // max_align * max_align


#: string literals arrive blanked by the comment/string stripper, so the
#: ``"C"`` may appear as ``" "`` — match any (stripped) literal after extern
_EXTERN_C_RE = re.compile(r'extern\s+"[^"\n]*"\s*\{')

_FUNC_RE = re.compile(
    r'(?P<ret>[\w:<>]+(?:\s+[\w:<>]+)*(?:\s*\*+)?)\s+'
    r'(?P<name>\w+)\s*\((?P<params>[^)]*)\)\s*\{', re.S)


def parse_extern_c_functions(text):
    """``{name: CFunc}`` for every function defined inside an
    ``extern "C" { ... }`` block."""
    funcs = {}
    for m in _EXTERN_C_RE.finditer(text):
        open_idx = text.index('{', m.end() - 1)
        end = _match_brace(text, open_idx)
        if end is None:
            continue
        block = text[open_idx + 1:end]
        base_line = text.count('\n', 0, open_idx) + 1
        for fm in _FUNC_RE.finditer(block):
            raw_ret = fm.group('ret')
            if re.search(r'\b(static|inline)\b', raw_ret):
                continue  # internal linkage / helpers: not part of the C ABI
            ret = _normalize_ctype(raw_ret)
            if ret.split(' ')[0] in ('if', 'for', 'while', 'switch', 'return',
                                     'else', 'do') \
                    or fm.group('name') in ('if', 'for', 'while', 'switch'):
                continue
            params = []
            raw = ' '.join(fm.group('params').split())
            if raw and raw != 'void':
                ok = True
                for p in raw.split(','):
                    p = p.strip()
                    pm = re.match(r'^(?P<type>.+?)\s*(?P<name>\w+)$', p)
                    if not pm or not re.search(r'[\w>*]\s*$', pm.group('type')):
                        ok = False
                        break
                    params.append((_normalize_ctype(pm.group('type')),
                                   pm.group('name')))
                if not ok:
                    continue
            lineno = base_line + block.count('\n', 0, fm.start())
            funcs[fm.group('name')] = CFunc(fm.group('name'), ret, params, lineno)
    return funcs


def parse_abi_version(text):
    m = _ABI_VERSION_RE.search(text)
    return int(m.group(1)) if m else None


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


# -- ctypes-side model ------------------------------------------------------

#: ctypes scalar name -> (size, kind)
_CTYPES_SCALARS = {
    'c_bool': (1, 'uint'), 'c_char': (1, 'bytes'), 'c_byte': (1, 'int'),
    'c_ubyte': (1, 'uint'), 'c_int8': (1, 'int'), 'c_uint8': (1, 'uint'),
    'c_short': (2, 'int'), 'c_ushort': (2, 'uint'),
    'c_int16': (2, 'int'), 'c_uint16': (2, 'uint'),
    'c_int': (4, 'int'), 'c_uint': (4, 'uint'),
    'c_int32': (4, 'int'), 'c_uint32': (4, 'uint'), 'c_float': (4, 'float'),
    'c_long': (8, 'int'), 'c_ulong': (8, 'uint'),
    'c_longlong': (8, 'int'), 'c_ulonglong': (8, 'uint'),
    'c_int64': (8, 'int'), 'c_uint64': (8, 'uint'),
    'c_size_t': (8, 'uint'), 'c_ssize_t': (8, 'int'), 'c_double': (8, 'float'),
}

_CTYPES_POINTERS = {'c_void_p', 'c_char_p', 'c_wchar_p'}


class PyCType(object):
    """One resolved ctypes type expression."""

    __slots__ = ('size', 'kind', 'pointee')

    def __init__(self, size, kind, pointee=None):
        self.size = size
        self.kind = kind        # ptr / int / uint / float / bytes / unknown
        self.pointee = pointee  # class name inside POINTER(...), or None


def resolve_ctype(node):
    """:class:`PyCType` for a ctypes type AST expression, or None for shapes
    this model does not understand (those are simply not checked)."""
    chain = attr_chain(node)
    if chain is not None:
        leaf = chain.rsplit('.', 1)[-1]
        if leaf in _CTYPES_POINTERS:
            return PyCType(_POINTER_SIZE, 'ptr')
        if leaf in _CTYPES_SCALARS:
            size, kind = _CTYPES_SCALARS[leaf]
            return PyCType(size, kind)
        return None
    if isinstance(node, ast.Call):
        fchain = attr_chain(node.func) or ''
        if fchain.rsplit('.', 1)[-1] == 'POINTER' and node.args:
            inner = attr_chain(node.args[0])
            pointee = inner.rsplit('.', 1)[-1] if inner else None
            return PyCType(_POINTER_SIZE, 'ptr', pointee)
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        elem = resolve_ctype(node.left)
        if elem is not None and isinstance(node.right, ast.Constant) \
                and isinstance(node.right.value, int):
            return PyCType(elem.size * node.right.value,
                           'bytes' if elem.kind == 'bytes' else elem.kind)
        return None
    if isinstance(node, ast.Constant) and node.value is None:
        return PyCType(0, 'void')
    return None


def _scalar_compatible(c_type, py):
    """A C scalar and a resolved ctypes scalar agree on size and signedness
    class (int/uint/float); ``char`` accepts either c_char or the 1-byte ints."""
    info = _scalar_info(c_type)
    if info is None:
        return True  # unknown C scalar: do not guess
    size, kind = info
    if py.size != size:
        return False
    if kind == 'bytes':
        return py.kind in ('bytes', 'int', 'uint')
    return py.kind == kind


# -- Python-side extraction -------------------------------------------------

def _iter_mirror_classes(tree):
    """(classdef, struct_name, fields) for every ctypes.Structure subclass
    with a ``mirror of ``struct X``` docstring; fields = [(name, type AST)]."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        doc = ast.get_docstring(node) or ''
        m = _MIRROR_RE.search(doc)
        if not m:
            continue
        fields = []
        for stmt in node.body:
            if not isinstance(stmt, ast.Assign):
                continue
            targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if '_fields_' not in targets:
                continue
            if isinstance(stmt.value, (ast.List, ast.Tuple)):
                for elt in stmt.value.elts:
                    if isinstance(elt, (ast.Tuple, ast.List)) and len(elt.elts) >= 2 \
                            and isinstance(elt.elts[0], ast.Constant):
                        fields.append((elt.elts[0].value, elt.elts[1], elt.lineno))
        yield node, m.group(1), fields


def _iter_signature_decls(tree):
    """(func_name, 'argtypes'|'restype', value AST, lineno) for every
    ``<lib>.<func>.argtypes/restype = ...`` assignment."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Attribute) \
                or target.attr not in ('argtypes', 'restype'):
            continue
        if not isinstance(target.value, ast.Attribute):
            continue
        yield target.value.attr, target.attr, node.value, node.lineno


def _find_expected_abi(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == 'EXPECTED_ABI'
                        for t in node.targets) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            return node.value.value, node.lineno
    return None, None


# -- the checker ------------------------------------------------------------

#: parsed-cpp cache: path -> (mtime, structs, funcs, abi_version)
_cpp_cache = {}


def _parsed_cpp(path):
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}, {}, None
    cached = _cpp_cache.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1], cached[2], cached[3]
    try:
        with open(path, 'rb') as f:
            text = f.read().decode('utf-8', 'replace')
    except OSError:
        return {}, {}, None
    text = _strip_cpp_comments_and_strings(text)
    parsed = (parse_cpp_structs(text), parse_extern_c_functions(text),
              parse_abi_version(text))
    _cpp_cache[path] = (mtime,) + parsed
    return parsed


def _sibling_cpp_model(src):
    """Merged struct/function/abi model of every ``*.cpp`` next to ``src``
    on disk (the native package dir; fixture dirs in tests). ``(None, None,
    None)`` when there are no C++ sources to check against."""
    dirname = os.path.dirname(os.path.abspath(src.path))
    if not os.path.isdir(dirname):
        return None, None, None
    paths = sorted(glob.glob(os.path.join(dirname, '*.cpp'))
                   + glob.glob(os.path.join(dirname, '*.cc')))
    if not paths:
        return None, None, None
    structs, funcs, abi = {}, {}, None
    for p in paths:
        s, f, a = _parsed_cpp(p)
        structs.update(s)
        funcs.update(f)
        if a is not None:
            abi = a
    return structs, funcs, abi


#: integer parameter names that read as a traveling bound (PT902)
_BOUND_TOKENS = frozenset({'n', 'len', 'cap', 'caps', 'size', 'count', 'pages',
                           'bytes', 'rows', 'capacity', 'width', 'height',
                           'sw', 'sh', 'dw', 'dh', 'w', 'h', 'c'})


def _is_bound_param(name, ctype):
    info = _scalar_info(ctype)
    if info is None or info[1] not in ('int', 'uint'):
        return False
    lowered = name.lower()
    if lowered.startswith(('max', 'n_', 'num')):
        return True
    return any(tok in _BOUND_TOKENS for tok in lowered.split('_'))


def _is_exempt_pointer(ctype, name):
    """NUL-terminated strings and opaque handles carry their own contract."""
    if ctype == 'char *':
        return True
    lowered = name.lower()
    return ctype == 'void *' and (lowered == 'h' or lowered.endswith('handle'))


class AbiConformanceChecker(Checker):
    code = 'PT900'
    codes = ('PT900', 'PT901', 'PT902')
    name = 'abi-conformance'
    description = ('C++ struct layouts vs ctypes mirrors (PT900), extern "C" '
                   'signatures vs argtypes/restype (PT901), pointer params '
                   'without a traveling capacity bound (PT902)')
    scope = ('*native/*.py', '*native/*.cpp', '*native/*.cc')

    def check(self, src):
        if src.is_python:
            yield from self._check_python_side(src)
        else:
            yield from self._check_pointer_bounds(src)

    # -- PT900 / PT901 (Python files, against the sibling C++ sources) ------

    def _check_python_side(self, src):
        structs, funcs, abi = _sibling_cpp_model(src)
        if structs is None:
            return  # no C++ sources next to this file: nothing to conform to
        mirrors = {}  # python class name -> C struct name
        for classdef, struct_name, py_fields in _iter_mirror_classes(src.tree):
            mirrors[classdef.name] = struct_name
            yield from self._check_struct_mirror(src, classdef, struct_name,
                                                 py_fields, structs)
        yield from self._check_signatures(src, funcs, structs, mirrors)
        yield from self._check_abi_literal(src, abi)

    def _check_struct_mirror(self, src, classdef, struct_name, py_fields, structs):
        c_fields = structs.get(struct_name)
        if c_fields is None:
            yield self.finding(
                src, classdef.lineno,
                '{} declares itself a mirror of struct {}, but no such struct '
                'exists in the native sources'.format(classdef.name, struct_name))
            return
        if layout_struct(c_fields) is None:
            yield self.finding(
                src, classdef.lineno,
                'struct {} has a field type this checker cannot lay out — '
                'extend analysis/abi.py so the {} mirror stays '
                'checkable'.format(struct_name, classdef.name))
            return
        # resolve the ctypes side with the same layout rules ctypes applies
        resolved = []
        for name, type_node, lineno in py_fields:
            py = resolve_ctype(type_node)
            if py is None:
                yield self.finding(
                    src, lineno,
                    '{}.{}: ctypes field type not understood by the ABI '
                    'checker — use a plain ctypes scalar/pointer/array '
                    'expression'.format(classdef.name, name))
                return
            resolved.append((name, py, lineno))
        offset = 0
        py_layout = []
        for name, py, lineno in resolved:
            align = min(py.size, 8) or 1
            offset = (offset + align - 1) // align * align
            py_layout.append((name, offset, py, lineno))
            offset += py.size
        if len(py_layout) != len(c_fields):
            yield self.finding(
                src, classdef.lineno,
                '{} has {} fields but struct {} has {} — the mirror drifted '
                '(every native write lands at C offsets, not Python '
                'ones)'.format(classdef.name, len(py_layout), struct_name,
                               len(c_fields)))
            return
        for (py_name, py_off, py, lineno), cf in zip(py_layout, c_fields):
            if py_name != cf.name:
                yield self.finding(
                    src, lineno,
                    '{}.{} mirrors struct {} field {!r} at this position — '
                    'field order/name drifted'.format(
                        classdef.name, py_name, struct_name, cf.name))
                continue
            if py_off != cf.offset or py.size != cf.size:
                yield self.finding(
                    src, lineno,
                    '{}.{}: offset/size ({}, {}) != struct {}.{} ({}, {}) — '
                    'layout drift means the kernel reads/writes the wrong '
                    'bytes'.format(classdef.name, py_name, py_off, py.size,
                                   struct_name, cf.name, cf.offset, cf.size))
                continue
            if (cf.kind == 'ptr') != (py.kind == 'ptr'):
                yield self.finding(
                    src, lineno,
                    '{}.{}: pointer/scalar kind mismatch with struct {}.{}'
                    .format(classdef.name, py_name, struct_name, cf.name))
            elif cf.kind in ('int', 'uint') and py.kind in ('int', 'uint') \
                    and cf.kind != py.kind:
                yield self.finding(
                    src, lineno,
                    '{}.{}: signedness mismatch with struct {}.{} ({} vs {})'
                    .format(classdef.name, py_name, struct_name, cf.name,
                            py.kind, cf.kind))

    def _check_signatures(self, src, funcs, structs, mirrors):
        mirror_by_struct = {v: k for k, v in mirrors.items()}
        for func_name, which, value, lineno in _iter_signature_decls(src.tree):
            cfunc = funcs.get(func_name)
            if cfunc is None:
                yield self.finding(
                    src, lineno,
                    '{} declares a ctypes signature for {}(), which no '
                    'extern "C" block in the native sources defines — '
                    'renamed or removed on the C side?'.format(
                        os.path.basename(src.relpath), func_name),
                    code='PT901')
                continue
            if which == 'argtypes':
                yield from self._check_argtypes(src, cfunc, value, lineno,
                                                mirror_by_struct)
            else:
                yield from self._check_restype(src, cfunc, value, lineno)
        # non-int returns MUST declare a restype: ctypes' default c_int
        # silently truncates a 64-bit return (or a pointer) to 32 bits
        decls = list(_iter_signature_decls(src.tree))
        declared = {(f, w) for f, w, _v, _l in decls}
        for func_name, which in sorted(declared):
            if which != 'argtypes' or (func_name, 'restype') in declared:
                continue
            cfunc = funcs.get(func_name)
            if cfunc is None:
                continue
            info = _scalar_info(cfunc.ret)
            needs_restype = _is_pointer(cfunc.ret) or (
                cfunc.ret != 'void' and (info is None or info[0] != 4))
            if needs_restype:
                lineno = min(l for f, _w, _v, l in decls if f == func_name)
                yield self.finding(
                    src, lineno,
                    '{}() returns {} but no restype is declared — ctypes '
                    'defaults to c_int and truncates the value to 32 '
                    'bits'.format(func_name, cfunc.ret),
                    code='PT901')

    def _check_argtypes(self, src, cfunc, value, lineno, mirror_by_struct):
        if not isinstance(value, (ast.List, ast.Tuple)):
            return
        declared = [resolve_ctype(elt) for elt in value.elts]
        if len(declared) != len(cfunc.params):
            yield self.finding(
                src, lineno,
                '{}() takes {} parameter{} but argtypes declares {} — '
                'signature drift'.format(
                    cfunc.name, len(cfunc.params),
                    '' if len(cfunc.params) == 1 else 's', len(declared)),
                code='PT901')
            return
        for i, (py, (c_type, c_name)) in enumerate(zip(declared, cfunc.params)):
            if py is None:
                continue  # unmodeled ctypes expression: not checked
            if _is_pointer(c_type):
                if py.kind != 'ptr':
                    yield self.finding(
                        src, lineno,
                        '{}() arg {} ({}: {}) is a pointer but argtypes[{}] '
                        'is a {}-byte scalar'.format(
                            cfunc.name, i, c_name, c_type, i, py.size),
                        code='PT901')
                    continue
                pointee = c_type[:-1].strip()
                expected = mirror_by_struct.get(pointee.rstrip(' *'))
                if expected and py.pointee and py.pointee != expected:
                    yield self.finding(
                        src, lineno,
                        '{}() arg {} points at struct {} but argtypes[{}] is '
                        'POINTER({}) — wrong mirror'.format(
                            cfunc.name, i, pointee, i, py.pointee),
                        code='PT901')
            elif not _scalar_compatible(c_type, py):
                yield self.finding(
                    src, lineno,
                    '{}() arg {} ({}: {}) does not match argtypes[{}] '
                    '(size/signedness drift truncates or sign-extends the '
                    'value at the boundary)'.format(
                        cfunc.name, i, c_name, c_type, i),
                    code='PT901')

    def _check_restype(self, src, cfunc, value, lineno):
        py = resolve_ctype(value)
        if py is None:
            return
        if cfunc.ret == 'void':
            if py.kind != 'void':
                yield self.finding(
                    src, lineno,
                    '{}() returns void but restype declares a value'.format(
                        cfunc.name),
                    code='PT901')
            return
        if _is_pointer(cfunc.ret):
            if py.kind != 'ptr':
                yield self.finding(
                    src, lineno,
                    '{}() returns {} but restype is not a pointer type — the '
                    'address gets truncated to 32 bits'.format(
                        cfunc.name, cfunc.ret),
                    code='PT901')
            return
        if not _scalar_compatible(cfunc.ret, py):
            yield self.finding(
                src, lineno,
                '{}() returns {} but restype disagrees on size/signedness'
                .format(cfunc.name, cfunc.ret),
                code='PT901')

    def _check_abi_literal(self, src, abi):
        expected, lineno = _find_expected_abi(src.tree)
        if expected is None:
            return
        if abi is None:
            yield self.finding(
                src, lineno,
                'EXPECTED_ABI is declared but no pstpu_abi_version() literal '
                'was found in the native sources')
        elif abi != expected:
            yield self.finding(
                src, lineno,
                'EXPECTED_ABI = {} but pstpu_abi_version() returns {} — bump '
                'both together (the version gate is the ONLY runtime defense '
                'against a stale kernel)'.format(expected, abi))

    # -- PT902 (C++ files) --------------------------------------------------

    def _check_pointer_bounds(self, src):
        text = _strip_cpp_comments_and_strings(src.text)
        for func in parse_extern_c_functions(text).values():
            unbounded = [name for ctype, name in func.params
                         if _is_pointer(ctype) and not _is_exempt_pointer(ctype, name)]
            if not unbounded:
                continue
            if any(_is_bound_param(name, ctype) for ctype, name in func.params):
                continue
            yield self.finding(
                src, func.lineno,
                'extern "C" {}() takes pointer parameter{} {} with no '
                'capacity/length parameter traveling in the signature — the '
                'kernel can only bounds-check what the caller hands it '
                '(PT503 generalized to the whole call surface)'.format(
                    func.name, '' if len(unbounded) == 1 else 's',
                    '/'.join(unbounded)),
                code='PT902')
