"""PT903/PT904 — overflow- and bounds-discipline lints for the C++ kernels.

Both memory-safety bugs the PR 6 review caught in ``rowgroup_reader.cpp``
were instances of two checkable shapes, encoded here so the next instance is
a lint failure instead of a review catch:

**PT903 — multiplication-form bounds comparison.** ``n * width <= cap``
wraps: a corrupt chunk declaring ``n ~ 2**61`` values makes the product
overflow ``uint64`` to a tiny number, sneaks past the check, and the decode
loop reads/writes far out of bounds (the shipped dictionary-page bug).
Every comparison whose operand contains a multiplication of two
non-constant values must instead be division-form (``n > cap / width``) or
carry an explicit overflow guard — a prior division by one of the
multiplicands in the same function counts, as does ``// noqa: PT903`` with a
reason. ``for (...)`` headers are exempt (loop-bound arithmetic over
already-validated counts, not untrusted-input capacity checks).

**PT904 — unguarded memcpy / pointer-advance.** A ``memcpy`` whose
destination is a buffer (not an address-of scalar local) and whose length
is computed (not a parameter/constant the caller already bounded) must be
dominated by a bounds comparison in the same function that names the
destination's capacity — the specific capacity field when the destination
is a fused-ABI descriptor pointer (``out`` → ``out_cap``, ``aux_buf`` →
``aux_cap``, ``chunk`` → ``chunk_len``), a capacity-like token
(``cap``/``len``/``size``/``bytes``/``avail``/``end``/``total``) otherwise.
Likewise a pointer that advances (``p += n``) inside a loop must be compared
against an end/bound in the same function. Dropping the check while keeping
the copy is exactly the PR 6 ``aux_bufs`` class.

Scope: ``native/*.cpp``. Suppress with ``// noqa: PT903 - <reason>`` /
``// noqa: PT904 - <reason>`` on the finding's line. See ``docs/analysis.md``.
"""

from __future__ import annotations

import re

from petastorm_tpu_torch.analysis.buffers import (_match_brace,
                                            _strip_cpp_comments_and_strings)
from petastorm_tpu_torch.analysis.core import Checker

#: a C++ function definition head (loose; shared shape with buffers.PT502)
_CPP_DEF_RE = re.compile(
    r'^[ \t]*(?:[A-Za-z_][\w:<>,*&\s]*?[\s*&])?'
    r'(?:[A-Za-z_][\w]*::)?(?P<name>~?[A-Za-z_]\w*)\s*\([^;{}]*\)'
    r'(?:\s*const)?(?:\s*noexcept)?\s*\{', re.MULTILINE)

_CPP_KEYWORDS = {'if', 'for', 'while', 'switch', 'return', 'catch', 'sizeof',
                 'defined'}

#: a comparison operator with the codebase's mandatory surrounding spaces —
#: distinguishes bounds checks from template brackets (``std::min<uint64_t>``)
_CMP_RE = re.compile(r'\s(?:<=|>=|<|>)\s')

#: ``A * B`` where both operands are value expressions (identifiers, casts,
#: member chains) — a literal factor still wraps for a huge counterpart, so
#: literals are NOT exempt; pointer-deref stars never have space on both sides
_MUL_RE = re.compile(
    r'(?P<lhs>[\w\)\]](?:[\w\.\)\]]|->)*)\s\*\s(?P<rhs>[\w\(]+)')

#: identifier tokens that read as a capacity/bound (PT904 generic tier)
_CAP_TOKEN_RE = re.compile(
    r'\b\w*(cap|capacity|len|size|bytes|avail|bound|end|total)\w*\b',
    re.IGNORECASE)

#: fused-ABI descriptor pointer field -> its capacity field (specific tier)
_DESC_BOUND_FIELDS = {'out': 'out_cap', 'aux_buf': 'aux_cap',
                      'chunk': 'chunk_len'}

_MEMCPY_RE = re.compile(r'\b(?:std::)?mem(?:cpy|move)\s*\(')

#: local/param pointer declaration: ``const uint8_t* p`` / ``uint8_t *dst``
_PTR_DECL_RE = re.compile(
    r'\b(?:const\s+)?[A-Za-z_][\w:]*\s*\*\s*(?:const\s*)?([A-Za-z_]\w*)\s*[=,;)]')

_PTR_ADVANCE_RE = re.compile(r'\b([A-Za-z_]\w*)\s*\+=\s*([^;]+);')


def _function_bodies(text):
    """(name, start_line, body_text including the signature) for every
    function definition in ``text`` (comments/strings already stripped)."""
    out = []
    for m in _CPP_DEF_RE.finditer(text):
        name = m.group('name')
        if name in _CPP_KEYWORDS:
            continue
        open_brace = text.index('{', m.end() - 1)
        end = _match_brace(text, open_brace)
        if end is None:
            continue
        lineno = text.count('\n', 0, m.start()) + 1
        out.append((name, lineno, text[m.start():end + 1]))
    return out


def _split_args(call_args):
    """Top-level comma split of a call's argument text."""
    parts, depth, cur = [], 0, []
    for ch in call_args:
        if ch in '([':
            depth += 1
        elif ch in ')]':
            depth -= 1
        if ch == ',' and depth == 0:
            parts.append(''.join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append(''.join(cur).strip())
    return parts


def _param_names(body):
    """Parameter (and template-parameter) names of a function body that
    begins with its signature."""
    sig_end = body.index('{')
    sig = body[:sig_end]
    open_paren = sig.find('(')
    if open_paren < 0:
        return set()
    names = set()
    for p in _split_args(sig[open_paren + 1:sig.rfind(')')]):
        m = re.search(r'([A-Za-z_]\w*)\s*$', p)
        if m:
            names.add(m.group(1))
    return names


def _identifiers(expr):
    return set(re.findall(r'[A-Za-z_]\w*', expr))


class CppSafetyChecker(Checker):
    code = 'PT903'
    codes = ('PT903', 'PT904')
    name = 'cpp-overflow-bounds'
    description = ('multiplication-form bounds comparisons that can wrap '
                   '(PT903); memcpy/pointer-advance without a dominating '
                   'capacity check (PT904)')
    scope = ('*native/*.cpp', '*native/*.cc')

    def check(self, src):
        text = _strip_cpp_comments_and_strings(src.text)
        for name, lineno, body in _function_bodies(text):
            yield from self._check_mul_bounds(src, name, lineno, body)
            yield from self._check_memcpy_bounds(src, name, lineno, body)
            yield from self._check_pointer_advances(src, name, lineno, body)

    # -- PT903 ---------------------------------------------------------------

    #: cast/type tokens that are never the value factor of a product
    _CAST_TOKENS = frozenset({'uint64_t', 'int64_t', 'uint32_t', 'int32_t',
                              'size_t', 'int', 'unsigned', 'long', 'sizeof',
                              'static_cast', 'u', 'ull', 'll', 'ul'})

    _INT_LITERAL_RE = re.compile(r'^\(?\d+(?:[uUlL]*)\)?$')

    def _check_mul_bounds(self, src, fn_name, fn_line, body):
        lines = body.split('\n')
        for i, line in enumerate(lines):
            stripped = line.strip()
            if stripped.startswith('for'):
                continue  # loop headers: counts already validated upstream
            if not _CMP_RE.search(line):
                continue
            for mm in _MUL_RE.finditer(line):
                lhs, rhs = mm.group('lhs'), mm.group('rhs')
                if self._INT_LITERAL_RE.match(lhs) or self._INT_LITERAL_RE.match(rhs):
                    continue  # constant factor: the hostile class is value*value
                factors = {t for t in _identifiers(lhs) | _identifiers(rhs)
                           if t not in self._CAST_TOKENS and not t.isdigit()}
                if not factors:
                    continue
                if self._factors_guarded(body, line, factors):
                    continue
                yield self.finding(
                    src, fn_line + i,
                    'multiplication-form bounds comparison in {}() — a corrupt '
                    'value wraps {} * {} past the check; compare division-form '
                    '(a > cap / b) or guard the product explicitly'.format(
                        fn_name, lhs.strip(')'), rhs.strip('(')),
                    code='PT903')

    def _factors_guarded(self, body, mul_line, factors):
        """The overflow guard this rule accepts: EVERY factor individually
        capped against a non-zero literal elsewhere in the function
        (``w > (1u << 24)``-style magnitude gates). One capped factor is not
        enough — the unbounded one still wraps the product; a division-form
        check elsewhere is not enough either — it bounds a *different*
        occurrence of the variable (the shipped dictionary-page bug lived in
        a branch its sibling check never dominated)."""
        def capped(tok):
            for line in body.split('\n'):
                if line is mul_line:
                    continue
                m = re.search(r'\b{}\b\s*(?:<|<=|>|>=)\s*\(?\s*(\d+)'
                              .format(re.escape(tok)), line)
                if m and int(m.group(1)) != 0:
                    return True
            return False
        return all(capped(tok) for tok in factors)

    # -- PT904: memcpy dominance ---------------------------------------------

    def _check_memcpy_bounds(self, src, fn_name, fn_line, body):
        params = _param_names(body)
        for m in _MEMCPY_RE.finditer(body):
            close = self._call_end(body, m.end() - 1)
            if close is None:
                continue
            args = _split_args(body[m.end():close])
            if len(args) != 3:
                continue
            dest, _src_arg, length = args
            if dest.startswith('&'):
                continue  # address-of scalar local: fixed-size, in-frame
            length_ids = _identifiers(length) - {'sizeof', 'uint64_t', 'int64_t',
                                                 'size_t', 'int'}
            if length_ids and length_ids <= params:
                continue  # the bound travels in as a parameter: caller checked
            if not length_ids and not re.search(r'[A-Za-z_]', length):
                continue  # pure constant length
            lineno = fn_line + body.count('\n', 0, m.start())
            required = self._required_cap_tokens(dest)
            if required is not None:
                if not any(re.search(r'\b{}\b'.format(tok), body)
                           for tok in required):
                    yield self.finding(
                        src, lineno,
                        'memcpy into descriptor pointer {} in {}() with no '
                        'check naming its capacity field {} — the PR 6 '
                        'aux-misalignment class'.format(
                            dest, fn_name, '/'.join(required)),
                        code='PT904')
                continue
            if not self._has_cap_comparison(body):
                yield self.finding(
                    src, lineno,
                    'memcpy in {}() with a computed length and no bounds '
                    'comparison naming a capacity in the function — every '
                    'write at the native boundary must be dominated by the '
                    "destination's capacity check".format(fn_name),
                    code='PT904')

    @staticmethod
    def _call_end(body, open_paren):
        depth = 0
        for i in range(open_paren, len(body)):
            if body[i] == '(':
                depth += 1
            elif body[i] == ')':
                depth -= 1
                if depth == 0:
                    return i
        return None

    @staticmethod
    def _required_cap_tokens(dest):
        """The specific capacity field(s) a fused-ABI descriptor destination
        must be checked against, or None for the generic tier."""
        for field, cap in _DESC_BOUND_FIELDS.items():
            if re.search(r'(->|\.){}\b'.format(field), dest):
                return (cap,)
        return None

    @staticmethod
    def _has_cap_comparison(body):
        for line in body.split('\n'):
            if not _CMP_RE.search(line) and '?' not in line:
                continue
            if _CAP_TOKEN_RE.search(line):
                return True
        return False

    # -- PT904: pointer advances ----------------------------------------------

    def _check_pointer_advances(self, src, fn_name, fn_line, body):
        pointers = set(_PTR_DECL_RE.findall(body))
        if not pointers:
            return
        params = _param_names(body)
        cmp_lines = [line for line in body.split('\n') if _CMP_RE.search(line)]
        for m in _PTR_ADVANCE_RE.finditer(body):
            name, amount = m.group(1), m.group(2)
            if name not in pointers:
                continue
            amount_ids = _identifiers(amount) - {'sizeof', 'uint64_t',
                                                 'int64_t', 'size_t'}
            if amount_ids and amount_ids <= params and name in params:
                continue  # caller-bounded walk over caller-owned memory
            # dominated either by a comparison involving the pointer itself
            # (`p < end`, `end - p < n`) or by comparisons validating every
            # identifier the advance amount is computed from
            ptr_checked = any(re.search(r'\b{}\b'.format(re.escape(name)), line)
                              for line in cmp_lines)
            amount_checked = amount_ids and all(
                any(re.search(r'\b{}\b'.format(re.escape(tok)), line)
                    for line in cmp_lines)
                for tok in amount_ids)
            if not ptr_checked and not amount_checked:
                lineno = fn_line + body.count('\n', 0, m.start())
                yield self.finding(
                    src, lineno,
                    'pointer {} advances in {}() with no bounds comparison '
                    'against an end/capacity in the function — a corrupt '
                    'length walks it out of the buffer'.format(name, fn_name),
                    code='PT904')
