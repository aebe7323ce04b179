"""Linter framework: source loading, findings, ``# noqa`` and baseline support.

Design notes:

* A :class:`SourceFile` pairs a file's text with its parsed AST (Python) —
  C++ sources (the native kernels) carry text only and are consumed by the
  text-level rules in :mod:`buffers`.
* Scoping is per-checker via fnmatch patterns against the file's *relative*
  path, so unit tests can exercise a checker on a fixture by constructing a
  ``SourceFile`` with any relpath they like (e.g. ``workers/fake.py``).
* Suppression matches the existing codebase convention: ``# noqa: CODE`` (with
  an optional free-text reason after the code list) on the finding's line, or a
  bare ``# noqa`` suppressing every rule on that line. ``BLE001`` — the
  broad-except code the tree already annotates — is honored as an alias for
  PT300, so the pre-reviewed handlers need no re-annotation.
* Baselines absorb findings by ``(code, path, stripped line text)`` with
  multiplicity, NOT by line number — a baseline survives unrelated edits above
  the finding.
"""

from __future__ import annotations

import ast
import json
import os
import re
import tokenize
from dataclasses import dataclass, field

#: noqa comment: "# noqa" or "# noqa: PT100" or "# noqa: PT100,BLE001 - reason"
_NOQA_RE = re.compile(r'#\s*noqa(?::\s*(?P<codes>[A-Z][A-Z0-9]*(?:\s*,\s*[A-Z][A-Z0-9]*)*))?',
                      re.IGNORECASE)

#: foreign suppression codes accepted for our equivalent rule
_CODE_ALIASES = {'BLE001': 'PT300'}


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location.

    ``status`` is ``'open'`` for an actionable finding; runs with
    ``keep_suppressed=True`` also carry ``'noqa'`` (suppressed on its line)
    and ``'baselined'`` (absorbed by the baseline) findings so machine
    consumers (``--format json``) can annotate diffs with the full picture.
    """
    path: str       # relative path (as scoped/reported)
    line: int       # 1-based
    code: str       # e.g. 'PT100'
    message: str
    snippet: str = field(default='', compare=False)
    status: str = field(default='open', compare=False)

    def format(self):
        return '{}:{}: {} {}'.format(self.path, self.line, self.code, self.message)

    def to_dict(self):
        """The stable one-object-per-line JSON schema of ``--format json``."""
        return {'rule': self.code, 'path': self.path, 'line': self.line,
                'message': self.message, 'snippet': self.snippet,
                'status': self.status}


class SourceFile(object):
    """A loaded source file: text, lines, per-line noqa codes, and (for
    Python) the parsed AST with parent links."""

    def __init__(self, path, relpath, text):
        self.path = path
        self.relpath = relpath.replace(os.sep, '/')
        self.text = text
        self.lines = text.splitlines()
        self.is_python = relpath.endswith('.py')
        self.tree = None
        self.parse_error = None
        self._noqa = (self._collect_noqa(text) if self.is_python
                      else self._collect_noqa_cpp(text))
        if self.is_python:
            try:
                self.tree = ast.parse(text)
            except SyntaxError as e:
                self.parse_error = e

    @classmethod
    def load(cls, path, relpath):
        with open(path, 'rb') as f:
            raw = f.read()
        try:
            text = raw.decode('utf-8')
        except UnicodeDecodeError:
            text = raw.decode('latin-1')
        return cls(path, relpath, text)

    @staticmethod
    def _collect_noqa(text):
        """{line: set of codes | None} — None means a bare ``# noqa`` (all).
        Tokenized, not regexed over raw lines, so a '# noqa' inside a string
        literal does not suppress anything."""
        noqa = {}
        try:
            tokens = tokenize.generate_tokens(iter(text.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _NOQA_RE.search(tok.string)
                if not m:
                    continue
                codes = m.group('codes')
                if codes is None:
                    noqa[tok.start[0]] = None
                else:
                    parsed = {c.strip().upper() for c in codes.split(',')}
                    parsed |= {_CODE_ALIASES[c] for c in parsed if c in _CODE_ALIASES}
                    existing = noqa.get(tok.start[0], set())
                    noqa[tok.start[0]] = None if existing is None else existing | parsed
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass
        return noqa

    @staticmethod
    def _collect_noqa_cpp(text):
        """C++ flavor: ``// noqa: PT903 - reason`` line comments (the C++
        rules PT502/PT9xx report on these sources)."""
        noqa = {}
        for i, line in enumerate(text.splitlines(), 1):
            comment = line.split('//', 1)
            if len(comment) < 2:
                continue
            m = _NOQA_RE.search('#' + comment[1])
            if not m:
                continue
            codes = m.group('codes')
            noqa[i] = None if codes is None else \
                {c.strip().upper() for c in codes.split(',')}
        return noqa

    def is_suppressed(self, line, code):
        if line not in self._noqa:
            return False
        codes = self._noqa[line]
        return codes is None or code in codes

    def line_text(self, line):
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ''


class Checker(object):
    """Base of every rule family.

    Subclasses set ``code`` (the family id used in docs/CLI listings),
    ``name``, ``description``, and ``scope`` — fnmatch patterns over relative
    paths (a leading ``*`` keeps them working whether or not the scanned root
    includes the ``petastorm_tpu_torch/`` prefix). ``check(src)`` yields
    :class:`Finding` objects; noqa/baseline filtering happens in the runner.
    """

    code = 'PT000'
    #: every rule id the checker can emit (None = just ``code``); the linter
    #: meta-test requires a committed bad/clean fixture pair per listed id,
    #: so a new id registered here without teeth fails tier-1
    codes = None
    #: True on :class:`ProgramChecker` subclasses — run once over all
    #: matching sources, not once per file
    program_level = False
    name = 'base'
    description = ''
    scope = ('*.py',)

    @classmethod
    def rule_codes(cls):
        return cls.codes or (cls.code,)

    def matches_path(self, relpath):
        import fnmatch
        return any(fnmatch.fnmatch(relpath, pat)
                   or fnmatch.fnmatch('/' + relpath, pat) for pat in self.scope)

    def matches(self, src):
        return self.matches_path(src.relpath)

    def check(self, src):
        raise NotImplementedError

    def finding(self, src, line, message, code=None):
        return Finding(path=src.relpath, line=line, code=code or self.code,
                       message=message, snippet=src.line_text(line))


class ProgramChecker(Checker):
    """Base of whole-program rule families (the PT13xx race lints).

    A program checker sees every in-scope source at once via
    :meth:`check_program` — cross-module lock-order graphs and guarded-by
    inference cannot be computed one file at a time. ``check(src)`` delegates
    to a single-file program run so fixture unit tests keep working, and the
    runner (:func:`run_checkers`) takes care to invoke the checker exactly
    once per pass, never per file. Incremental runs cache the program pass
    under a digest of ALL in-scope file bytes (see
    :func:`petastorm_tpu_torch.analysis.cache.run_analysis_incremental`)."""

    #: dispatch marker honored by run_checkers and the incremental runner
    program_level = True

    def check_program(self, sources):
        raise NotImplementedError

    def check(self, src):
        yield from self.check_program([src])


class Baseline(object):
    """Known-findings ledger: entries keyed by (code, path, stripped line
    text) with multiplicity. Line numbers are deliberately absent."""

    def __init__(self, entries=None):
        self._counts = {}
        for e in entries or []:
            key = self._key(e['code'], e['path'], e['line_text'])
            self._counts[key] = self._counts.get(key, 0) + int(e.get('count', 1))

    @staticmethod
    def _key(code, path, line_text):
        return (code, path, line_text.strip())

    def absorb(self, findings):
        """Findings not covered by the baseline (consumes multiplicity)."""
        return self.split(findings)[0]

    def split(self, findings):
        """``(open, absorbed)`` — absorbed findings carry status
        ``'baselined'`` (consumes multiplicity, like :meth:`absorb`)."""
        from dataclasses import replace
        remaining = dict(self._counts)
        open_findings, absorbed = [], []
        for f in findings:
            key = self._key(f.code, f.path, f.snippet)
            if remaining.get(key, 0) > 0:
                remaining[key] -= 1
                absorbed.append(replace(f, status='baselined'))
            else:
                open_findings.append(f)
        return open_findings, absorbed

    @staticmethod
    def from_findings(findings):
        counts = {}
        for f in findings:
            key = (f.code, f.path, f.snippet.strip())
            counts[key] = counts.get(key, 0) + 1
        return [{'code': c, 'path': p, 'line_text': t, 'count': n}
                for (c, p, t), n in sorted(counts.items())]


def load_baseline(path):
    """Load an ``analysis_baseline.json`` (``{"version": 1, "entries": [...]}``
    or a bare entries list). Returns an empty :class:`Baseline` for a missing
    file so fresh checkouts need no placeholder."""
    if not path or not os.path.exists(path):
        return Baseline()
    with open(path) as f:
        data = json.load(f)
    entries = data['entries'] if isinstance(data, dict) else data
    return Baseline(entries)


def write_baseline(path, findings):
    with open(path, 'w') as f:
        json.dump({'version': 1, 'entries': Baseline.from_findings(findings)}, f,
                  indent=2, sort_keys=True)
        f.write('\n')


#: extensions the framework loads; checkers scope further
_SOURCE_EXTS = ('.py', '.cpp', '.cc', '.h', '.hpp')

#: directories never scanned
_SKIP_DIRS = {'__pycache__', '.git', '.pytest_cache', 'node_modules'}


def collect_sources(paths):
    """Load every source file under ``paths`` (files and/or directories).
    Relative paths are taken against each directory argument (so scanning
    ``petastorm_tpu_torch/`` yields ``workers/thread_pool.py``-style relpaths)."""
    sources = []
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            sources.append(SourceFile.load(root, os.path.basename(root)))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(_SOURCE_EXTS):
                    full = os.path.join(dirpath, fn)
                    sources.append(SourceFile.load(full, os.path.relpath(full, root)))
    return sources


def run_checkers(checkers, sources, baseline=None, keep_suppressed=False):
    """Apply ``checkers`` to ``sources``; returns sorted findings with noqa
    suppression and baseline absorption applied. Python files that fail to
    parse produce a single PT000 finding (the pass must not silently skip).

    ``keep_suppressed=True`` keeps noqa'd/baselined findings in the result,
    annotated via :attr:`Finding.status` (``'noqa'``/``'baselined'``) — the
    machine-readable mode behind ``--format json``; only ``'open'`` findings
    are actionable either way."""
    from dataclasses import replace
    findings = []
    suppressed = []
    per_file = [c for c in checkers if not c.program_level]
    program = [c for c in checkers if c.program_level]
    by_relpath = {}
    for src in sources:
        if src.parse_error is not None:
            findings.append(Finding(path=src.relpath, line=src.parse_error.lineno or 1,
                                    code='PT000',
                                    message='syntax error: {}'.format(src.parse_error.msg)))
            continue
        by_relpath[src.relpath] = src
        for checker in per_file:
            if not checker.matches(src):
                continue
            for f in checker.check(src):
                if not src.is_suppressed(f.line, f.code):
                    findings.append(f)
                elif keep_suppressed:
                    suppressed.append(replace(f, status='noqa'))
    # whole-program passes: one invocation over every matching (parseable)
    # source; noqa still applies at the reported line of the reported file
    for checker in program:
        in_scope = [s for s in sources if s.parse_error is None
                    and checker.matches(s)]
        if not in_scope:
            continue
        for f in checker.check_program(in_scope):
            src = by_relpath.get(f.path)
            if src is None or not src.is_suppressed(f.line, f.code):
                findings.append(f)
            elif keep_suppressed:
                suppressed.append(replace(f, status='noqa'))
    findings.sort()
    if baseline is not None:
        open_findings, absorbed = baseline.split(findings)
        findings = open_findings + (absorbed if keep_suppressed else [])
    if keep_suppressed:
        findings = sorted(findings + suppressed)
    return findings


# -- shared AST helpers used by several checkers ----------------------------

def add_parents(tree):
    """Annotate every node with ``.pt_parent`` (None on the root)."""
    tree.pt_parent = None
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.pt_parent = node
    return tree


def attr_chain(node):
    """Dotted name of an Attribute/Name chain ('self._lock', 'np.random.rand'),
    or None when the chain contains calls/subscripts."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def class_methods(classdef):
    """The directly-defined function bodies of a class (no nesting descent)."""
    return [n for n in classdef.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def walk_functions(tree):
    """Every function/method in the module, with its enclosing class (or None)."""
    out = []

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, cls))
                visit(child, cls)
            else:
                visit(child, cls)

    visit(tree, None)
    return out
