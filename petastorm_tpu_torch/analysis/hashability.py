"""PT600 — ``__eq__`` without ``__hash__``.

Python sets ``__hash__ = None`` on any class that defines ``__eq__`` without
also defining ``__hash__`` — the class (and anything embedding it, e.g. a
``pyarrow.fs.PyFileSystem`` wrapping a handler) silently becomes unhashable.
The round-5 ``RetryingHandler`` defect is this exact class of bug: adding a
policy-aware ``__eq__`` for pyarrow's filesystem dedupe broke every caller
that keys a dict/set on the filesystem. Intentional unhashability must be
explicit (``__hash__ = None`` in the class body); everything else needs a
``__hash__`` consistent with its ``__eq__``.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker


class HashabilityChecker(Checker):
    code = 'PT600'
    name = 'hashability'
    description = '__eq__ defined without __hash__ (class silently unhashable)'
    scope = ('*.py',)

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            has_eq = eq_line = None
            has_hash = False
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if item.name == '__eq__':
                        has_eq, eq_line = True, item.lineno
                    elif item.name == '__hash__':
                        has_hash = True
                elif isinstance(item, ast.Assign):
                    # `__hash__ = None` (explicit unhashable) or an alias
                    if any(isinstance(t, ast.Name) and t.id == '__hash__'
                           for t in item.targets):
                        has_hash = True
            if has_eq and not has_hash:
                yield self.finding(
                    src, eq_line,
                    'class {} defines __eq__ without __hash__ — Python sets '
                    '__hash__ = None, making it (and any wrapper like '
                    'pyarrow.fs.PyFileSystem) unhashable; add a consistent '
                    '__hash__, or an explicit __hash__ = None if intended'.format(
                        node.name))
