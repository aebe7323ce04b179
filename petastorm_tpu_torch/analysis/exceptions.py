"""PT300 — exception hygiene in the data plane.

A worker/transport/decoder exception that is silently swallowed does not
vanish: it resurfaces as a hung consumer (an item counted ventilated but never
completed), a short epoch, or corrupt state. The pools therefore have an
explicit error channel — thread pool workers forward through the results
queue, process workers pickle the exception over the transport — and every
broad handler in the data plane must either re-raise, forward, log, or carry a
reviewed justification.

Flagged: a bare ``except:`` or ``except Exception/BaseException`` handler that
*swallows* — no ``raise``, the bound exception (if any) is never referenced,
and the body performs no call at all (a call is evidence of handling:
forwarding to the error channel, logging, cleanup, a fallback path). The
existing ``# noqa: BLE001 - reason`` annotations are honored as suppressions
(alias of PT300), so the tree's pre-reviewed handlers stay quiet.

Scope: the data-plane modules — workers, reader/worker/serializer stack,
native bindings, torch loader/infeed — not the ETL/CLI long tail, where a
swallow costs a warning, not a training run.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker

_BROAD = {'Exception', 'BaseException'}


def _is_broad(handler):
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(el, ast.Name) and el.id in _BROAD for el in t.elts)
    return False


def _body_swallows(handler):
    """True when the handler neither raises, nor references the bound
    exception, nor calls anything."""
    bound = handler.name
    for node in ast.walk(handler):
        if node is handler.type:
            continue
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            return False
        if bound and isinstance(node, ast.Name) and node.id == bound:
            return False
    return True


class ExceptionHygieneChecker(Checker):
    code = 'PT300'
    name = 'exception-hygiene'
    description = ('broad except that swallows without forwarding to the error '
                   'channel, logging, or re-raising (data-plane modules)')
    scope = ('*workers/*.py', '*native/*.py', '*/torch/*.py',
             '*reader.py', '*row_worker.py', '*batch_worker.py', '*serializers.py',
             '*shuffling_buffer.py', '*columnar.py', '*rebatch.py',
             '*cache.py', '*local_disk_cache.py', '*retry.py',
             '*chunkstore/*.py', '*fabric/*.py')

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and _body_swallows(node):
                what = ('bare except' if node.type is None else
                        'except {}'.format(ast.unparse(node.type)))
                yield self.finding(
                    src, node.lineno,
                    '{} swallows silently — forward to the pool error channel, '
                    'log, re-raise, or annotate why discarding is safe'.format(what))


# ---------------------------------------------------------------------------
# PT701 — BaseException containment in worker loops
# ---------------------------------------------------------------------------

_UNCATCHABLE = {'BaseException', 'KeyboardInterrupt', 'SystemExit', 'GeneratorExit'}


def _catches_uncatchable(handler):
    """Names from :data:`_UNCATCHABLE` this handler's type clause catches
    EXPLICITLY (a bare ``except:`` is PT300's concern)."""
    t = handler.type
    names = []
    if isinstance(t, ast.Name) and t.id in _UNCATCHABLE:
        names.append(t.id)
    elif isinstance(t, ast.Tuple):
        names.extend(el.id for el in t.elts
                     if isinstance(el, ast.Name) and el.id in _UNCATCHABLE)
    return names


def _contains_or_forwards(handler):
    """True when the handler re-raises (any ``raise``), forwards the bound
    exception (references its name — e.g. handing it to the pool's error
    channel for the consumer to re-raise), or terminates the process
    (``os._exit``/``sys.exit`` — a worker's deliberate suicide)."""
    bound = handler.name
    for node in ast.walk(handler):
        if node is handler.type:
            continue
        if isinstance(node, ast.Raise):
            return True
        if bound and isinstance(node, ast.Name) and node.id == bound:
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ('_exit', 'exit') \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ('os', 'sys'):
            return True
    return False


class BaseExceptionContainmentChecker(Checker):
    """PT701 — worker/consumer loops must not swallow ``BaseException`` /
    ``KeyboardInterrupt``.

    The supervision layer (docs/robustness.md) is built on failures
    PROPAGATING: a worker loop that catches ``BaseException`` and carries on
    converts Ctrl-C into a hung pool (the consumer waits forever for a result
    the interrupted worker will never send) and converts ``SystemExit`` into a
    zombie worker the supervisor cannot distinguish from a healthy one.
    Catching these is only legitimate to clean up and re-raise, to forward the
    exception object to the error channel, or to deliberately kill the
    process — anything else is flagged. Stricter than PT300: logging alone
    does NOT absolve a ``BaseException`` handler."""

    code = 'PT701'
    name = 'baseexception-containment'
    description = ('except BaseException/KeyboardInterrupt that neither re-raises, '
                   'forwards the exception, nor exits the process (worker loops '
                   'must let cancellation through)')
    scope = ExceptionHygieneChecker.scope

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            caught = _catches_uncatchable(node)
            if caught and not _contains_or_forwards(node):
                yield self.finding(
                    src, node.lineno,
                    'except {} swallowed without re-raising — a worker loop that '
                    'eats cancellation/interpreter-shutdown wedges the pool; '
                    're-raise, forward the exception object, or os._exit'.format(
                        '/'.join(caught)))
