"""Item-failure policy and error records shared by the thread, dummy and
process pools (twin of ``petastorm_tpu/workers/supervision.py``).

Two failure planes:

* **Item failures**: ``worker.process`` raised, or (process pool) the item
  killed its worker process. Governed by the uniform
  ``on_error='raise'|'skip'|'retry'`` / ``max_item_retries`` policy: ``raise``
  surfaces the first error to the consumer; ``retry`` re-runs the item up to
  ``max_item_retries`` times before raising; ``skip`` re-runs, then
  *quarantines* it: the item is recorded, counted complete so the epoch
  ends, and the pipeline goes on.
* **Infrastructure failures**: a worker process died for reasons that may
  have nothing to do with its item. The process pool always respawns and
  requeues; only when the same item keeps killing its workers does the item
  policy apply.

Every ventilated item completes exactly once, however often it was requeued.
"""

from __future__ import annotations

import traceback

ON_ERROR_POLICIES = ('raise', 'skip', 'retry')

#: default consecutive-failure budget before an item is declared poison
DEFAULT_MAX_ITEM_RETRIES = 2


class ErrorPolicy(object):
    """Validated ``(on_error, max_item_retries)`` pair shared by every pool.

    ``attempts`` below counts *failed* attempts: an item is retried while
    ``attempts <= max_item_retries`` (so it runs at most
    ``max_item_retries + 1`` times).
    """

    __slots__ = ('on_error', 'max_item_retries')

    def __init__(self, on_error='raise', max_item_retries=DEFAULT_MAX_ITEM_RETRIES):
        if on_error not in ON_ERROR_POLICIES:
            raise ValueError("on_error must be one of {}, got {!r}".format(
                ON_ERROR_POLICIES, on_error))
        if not isinstance(max_item_retries, int) or max_item_retries < 0:
            raise ValueError('max_item_retries must be a non-negative integer, '
                             'got {!r}'.format(max_item_retries))
        self.on_error = on_error
        self.max_item_retries = max_item_retries

    @classmethod
    def resolve(cls, on_error='raise', max_item_retries=None):
        """An :class:`ErrorPolicy` as given, or built from the two knobs
        (``max_item_retries=None``: the default budget)."""
        if isinstance(on_error, cls):
            return on_error
        return cls(on_error, **({} if max_item_retries is None
                                else {'max_item_retries': max_item_retries}))

    def should_retry_error(self, attempts):
        """Retry a *raised* item failure? ``raise`` never retries errors: its
        contract is the fastest possible surfacing of the first failure."""
        return self.on_error in ('retry', 'skip') and attempts <= self.max_item_retries

    def should_retry_crash(self, attempts):
        """Retry an item whose worker *died*? Crashes are retried under every
        policy (respawn and requeue is the point of supervision); the budget
        only bounds how long a worker-killing item may crash-loop."""
        return attempts <= self.max_item_retries

    def quarantines(self):
        return self.on_error == 'skip'

    def __repr__(self):
        return 'ErrorPolicy(on_error={!r}, max_item_retries={})'.format(
            self.on_error, self.max_item_retries)


def quarantine_record(seq, attempts, kind, error=None, tb=None, worker_id=None, item=None):
    """The structured record of a quarantined item, a plain picklable dict.
    ``kind`` is ``'error'`` (worker raised) or ``'crash'`` (worker process
    died)."""
    return {
        'seq': seq,
        'item': item,
        'attempts': attempts,
        'kind': kind,
        'error': None if error is None else '{}: {}'.format(type(error).__name__, error),
        'traceback': tb,
        'worker_id': worker_id,
    }


def format_exception_tb(exc):
    """The formatted traceback of a live exception (worker side, before the
    traceback is lost to pickling)."""
    return ''.join(traceback.format_exception(type(exc), exc, exc.__traceback__))


class RemoteWorkerError(Exception):
    """Carrier for a worker-side failure context, installed as the
    ``__cause__`` of the worker exception re-raised on the consumer thread,
    so the traceback shows where the failure happened first."""


def attach_remote_context(exc, tb, worker_id=None, seq=None, pid=None):
    """Annotate a worker exception re-raised on the consumer thread with its
    remote traceback and origin: sets ``exc.worker_traceback``,
    ``exc.worker_id`` and ``exc.item_seq`` and chains a
    :class:`RemoteWorkerError` cause holding the remote traceback. Returns
    ``exc``."""
    where = 'worker {}'.format(worker_id if worker_id is not None else '?')
    if pid is not None:
        where += ' (pid {})'.format(pid)
    if seq is not None:
        where += ' processing item seq={}'.format(seq)
    exc.worker_traceback = tb
    exc.worker_id = worker_id
    exc.item_seq = seq
    exc.__cause__ = RemoteWorkerError(
        '{} failed; worker-side traceback:\n{}'.format(where, tb or '<unavailable>'))
    return exc
