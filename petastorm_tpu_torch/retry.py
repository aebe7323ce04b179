"""Transient-storage retry: bounded exponential backoff with jitter.

Trimmed twin of ``petastorm_tpu/retry.py``: the error classifier
(:func:`is_transient_io_error`) and :class:`RetryPolicy`, which the elastic
membership leases and scoreboard ride, so that a slow or flaky shared
filesystem retries instead of looking like a host death. The wrappers of
remote filesystems (the retrying input file, the filesystem handler,
``fetch_range``) come with the port of remote filesystems.

Jitter draws from a ``random.Random`` the policy owns (the JAX policy draws
from the module-global ``random``); the bounds are the same.
"""

from __future__ import annotations

import errno
import logging
import random
import re
import time

logger = logging.getLogger(__name__)

#: fault-injection hook: when set, called before every
#: :meth:`RetryPolicy.call` attempt, so a test can make storage operations
#: fail transiently; None (the production state) costs one global load per
#: retried operation
FAULT_POINT = None

#: errnos that signal a transient network/storage condition
_TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.ETIMEDOUT, errno.ECONNRESET, errno.ECONNABORTED,
    errno.ECONNREFUSED, errno.EPIPE, errno.EHOSTUNREACH, errno.ENETUNREACH,
    errno.EBUSY,
})

#: lower-cased substrings of error messages Arrow surfaces for retryable
#: object-store failures (Arrow folds HTTP-level errors into OSError text)
_TRANSIENT_MARKERS = (
    'slow down', 'slowdown', 'slow_down', 'too many requests', 'request rate',
    'timed out', 'timeout', 'connection reset', 'connection aborted',
    'connection refused', 'broken pipe', 'temporarily unavailable',
    'service unavailable', 'internal server error',
    'bad gateway', 'gateway timeout', 'eof occurred',
    'curl error', 'throttl',
    # a ranged read whose body came back truncated: the transfer broke
    # mid-flight, so a fresh stream may succeed
    'short read',
)

#: retryable HTTP status codes, matched only in status context: a bare
#: " 500" would also match byte counts in permanent errors ("got 500 bytes")
_TRANSIENT_HTTP_RE = re.compile(
    r'(?:http|status|code|error)\W{0,10}(?:429|500|502|503|504)\b')


def is_transient_io_error(exc):
    """Whether ``exc`` is a retryable transient storage failure.

    Conservative on purpose: a missing file, a permission error and parse
    errors fail at once, since retrying them only delays the diagnosis."""
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if isinstance(exc, OSError):
        if exc.errno in _TRANSIENT_ERRNOS:
            return True
        msg = str(exc).lower()
        return (any(marker in msg for marker in _TRANSIENT_MARKERS)
                or _TRANSIENT_HTTP_RE.search(msg) is not None)
    return False


class RetryPolicy(object):
    """Bounded exponential backoff with jitter.

    ``max_attempts`` counts the first try: 4 means up to 3 retries. The sleep
    before retry ``k`` is ``initial_backoff_s * multiplier**(k-1)`` capped at
    ``max_backoff_s``, scaled by a factor drawn from ``1 ± jitter``, so
    workers that failed together do not retry together.

    ``deadline_s`` bounds one :meth:`call` end to end: once the time spent
    plus the next sleep would pass it, the last error is raised instead of
    sleeping.
    """

    def __init__(self, max_attempts=4, initial_backoff_s=0.1, multiplier=2.0,
                 max_backoff_s=5.0, jitter=0.25, classify=is_transient_io_error,
                 deadline_s=None):
        if max_attempts < 1:
            raise ValueError('max_attempts must be >= 1, got {}'.format(max_attempts))
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError('deadline_s must be positive, got {!r}'.format(deadline_s))
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.classify = classify
        self.deadline_s = deadline_s
        self._rng = random.Random()

    def with_deadline(self, deadline_s):
        """A copy of this policy under an end-to-end ``deadline_s`` budget
        (``None`` removes the budget)."""
        return RetryPolicy(max_attempts=self.max_attempts,
                           initial_backoff_s=self.initial_backoff_s,
                           multiplier=self.multiplier,
                           max_backoff_s=self.max_backoff_s,
                           jitter=self.jitter, classify=self.classify,
                           deadline_s=deadline_s)

    def _key(self):
        return (self.max_attempts, self.initial_backoff_s, self.multiplier,
                self.max_backoff_s, self.jitter, self.classify, self.deadline_s)

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def backoff_s(self, attempt):
        """The sleep before retry number ``attempt`` (1-based)."""
        base = min(self.initial_backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)
        return base * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def call(self, fn, *args, on_retry=None, **kwargs):
        """``fn(*args, **kwargs)`` with retries under this policy.
        ``on_retry`` (if given) runs after each backoff sleep, before the next
        attempt: reopening a broken stream, say."""
        attempt = 1
        t0 = time.monotonic() if self.deadline_s is not None else None
        while True:
            try:
                if FAULT_POINT is not None:
                    FAULT_POINT()
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if attempt >= self.max_attempts or not self.classify(e):
                    raise
                sleep_s = self.backoff_s(attempt)
                if t0 is not None and (time.monotonic() - t0) + sleep_s > self.deadline_s:
                    # the budget is spent: sleeping and retrying would pass
                    # the deadline, so the last error goes up now
                    raise
                logger.warning('Transient storage error (attempt %d/%d, retrying in %.2fs): %s',
                               attempt, self.max_attempts, sleep_s, e)
                time.sleep(sleep_s)
                attempt += 1
                if on_retry is not None:
                    on_retry()


__all__ = ['FAULT_POINT', 'RetryPolicy', 'is_transient_io_error']
