"""Transient-storage retry: bounded exponential backoff around object-store IO.

Twin of ``petastorm_tpu/retry.py``. Object stores (``s3://``, ``gs://``) fail
not by losing an endpoint to fail over from (HDFS's model,
``hdfs/namenode.py``) but by the same endpoint answering transiently:
throttles (429/503 SlowDown), connection resets, timeouts. Every filesystem
operation and positional read therefore gets a bounded exponential-backoff
retry with jitter (:class:`RetryPolicy`), and a fresh underlying stream is
opened when a read fails mid-flight (:class:`_RetryingInputFile`).

Only idempotent operations are retried: metadata calls, input opens and
reads, and ``create_dir``/``copy_file`` (re-running converges). Deletes and
moves pass through unretried: a success whose response was lost would make
the retry raise a spurious ``FileNotFoundError``. Output streams retry their
open only, since a half-written object is not safely resumable.

Input files route through ``pa.PythonFile`` so a failed read resumes on a
fresh stream: a Python hop per read, on schemes where one network round trip
costs milliseconds. The resolver (``fs.py``) wraps ``s3``, ``gs`` and
``mock-remote`` only; local ``file://`` reads never see it.
:func:`fetch_range` is the chunk store's fetch primitive: one exact byte
window, retried as a unit.

The elastic membership leases and scoreboard ride :class:`RetryPolicy` too,
so that a slow or flaky shared filesystem retries instead of looking like a
host death. Jitter draws from a ``random.Random`` the policy owns (the JAX
policy draws from the module-global ``random``); the bounds are the same.
"""

from __future__ import annotations

import errno
import logging
import random
import re
import time

import pyarrow as pa
import pyarrow.fs as pafs

from petastorm_tpu_torch.pafs_util import DelegatingHandler

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

    def __getstate__(self):
        # the jitter RNG stays out: equal policies pickle to equal bytes (a
        # served stream's id hashes its spec), and each process draws its
        # own jitter
        return {k: v for k, v in self.__dict__.items() if k != '_rng'}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rng = random.Random()

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



class _RetryingInputFile(object):
    """File-like over ``fs.open_input_file`` that survives a transient
    failure mid-read by reopening the underlying stream and seeking back to
    the last good position. Wrapped in ``pa.PythonFile``, so Arrow and
    Parquet C++ consume it as a random-access file."""

    def __init__(self, fs, path, policy):
        self._fs = fs
        self._path = path
        self._policy = policy
        self._pos = 0
        self._file = policy.call(fs.open_input_file, path)
        self._size = None

    def _reopen(self):
        try:
            self._file.close()
        except Exception:  # noqa: BLE001 - the old handle is already broken
            pass
        self._file = self._fs.open_input_file(self._path)
        self._file.seek(self._pos)

    def _with_stream_retry(self, op):
        # a failed read leaves the stream in an unknown state: resume on a
        # fresh stream at the last good offset
        return self._policy.call(op, on_retry=lambda: self._policy.call(self._reopen))

    # -- the file protocol pa.PythonFile consumes --

    def read(self, nbytes=None):
        def _do():
            self._file.seek(self._pos)
            return self._file.read(nbytes) if nbytes is not None else self._file.read()
        data = self._with_stream_retry(_do)
        self._pos += len(data)
        return data

    def seek(self, offset, whence=0):
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self.size() + offset
        else:
            raise ValueError('invalid whence {}'.format(whence))
        return self._pos

    def tell(self):
        return self._pos

    def size(self):
        if self._size is None:
            self._size = self._with_stream_retry(lambda: self._file.size())
        return self._size

    @property
    def closed(self):
        return self._file.closed

    def close(self):
        self._file.close()


class RetryingHandler(DelegatingHandler):
    """A ``pyarrow.fs.FileSystemHandler`` delegating to another pyarrow
    filesystem with transient-error retries on idempotent operations: every
    delegated op retries under the policy, input opens return streams that
    resume mid-read, and output streams retry their open only.

    :func:`wrap_retrying` gives a genuine ``pyarrow.fs.PyFileSystem`` over
    it, usable wherever a filesystem is (Parquet reads, dataset listing).
    """

    def __init__(self, fs, policy=None):
        super(RetryingHandler, self).__init__(fs)
        self.policy = policy or RetryPolicy()

    def __eq__(self, other):
        # pyarrow dedupes filesystems by equality: the same store under
        # different retry policies must not compare equal
        if type(other) is type(self):
            return self.fs == other.fs and self.policy == other.policy
        return NotImplemented

    def __hash__(self):
        # __eq__ alone would set __hash__ = None, making the handler and any
        # PyFileSystem over it unhashable. self.fs stays out of the tuple:
        # pyarrow filesystems are unhashable; same-policy handlers over
        # different stores merely collide
        return hash((type(self), self.policy))

    def _invoke(self, fn, *args, **kwargs):
        return self.policy.call(fn, *args, **kwargs)

    def get_type_name(self):
        return 'retrying+' + self.fs.type_name

    # mutations that are not idempotent pass through unretried: had the
    # server done the op and the response been lost, a retry would raise a
    # spurious FileNotFoundError (create_dir and copy_file stay retried:
    # running them again converges to the same state)

    def delete_file(self, path):
        self.fs.delete_file(path)

    def delete_dir(self, path):
        self.fs.delete_dir(path)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self.fs.delete_dir_contents(path, missing_dir_ok=missing_dir_ok)

    def delete_root_dir_contents(self):
        self.fs.delete_dir_contents('/', accept_root_dir=True)

    def move(self, src, dest):
        self.fs.move(src, dest)

    def open_input_stream(self, path):
        return pa.PythonFile(_RetryingInputFile(self.fs, path, self.policy), mode='r')

    def open_input_file(self, path):
        return pa.PythonFile(_RetryingInputFile(self.fs, path, self.policy), mode='r')


def wrap_retrying(fs, policy=None):
    """``fs`` wrapped so that transient IO errors are retried with bounded
    exponential backoff: a genuine ``pyarrow.fs.PyFileSystem``."""
    return pafs.PyFileSystem(RetryingHandler(fs, policy))


def fetch_range(fs, path, offset, length, policy=None, deadline_s=None):
    """Exactly ``[offset, offset + length)`` of ``path``, read as one retried
    unit: each attempt opens a fresh stream (a positional read that failed
    leaves an object-store stream in an unknown state), reads the range and
    closes it. A short body raises an error classified transient, so a
    truncated transfer is retried instead of cached.

    ``deadline_s`` bounds the whole retried fetch end to end. ``fs`` may be
    raw or already retry-wrapped; wrapped, its inner operations retry
    individually too."""
    policy = policy or RetryPolicy()
    if deadline_s is not None:
        policy = policy.with_deadline(deadline_s)

    def _attempt():
        f = fs.open_input_file(path)
        try:
            if hasattr(f, 'read_at'):
                data = f.read_at(length, offset)
            else:
                f.seek(offset)
                data = f.read(length)
        finally:
            f.close()
        if len(data) != length:
            raise IOError('short read: got {} of {} bytes at offset {} from {}'.format(
                len(data), length, offset, path))
        return bytes(data)

    return policy.call(_attempt)


__all__ = ['FAULT_POINT', 'RetryPolicy', 'RetryingHandler', 'fetch_range',
           'is_transient_io_error', 'wrap_retrying']
