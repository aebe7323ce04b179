"""Per-peer circuit breaker: stop sending to a peer that keeps failing.

Twin of ``petastorm_tpu/fabric/breaker.py`` (``docs/fabric.md``, "Breaker
semantics"), with three states:

* **closed**: requests flow; a success resets the count of consecutive
  failures, a failure adds one; K consecutive failures open the breaker;
* **open**: requests are refused locally (the client goes straight to the
  object-store fallback, no round trip to a peer known to be bad) until
  ``reset_after_s`` has passed;
* **half-open**: after the cooldown exactly one probe goes through: its
  success closes the breaker, its failure opens it again (and restarts the
  cooldown).

Each host keeps its own breakers, with no coordination: its view of which
peers are healthy is the one that predicts its next request's fate.
"""

from __future__ import annotations

import threading
import time

CLOSED, OPEN, HALF_OPEN = 'closed', 'open', 'half-open'


class CircuitBreaker(object):
    """Thread-safe per-peer breaker.

    :param failure_threshold: consecutive failures that open the breaker
    :param reset_after_s: cooldown before an open breaker admits one probe
    :param clock: monotonic time source (tests inject a fake)
    """

    def __init__(self, failure_threshold=3, reset_after_s=5.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1, got {}'.format(failure_threshold))
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self):
        with self._lock:
            return self._state

    def allow(self):
        """May a request go to this peer now? An open breaker whose cooldown
        has passed turns half-open and admits one probe; further calls are
        refused until :meth:`record_success` or :meth:`record_failure`
        resolves it."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_after_s:
                    return False
                self._state = HALF_OPEN
                self._probe_in_flight = True
                return True
            if self._probe_in_flight:  # half-open: one probe at a time
                return False
            self._probe_in_flight = True
            return True

    def record_success(self):
        """A request to this peer completed (bytes verified)."""
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self):
        """A request to this peer failed (connect, timeout, torn stream,
        corrupt payload). Returns True when this failure opened the breaker."""
        with self._lock:
            self._failures += 1
            self._probe_in_flight = False
            if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
                opened = self._state != OPEN
                self._state = OPEN
                self._opened_at = self._clock()
                return opened
            return False


__all__ = ['CLOSED', 'CircuitBreaker', 'HALF_OPEN', 'OPEN']
