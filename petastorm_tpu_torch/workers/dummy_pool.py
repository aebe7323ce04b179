"""Dummy pool: synchronous execution on the CONSUMER thread.

Trimmed twin of ``petastorm_tpu/workers/dummy_pool.py``. ``ventilate`` only
enqueues; ``worker.process`` runs inside :meth:`get_results` on the caller's
thread, in ventilation order, which makes the output order a pure function of
the ventilator's seed (what the parity tests compare).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from petastorm_tpu_torch.errors import EmptyResultError


class DummyPool(object):
    def __init__(self):
        self.workers_count = 1
        self._results = deque()
        self._pending = deque()
        self._lock = threading.Lock()
        self._worker = None
        self._ventilator = None

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._worker is not None:
            raise RuntimeError('Pool already started')
        self._worker = worker_class(0, self._results.append, worker_setup_args)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def ventilate(self, **kwargs):
        with self._lock:
            self._pending.append(kwargs)

    def _process_one(self):
        """Run one pending item on this thread; False when none is queued."""
        with self._lock:
            if not self._pending or self._worker is None:
                return False
            kwargs = self._pending.popleft()
        try:
            self._worker.process(**kwargs)
        except Exception:
            if self._ventilator is not None:
                self._ventilator.stop()
            raise
        finally:
            if self._ventilator is not None:
                self._ventilator.processed_item()
        return True

    def get_results(self):
        while True:
            if self._results:
                return self._results.popleft()
            if self._process_one():
                continue
            if self._ventilator is None or self._ventilator.completed():
                # re-check: the ventilator may have enqueued between the
                # emptiness check and completed() flipping true
                if self._process_one():
                    continue
                if self._results:
                    return self._results.popleft()
                raise EmptyResultError()
            time.sleep(0.0001)

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        with self._lock:
            self._pending.clear()

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None
