"""PT1301 clean twin: every read of the guarded container holds the lock —
including one inside a private helper whose lock is INFERRED from its call
sites (the guarded-by inference following self helper calls)."""

import threading


class Tracker(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, item):
        with self._lock:
            self._items.append(item)

    def snapshot(self):
        with self._lock:
            return list(self._items)

    def drain(self):
        with self._lock:
            return self._emit()

    def _emit(self):
        # no syntactic lock here: every call site holds _lock, so the
        # guarded-by inference credits this read with the ambient lock
        return list(self._items)
