"""PT1301 bad fixture: a container mutated under a lock is read with no
lock held — iteration can observe the list mid-append."""

import threading


class Tracker(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, item):
        with self._lock:
            self._items.append(item)

    def snapshot(self):
        out = []
        for item in self._items:
            out.append(item)
        return out
