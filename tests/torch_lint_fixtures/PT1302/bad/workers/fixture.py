"""PT1302 bad fixture: a lock-guarded dict escapes by reference — the
caller iterates/mutates it after the lock is released."""

import threading


class Registry(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}

    def record(self, key, value):
        with self._lock:
            self._entries[key] = value

    def entries(self):
        with self._lock:
            return self._entries
