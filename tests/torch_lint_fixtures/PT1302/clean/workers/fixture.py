"""PT1302 clean twin: the guarded dict is copied out under the lock — the
caller owns an independent snapshot."""

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
            return dict(self._entries)
