import threading


class Pool(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def inc(self):
        with self._lock:
            self._count += 1

    def unsafe_reset(self):
        self._count = 0
