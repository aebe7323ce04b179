"""PT1303 clean twin: the queue get is nonblocking under the lock, and the
wait is bounded (the shutdown-safe re-check-loop convention)."""

import queue
import threading


class Feeder(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition()
        self._tasks = queue.Queue()
        self._done = False

    def pump(self):
        with self._lock:
            try:
                item = self._tasks.get_nowait()
            except queue.Empty:
                item = None
        return item

    def wait_done(self):
        with self._cv:
            while not self._done:
                self._cv.wait(timeout=0.5)
