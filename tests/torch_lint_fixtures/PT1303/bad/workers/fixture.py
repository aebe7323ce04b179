"""PT1303 bad fixture: blocking calls made while holding a lock — a
blocking queue get under the lock, and an unbounded Condition.wait."""

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
            item = self._tasks.get()
        return item

    def wait_done(self):
        with self._cv:
            while not self._done:
                self._cv.wait()
