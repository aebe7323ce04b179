"""PT1300 bad fixture: a cross-class ABBA lock-order cycle.

Pool.grow acquires Pool._counter_lock then (via a constructor-typed
attribute call) Ventilator._cv; Ventilator.drain acquires the same two
locks in the opposite order. Neither class sees anything wrong on its own —
only the whole-program graph closes the cycle.
"""

import threading


class Pool(object):
    def __init__(self):
        self._counter_lock = threading.Lock()
        self._workers = 0
        self._vent = Ventilator()

    def grow(self):
        with self._counter_lock:
            self._workers += 1
            self._vent.set_quota(self._workers)

    def shrink(self):
        with self._counter_lock:
            self._workers -= 1


class Ventilator(object):
    def __init__(self):
        self._cv = threading.Condition()
        self._quota = 0
        self._pool = Pool()

    def set_quota(self, n):
        with self._cv:
            self._quota = n
            self._cv.notify_all()

    def drain(self):
        with self._cv:
            self._pool.shrink()
