"""PT1300 clean twin: the same two classes with the cycle broken (the
cross-class call happens after the lock is released), plus a CLASS-LOCAL
ABBA cycle that PT101 owns — PT1300 must stay silent on it (the dedup
contract: the same cycle never fires twice)."""

import threading


class Pool(object):
    def __init__(self):
        self._counter_lock = threading.Lock()
        self._workers = 0
        self._vent = Ventilator()

    def grow(self):
        with self._counter_lock:
            self._workers += 1
            n = self._workers
        self._vent.set_quota(n)

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
            self._quota = 0
        self._pool.shrink()


class LocalOrder(object):
    """Class-local ABBA: PT101 territory, not PT1300's."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._x = 0
        self._y = 0

    def one(self):
        with self._a:
            with self._b:
                self._x = 1

    def two(self):
        with self._b:
            with self._a:
                self._y = 1
