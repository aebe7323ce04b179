import threading


class AB(object):
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
