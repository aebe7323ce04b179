class Leaky(object):
    def __del__(self):
        self._free()
