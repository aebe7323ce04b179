class RetryingHandler(object):
    def __eq__(self, other):
        return self.fs == other.fs
