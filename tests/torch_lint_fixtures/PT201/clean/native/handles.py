class Fine(object):
    def close(self):
        pass

    def __del__(self):
        self.close()
