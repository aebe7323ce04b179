class Res(object):
    def close(self):
        pass


def leak():
    r = Res()
    r.poke()
