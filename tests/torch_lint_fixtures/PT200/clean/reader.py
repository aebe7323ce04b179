class Res(object):
    def close(self):
        pass


def ok_with():
    with Res() as r:
        return r.read()
