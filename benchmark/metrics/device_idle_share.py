"""1 - the union of the device's activities over the traced slice, in
percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return (1.0 - ctx.trace['busy_s'] / ctx.trace['window_s']) * 100.0
