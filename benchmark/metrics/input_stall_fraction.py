"""The training loop's time blocked in ``next()`` over the window, in
percent; the benchmark's own loop measures it."""


def read(ctx):
    return ctx.window['stall_s'] * 100.0 / ctx.window['window_s']
