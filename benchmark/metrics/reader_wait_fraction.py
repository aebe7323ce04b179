"""The prefetch thread's time blocked on the reader (the loader's
``reader_wait_s``) over the window, in percent."""


def read(ctx):
    return ctx.delta('reader_wait_s') * 100.0 / ctx.window['window_s']
