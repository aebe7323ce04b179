"""The prefetch thread's time blocked on a full queue (the program's
``prefetch_put_wait`` stage) over the window, in percent: the input's
headroom, the share of the window in which the next batches were staged
before the loop asked for them; nothing where the program has no such
stage."""

KEY = 'stage_prefetch_put_wait_s'


def read(ctx):
    if KEY not in ctx.diag1:
        return None
    return ctx.delta(KEY) * 100.0 / ctx.window['window_s']
