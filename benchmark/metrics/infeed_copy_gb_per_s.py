"""The infeed's host copy rate in the window: the program's
``infeed_bytes_total`` (bytes copied into pinned memory) over its
``infeed_copy`` stage seconds, in GB/s; nothing where the program times no
such stage."""


def read(ctx):
    seconds = ctx.delta('stage_infeed_copy_s')
    if seconds <= 0:
        return None
    return ctx.delta('infeed_bytes_total') / seconds / 1e9
