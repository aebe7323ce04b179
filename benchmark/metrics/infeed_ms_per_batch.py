"""The program's ``infeed`` stage seconds per staged batch in the window:
the pinned allocation, the host-to-device copy and the enqueue."""


def read(ctx):
    count = ctx.delta('stage_infeed_count')
    if count <= 0:
        return None
    return ctx.delta('stage_infeed_s') * 1e3 / count
