"""The loader's shuffling buffer's stage seconds in the window (the
program's ``shuffle.add_block``, a reader block into the buffer, and
``shuffle.emit``, the gather of a batch out of it) per batch emitted;
nothing where the program times no such stage."""


def read(ctx):
    count = ctx.delta('stage_shuffle.emit_count')
    if count <= 0:
        return None
    seconds = ctx.delta('stage_shuffle.add_block_s') + ctx.delta('stage_shuffle.emit_s')
    return seconds * 1e3 / count
