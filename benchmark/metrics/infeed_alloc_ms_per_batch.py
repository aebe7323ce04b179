"""The program's ``infeed_alloc`` stage seconds (the pinned host tensors
allocated for a batch's arrays) per staged batch in the window; nothing
where the program times no such stage."""

KEY = 'stage_infeed_alloc_s'


def read(ctx):
    count = ctx.delta('stage_infeed_count')
    if count <= 0 or KEY not in ctx.diag1:
        return None
    return ctx.delta(KEY) * 1e3 / count
