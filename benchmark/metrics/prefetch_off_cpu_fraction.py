"""The share of the prefetch thread's stage time in the window that the
thread spent off the CPU (waiting on the interpreter lock, a page fault or
the scheduler): 1 - CPU seconds over wall seconds of its stages, the
shuffling buffer's two, ``collate`` and ``infeed``, in percent; nothing
where the program counts no CPU seconds."""

STAGES = ('shuffle.add_block', 'shuffle.emit', 'collate', 'infeed')


def read(ctx):
    if any('stage_{}_cpu_s'.format(s) not in ctx.diag1 for s in STAGES):
        return None
    wall = sum(ctx.delta('stage_{}_s'.format(s)) for s in STAGES)
    if wall <= 0:
        return None
    cpu = sum(ctx.delta('stage_{}_cpu_s'.format(s)) for s in STAGES)
    return (1.0 - cpu / wall) * 100.0
