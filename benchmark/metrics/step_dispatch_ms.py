"""The host's time in a replayed step (the program's ``train_step`` stage:
the draws, the copies into the graph's static inputs, the replay's launch
and the metrics' copies) per replayed step in the window; nothing where the
program has no such stage."""


def read(ctx):
    count = ctx.delta('stage_train_step_count')
    if count <= 0:
        return None
    return ctx.delta('stage_train_step_s') * 1e3 / count
