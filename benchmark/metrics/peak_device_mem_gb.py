"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GB."""


def read(ctx):
    return ctx.memory_peak_bytes / 1e9
