"""From the process's start to the first measured step."""


def read(ctx):
    return ctx.setup_s
