"""Examples of every step completed in the window, over the window (host
clock, ending after the device finished)."""


def read(ctx):
    return ctx.window['steps'] * ctx.config['batch_size'] / ctx.window['window_s']
