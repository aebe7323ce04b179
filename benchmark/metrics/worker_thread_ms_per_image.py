"""The reader's workers' stage seconds (read, decode, transform, fused
decode; thread-seconds summed over the workers) over the window, per image
staged; nothing when the program's stage timers are off."""

STAGES = ('read', 'decode', 'transform', 'fused_decode')


def read(ctx):
    seconds = sum(ctx.delta('stage_{}_s'.format(s)) for s in STAGES)
    if seconds <= 0:
        return None
    return seconds * 1e3 / (ctx.window['steps'] * ctx.config['batch_size'])
