"""The normalize kernel's bytes bound (each uint8 element read once, its
bf16 result written once, at the card's HBM bandwidth) over its mean time in
the traced slice, in percent."""

from benchmark import flops

KERNEL = 'normalize_kernel'


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    times = [t for name, t in ctx.trace['kernel_mean_s'].items() if KERNEL in name]
    if not times:
        return None
    c = ctx.config
    elements = c['batch_size'] * c['image_size'] * c['image_size'] * c['in_channels']
    return flops.normalize_bytes(elements) / ctx.peak[1] / times[0] * 100.0
