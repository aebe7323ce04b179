"""The model's FLOPs per step (its kind's ``step_flops``) over the device's
kernel time per step in the traced slice, as a share of the card's
published bf16 peak, in percent."""


def read(ctx):
    per_step = ctx.trace and ctx.trace['kernel_busy_per_step_s']
    if not per_step or ctx.peak is None:
        return None
    return ctx.kind.step_flops(ctx.config) / per_step / ctx.peak[0] * 100.0
