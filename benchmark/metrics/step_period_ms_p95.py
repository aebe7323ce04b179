"""The 95th percentile (nearest rank) of the periods between the ends of
consecutive steps, CUDA events on the consumer's stream: a step whose input
came late carries the wait."""

import math


def read(ctx):
    periods = sorted(ctx.window['periods_ms'])
    return periods[math.ceil(0.95 * len(periods)) - 1]
