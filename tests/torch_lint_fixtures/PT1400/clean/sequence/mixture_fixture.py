"""Clean twin: every decision consumes the seeded constructor stream."""

import numpy as np


def draw_source(cum_weights, rng):
    return int(np.searchsorted(cum_weights, rng.random()))


def release_order(count, seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(count)


def pool_salt(seed, epoch):
    return (seed * 31 + epoch) % 97


def shuffle_pool(rows, rng):
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]
