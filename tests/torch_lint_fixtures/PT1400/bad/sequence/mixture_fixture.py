"""Bad fixture: sequence sampling/packing decisions that change every run."""

import random
import time

import numpy as np


def draw_source(cum_weights):
    # PT1400: module-global RNG — any other import of random perturbs order
    return int(np.searchsorted(cum_weights, random.random()))


def release_order(count):
    # PT1400: unseeded constructor draws from OS entropy
    rng = np.random.default_rng()
    return rng.permutation(count)


def pool_salt():
    # PT1400: wall clock in a packing decision — different every run
    return int(time.time()) % 97


def shuffle_pool(rows):
    # PT1400: np.random module-level call is the legacy global stream
    np.random.shuffle(rows)
    return rows
