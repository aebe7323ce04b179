"""Bad fixture: shard-map construction that diverges across hosts."""

import random
import time

import numpy as np


def owner_of(item_index, members, seed, epoch):
    # PT1200: wall clock — no two hosts read the same value
    salt = time.time()
    return sorted(members)[int(salt + item_index) % len(members)]


def global_order(num_items, seed, epoch):
    # PT1200: module-global RNG stream is per-process, not per-pod
    order = list(range(num_items))
    random.shuffle(order)
    return order


def tie_break(num_items):
    # PT1200: unseeded constructor draws from OS entropy
    rng = np.random.default_rng()
    return rng.permutation(num_items)


def assign(members, items):
    assignment = {}
    # PT1200: set iteration order varies under hash randomization
    for member in set(members):
        assignment[member] = []
    return assignment


def ranks(members):
    # PT1200: list(set(...)) bakes hash order into the result
    return list(set(members))
