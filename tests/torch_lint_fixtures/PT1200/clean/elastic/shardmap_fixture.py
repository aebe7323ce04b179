"""Clean twin: everything derives from (seed, epoch, members)."""

import hashlib

import numpy as np


def stable_hash(*parts):
    h = hashlib.blake2b(digest_size=8)
    for part in parts:
        h.update(repr(part).encode('utf-8'))
        h.update(b'\x00')
    return int.from_bytes(h.digest(), 'big')


def owner_of(item_index, members, seed, epoch):
    ordered = sorted(members)
    scores = [(stable_hash(seed, epoch, m, item_index), m) for m in ordered]
    return max(scores)[1]


def global_order(num_items, seed, epoch):
    rng = np.random.default_rng(stable_hash(seed, epoch))
    return rng.permutation(num_items)


def assign(members, items):
    assignment = {}
    for member in sorted(set(members)):
        assignment[member] = []
    return assignment


def ranks(members):
    return sorted(set(members))
