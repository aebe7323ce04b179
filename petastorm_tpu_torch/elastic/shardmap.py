"""Deterministic, churn-stable shard maps for elastic pod sharding.

A copy of ``petastorm_tpu/elastic/shardmap.py``, bit for bit in what it
computes: hosts of both packages may share one coordination directory, so
both must derive the same owners and the same order from the same inputs.
Callers pass Python ``int``s and ``str``s: :func:`stable_hash` hashes each
part's ``repr``, and ``repr(np.int64(3))`` is not ``repr(3)``.

Everything in this module is a *pure function* of ``(seed, epoch, member
set)`` — no wall-clock, no process-local RNG state, no set-iteration-order
dependence (the JAX linter's PT1200 enforces this statically).  Two
properties fall out:

* **Agreement without messages.** Every host computes the same map from the
  same inputs, so membership changes never need a leader election or a
  broadcast — hosts converge on the new assignment as soon as they observe
  the new generation's member list.
* **Churn stability.** Row-group ownership uses rendezvous (highest-random-
  weight) hashing: when a host leaves, only the row groups it owned move;
  when a host joins, it takes an even slice from everyone.  The *global
  emission order* is a seeded permutation of ``(seed, epoch)`` alone — it
  does not mention the member set at all, so the committed row-group
  sequence is bit-for-bit identical whether or not churn occurred.
"""

from __future__ import annotations

import hashlib

import numpy as np


def stable_hash(*parts):
    """A 64-bit hash of ``parts`` that is stable across processes and hosts.

    Built on blake2b over the ``repr`` of each part (null-separated), so it
    is immune to ``PYTHONHASHSEED`` — unlike builtin ``hash`` — and any mix
    of ints/strings/tuples hashes consistently everywhere.
    """
    digest = hashlib.blake2b(digest_size=8)
    for part in parts:
        digest.update(repr(part).encode('utf-8'))
        digest.update(b'\x00')
    return int.from_bytes(digest.digest(), 'big')


def owner_of(item_index, members, seed, epoch):
    """The host that owns row group ``item_index`` under this member set.

    Rendezvous hashing: each member scores ``stable_hash(seed, epoch,
    member, item)`` and the highest score wins.  Independent per item, so
    membership changes only move the items whose winner changed.
    """
    best = None
    best_score = -1
    for member in sorted(members):
        score = stable_hash('pstpu.elastic.owner', seed, epoch, member,
                            item_index)
        if score > best_score:
            best, best_score = member, score
    return best


def global_order(num_items, seed, epoch, shuffle=True):
    """The pod-wide emission order of row-group indices for this epoch.

    A function of ``(seed, epoch)`` only — deliberately independent of the
    member set, so the order survives any amount of churn.  With
    ``shuffle=False`` the order is the identity (row groups in file order).
    """
    if not shuffle:
        return list(range(num_items))
    rng = np.random.default_rng(stable_hash('pstpu.elastic.order', seed,
                                            epoch))
    return [int(i) for i in rng.permutation(num_items)]


class ShardMap(object):
    """One generation's assignment of ``num_items`` row groups to members.

    Immutable; constructed fresh each time the generation advances.  The
    map pins the member set it was derived from (``members``), so a host
    can tell "I own this under generation g" apart from "I would own this
    under the membership I can see right now".
    """

    __slots__ = ('generation', 'members', 'num_items', 'seed', 'epoch',
                 '_order', '_rank', '_owners')

    def __init__(self, generation, members, num_items, seed, epoch,
                 shuffle=True):
        if not members:
            raise ValueError('a shard map needs at least one member')
        self.generation = int(generation)
        self.members = tuple(sorted(members))
        self.num_items = int(num_items)
        self.seed = seed
        self.epoch = int(epoch)
        self._order = global_order(num_items, seed, epoch, shuffle=shuffle)
        self._rank = {item: rank for rank, item in enumerate(self._order)}
        self._owners = {item: owner_of(item, self.members, seed, epoch)
                        for item in range(num_items)}

    def owner(self, item_index):
        """The member that owns ``item_index`` under this generation."""
        return self._owners[item_index]

    def rank(self, item_index):
        """Position of ``item_index`` in the global emission order."""
        return self._rank[item_index]

    def order(self):
        """The full global emission order (list of item indices)."""
        return list(self._order)

    def owned_items(self, member):
        """Items owned by ``member``, in global emission order."""
        return [item for item in self._order if self._owners[item] == member]

    def describe(self):
        return ('generation={} members={} items={} epoch={}'
                .format(self.generation, ','.join(self.members),
                        self.num_items, self.epoch))


__all__ = ['ShardMap', 'global_order', 'owner_of', 'stable_hash']
