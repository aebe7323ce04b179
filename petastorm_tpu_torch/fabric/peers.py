"""Peer discovery for the chunk fabric, on the elastic membership leases.

Twin of ``petastorm_tpu/fabric/peers.py``. There is no discovery protocol of
its own: a fabric host publishes its endpoint as an annotation of the
membership lease it already renews (``elastic/membership.py``): ``notes =
{'fabric': [address, port]}``. A peer is alive exactly while its lease is: a
host whose lease expires is a dead peer, a host that left disappears with
its lease.

Peers are chosen by rendezvous (highest random weight) hashing of ``(chunk
digest, peer host)``: every host ranks the same peers in the same order for
a chunk, so a pod's fetches of one chunk converge on one peer while the key
space spreads over all of them, and a peer's death remaps only its chunks.
"""

from __future__ import annotations

import hashlib


class PeerInfo(object):
    """One live fabric peer: its lease identity and published endpoint."""

    __slots__ = ('host', 'address', 'port')

    def __init__(self, host, address, port):
        self.host = host
        self.address = address
        self.port = int(port)

    @property
    def endpoint(self):
        return (self.address, self.port)

    def __repr__(self):
        return 'PeerInfo(host={!r}, endpoint={}:{})'.format(self.host, self.address, self.port)


class PeerRegistry(object):
    """Live fabric peers, read off the membership lease scan.

    :param membership: a :class:`~petastorm_tpu_torch.elastic.membership.
        MembershipRegistry` over the pod's coordination directory. It need
        not be joined: a fetch-only process (a spawned worker) scans leases
        without holding one.
    """

    def __init__(self, membership):
        self._membership = membership

    @property
    def host_id(self):
        return self._membership.host_id

    def alive_peers(self):
        """Every other host with a live lease and a published fabric
        endpoint, sorted by host id."""
        peers = []
        for m in self._membership.scan():
            if not m.alive or m.host == self._membership.host_id:
                continue
            endpoint = m.notes.get('fabric') if m.notes else None
            if not isinstance(endpoint, (list, tuple)) or len(endpoint) != 2:
                continue
            try:
                peers.append(PeerInfo(m.host, str(endpoint[0]), int(endpoint[1])))
            except (TypeError, ValueError):
                continue
        peers.sort(key=lambda p: p.host)
        return peers


def rank_peers(digest, peers):
    """Rendezvous ranking of ``peers`` for one chunk ``digest``, best first:
    the same on every host for the same peers."""
    def weight(peer):
        return hashlib.sha1('{}|{}'.format(digest, peer.host).encode('utf-8')).hexdigest()

    return sorted(peers, key=weight, reverse=True)


__all__ = ['PeerInfo', 'PeerRegistry', 'rank_peers']
