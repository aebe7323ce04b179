"""Fabric fetching side: peer-first chunk fetch with a fallback.

Twin of ``petastorm_tpu/fabric/client.py``. :meth:`FabricClient.fetch` is
the ``chunkstore.store.PEER_SOURCE`` hook: it runs on a chunk-store miss,
inside the fetch stage, and returns the chunk's bytes (from a peer or the
object store), or None when a concurrent fetch of the same chunk already
populated the mirror (the single-flight follower; the store re-stats and
counts a hit).

A fabric problem never fails the batch. Every failure on the peer path
(refused connect, reset, timeout, torn stream, corrupt payload, protocol
garbage) lands in the object-store fallback (``retry.fetch_range`` through
the reader's ``fetch_fn``), and only a storage error of that fallback
propagates. Peer bytes are admitted only once the sha256 of the response
header verifies; anything else is discarded.

Per-peer circuit breakers (``breaker.py``) keep a flaky peer from taxing
every fetch: once open, requests skip the peer (no round trip) until a
half-open probe finds it healthy.

Per-peer stats go to ``<coord_dir>/fabric/stats/<host>-pid<pid>.torch.json``
(the JAX client's file ends in ``.json`` alone, so a process running both
packages keeps one file each; both packages' ``diagnose --fabric`` merge
every ``*.json`` there).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import tempfile
import threading
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.fabric import protocol as P
from petastorm_tpu_torch.fabric.breaker import CircuitBreaker
from petastorm_tpu_torch.fabric.peers import rank_peers
from petastorm_tpu_torch.observability import blackbox

logger = logging.getLogger(__name__)

#: how often the per-peer stats file is rewritten at most (and on close)
_STATS_FLUSH_INTERVAL_S = 0.5

#: how long a single-flight follower waits for the leader before assuming
#: it died and taking over the fetch
_INFLIGHT_WAIT_S = 60.0


def _new_peer_stats():
    return {'hits': 0, 'failures': 0, 'fallbacks': 0, 'bytes': 0,
            'latency_sum': 0.0, 'latency_n': 0}


def stats_file_name(host_id, pid=None):
    """The name of a port client's stats file under ``fabric/stats/``."""
    return '{}-pid{}.torch.json'.format(host_id, os.getpid() if pid is None else pid)


class FabricClient(object):
    """Peer-first chunk fetcher for one host.

    :param store: the host's :class:`ChunkStore` (digests, and the
        single-flight follower's populated check)
    :param peer_registry: a :class:`~petastorm_tpu_torch.fabric.peers.
        PeerRegistry` over the pod's membership leases
    :param coord_dir: the pod coordination directory; per-peer stats are
        flushed under ``<coord_dir>/fabric/stats/`` for ``diagnose --fabric``
    :param deadline_s: end-to-end budget of one peer transfer (connect,
        request, response, payload); what remains after a failed peer
        attempt is the fallback's retry deadline
    :param io_timeout_s: per-socket-operation timeout
    :param connect_timeout_s: TCP connect timeout (tight: a dead peer must
        cost little)
    :param failure_threshold: consecutive failures that open a peer's breaker
    :param breaker_reset_s: open-breaker cooldown before a half-open probe
    :param monitor: optional :class:`~petastorm_tpu_torch.analysis.protocol.
        monitor.FabricMonitor` checking the protocol at run time
    """

    def __init__(self, store, peer_registry, coord_dir, deadline_s=10.0, io_timeout_s=2.0,
                 connect_timeout_s=1.0, failure_threshold=3, breaker_reset_s=5.0,
                 monitor=None):
        self._store = store
        self._peers = peer_registry
        self._coord_dir = coord_dir
        self.deadline_s = float(deadline_s)
        self.io_timeout_s = float(io_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._failure_threshold = int(failure_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        self.monitor = monitor
        self._lock = threading.Lock()
        self._breakers = {}     # peer host -> CircuitBreaker
        self._inflight = {}     # chunk digest -> threading.Event
        self._peer_stats = {}   # peer host -> counter dict
        self._last_flush = 0.0
        self._stats_dir = os.path.join(coord_dir, 'fabric', 'stats')
        self.stats_path = os.path.join(self._stats_dir, stats_file_name(peer_registry.host_id))

    # -- the PEER_SOURCE hook ------------------------------------------------

    def fetch(self, key, length, fetch_fn):
        """``length`` bytes for ``key``: from a peer first, from the object
        store on any fabric trouble, or None when a concurrent fetch won.
        One thread per chunk runs the transfer; concurrent callers wait and
        return None, so the store re-stats the populated mirror."""
        digest = self._store.digest(key)
        while True:
            with self._lock:
                event = self._inflight.get(digest)
                if event is None:
                    self._inflight[digest] = threading.Event()
                    break
            event.wait(timeout=_INFLIGHT_WAIT_S)
            if self._store.contains(key, length):
                return None  # the leader populated it: ensure() counts a hit
            # the leader failed or died without populating: take over
        try:
            return self._fetch_once(key, length, digest, fetch_fn)
        finally:
            with self._lock:
                event = self._inflight.pop(digest, None)
            if event is not None:
                event.set()

    def _fetch_once(self, key, length, digest, fetch_fn):
        if self.monitor is not None:
            # ensure() missed: an earlier population of this chunk was
            # evicted, so populating again is legitimate
            self.monitor.on_invalidate(digest)
        deadline = P.Deadline(self.deadline_s)
        peer = self._pick_peer(digest)
        if peer is not None:
            t0 = time.monotonic()
            try:
                with obs.stage('fabric_peer_fetch', cat='fabric', bytes=length, peer=peer.host):
                    data = self._fetch_from_peer(peer, key, length, deadline)
            except (OSError, P.FabricError) as e:
                self._note_failure(peer, e)
            else:
                if data is not None:
                    self._note_success(peer, key, digest, length, time.monotonic() - t0)
                    return data
                # a miss: the peer is healthy and does not mirror this chunk,
                # so no breaker penalty
        return self._fallback(key, length, peer, deadline, fetch_fn)

    # -- peer path -----------------------------------------------------------

    def _pick_peer(self, digest):
        """The rendezvous-best live peer whose breaker admits a request."""
        for peer in rank_peers(digest, self._peers.alive_peers()):
            if self._breaker_for(peer.host).allow():
                if self.monitor is not None:
                    self.monitor.on_request(peer.host, allowed=True)
                return peer
        return None

    def _fetch_from_peer(self, peer, key, length, deadline):
        faults.on_net_connect()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(deadline.op_timeout(self.connect_timeout_s))
            sock.connect(peer.endpoint)
            P.send_frame(sock, P.encode_request(key, length), deadline, self.io_timeout_s)
            msg = P.decode_message(P.recv_frame(sock, deadline, self.io_timeout_s))
            status = msg.get('status')
            if status == 'miss':
                return None
            if status != 'ok':
                raise P.FabricProtocolError('peer {} answered {}: {}'.format(
                    peer.host, status, msg.get('message')))
            n = int(msg.get('length') or 0)
            if n != length:
                raise P.FabricProtocolError('peer {} offered {} bytes for a {} byte chunk'.format(
                    peer.host, n, length))
            data = P.recv_exactly(sock, n, deadline, self.io_timeout_s)
            if P.content_hash(data) != msg.get('sha256'):
                raise P.FabricProtocolError(
                    'content hash mismatch from peer {}: {} bytes discarded'.format(peer.host, n))
            return data
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _breaker_for(self, host):
        with self._lock:
            breaker = self._breakers.get(host)
            if breaker is None:
                breaker = CircuitBreaker(failure_threshold=self._failure_threshold,
                                         reset_after_s=self._breaker_reset_s)
                self._breakers[host] = breaker
            return breaker

    def _note_success(self, peer, key, digest, length, latency_s):
        self._breaker_for(peer.host).record_success()
        obs.count('fabric_peer_hits')
        obs.count('fabric_bytes_from_peers', length)
        if self.monitor is not None:
            self.monitor.on_populate(digest, verified=True)
            self.monitor.on_outcome(key, 'peer')
        blackbox.record_event({'kind': 'fabric', 'op': 'peer_hit', 'peer': peer.host,
                               'key': key, 'bytes': length,
                               'latency_ms': round(latency_s * 1e3, 3)})
        with self._lock:
            stats = self._peer_stats.setdefault(peer.host, _new_peer_stats())
            stats['hits'] += 1
            stats['bytes'] += length
            stats['latency_sum'] += latency_s
            stats['latency_n'] += 1
        self._flush_stats()

    def _note_failure(self, peer, error):
        tripped = self._breaker_for(peer.host).record_failure()
        logger.debug('fabric fetch from peer %s failed: %s', peer.host, error)
        if tripped:
            obs.count('fabric_breaker_open')
            blackbox.record_event({'kind': 'fabric', 'op': 'breaker_open', 'peer': peer.host,
                                   'error': str(error)[:200]})
        with self._lock:
            self._peer_stats.setdefault(peer.host, _new_peer_stats())['failures'] += 1
        self._flush_stats()

    # -- fallback path -------------------------------------------------------

    def _fallback(self, key, length, peer, deadline, fetch_fn):
        obs.count('fabric_fallbacks')
        blackbox.record_event({'kind': 'fabric', 'op': 'fallback', 'key': key,
                               'peer': peer.host if peer else None})
        with self._lock:
            host = peer.host if peer is not None else '-'
            self._peer_stats.setdefault(host, _new_peer_stats())['fallbacks'] += 1
        self._flush_stats()
        try:
            with obs.stage('fabric_fallback', cat='fabric', bytes=length):
                remaining = deadline.remaining()
                if remaining > 0 and getattr(fetch_fn, 'supports_deadline', False):
                    data = fetch_fn(deadline_s=remaining)
                else:
                    # the budget went on a stalled peer (or fetch_fn takes no
                    # deadline): the fallback still runs under its own retry
                    # policy, so degradation never turns into failure
                    data = fetch_fn()
        except Exception:
            if self.monitor is not None:
                self.monitor.on_outcome(key, 'error')
            raise  # a storage error: the one thing that propagates
        if self.monitor is not None:
            self.monitor.on_populate(self._store.digest(key), verified=True)
            self.monitor.on_outcome(key, 'fallback')
        return data

    # -- stats for diagnose --------------------------------------------------

    def _stats_locked(self):
        return {'host': self._peers.host_id,
                'peers': {h: dict(s) for h, s in self._peer_stats.items()},
                'breakers': {h: b.state for h, b in self._breakers.items()}}

    def stats(self):
        """This client's per-peer counters and breaker states, as flushed."""
        with self._lock:
            return self._stats_locked()

    def _flush_stats(self, force=False):
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_flush < _STATS_FLUSH_INTERVAL_S:
                return
            self._last_flush = now
            snapshot = self._stats_locked()
        try:
            os.makedirs(self._stats_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self._stats_dir, suffix='.tmp')
            with os.fdopen(fd, 'w') as f:
                json.dump(snapshot, f)
            os.replace(tmp, self.stats_path)
        except OSError as e:
            logger.debug('fabric stats flush failed: %s', e)

    def close(self):
        self._flush_stats(force=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ['FabricClient', 'stats_file_name']
