"""Fault-tolerant peer-to-peer chunk fabric (``docs/fabric.md``).

Twin of ``petastorm_tpu/fabric/``. In a pod every host mirrors the column
chunks it reads into its local :mod:`~petastorm_tpu_torch.chunkstore`.
Without the fabric, N hosts reading one store pay N object-store GETs per
chunk. With it, a host that misses a chunk first asks a pod peer that
mirrors it (one object-store read and N-1 LAN copies) and falls back to the
object-store read on any fabric trouble. The fabric is an optimisation tier
only: a dead, slow, flaky or lying peer can cost latency, never correctness
and never a failed batch.

The parts:

* :mod:`~petastorm_tpu_torch.fabric.protocol`: the length-prefixed wire
  protocol (the JAX package's, byte for byte), per-operation timeouts under
  an end-to-end :class:`Deadline`;
* :mod:`~petastorm_tpu_torch.fabric.peers`: peer discovery on the elastic
  membership leases (the endpoint is a lease annotation; an expired lease
  is a dead peer);
* :mod:`~petastorm_tpu_torch.fabric.breaker`: the per-peer circuit breaker;
* :mod:`~petastorm_tpu_torch.fabric.server`: the chunk-serving daemon thread
  (mirrors pinned against eviction during a send);
* :mod:`~petastorm_tpu_torch.fabric.client`: peer-first fetch with sha256
  verification, single flight per chunk and the object-store fallback.

The protocol's invariants (at most one population per host, verified or
discarded bytes, guaranteed termination, breaker discipline) are model
checked by ``analysis/protocol/fabric_spec.py`` (``python -m
petastorm_tpu_torch.analysis.protocol.modelcheck --fabric``) and asserted at
run time with ``PSTPU_FABRIC_MONITOR=1``.

Wiring: :func:`start_node` builds a :class:`FabricNode` (store, optional
server, membership, client); :func:`install` points the chunk store's
``PEER_SOURCE`` hook at its client. The process pool ships
:meth:`FabricConfig.for_worker` to its spawned workers, which install a
fetch-only node (no server, no lease: the host owns the pod's lease and
serving socket).
"""

from __future__ import annotations

import threading

from petastorm_tpu_torch.fabric.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from petastorm_tpu_torch.fabric.client import FabricClient
from petastorm_tpu_torch.fabric.peers import PeerInfo, PeerRegistry, rank_peers
from petastorm_tpu_torch.fabric.protocol import (Deadline, FabricError, FabricProtocolError,
                                                 FabricTimeout)
from petastorm_tpu_torch.fabric.server import FabricServer


class FabricConfig(object):
    """Picklable description of one host's part in the fabric.

    :param coord_dir: the pod's shared coordination directory (the one the
        elastic membership uses)
    :param host_id: this host's stable identity in the pod
    :param cache: the host's :class:`~petastorm_tpu_torch.chunkstore.store.
        ChunkCacheConfig` (the mirror the fabric serves and fills)
    :param serve: start a :class:`FabricServer` over the mirror
    :param join: hold a membership lease (publishing the endpoint when
        serving); fetch-only processes scan leases without holding one
    :param listen_host: serving bind address
    :param port: serving bind port (0: ephemeral)
    :param lease_s: membership lease duration
    :param deadline_s: end-to-end budget of one peer transfer
    :param io_timeout_s: per-socket-operation timeout
    :param connect_timeout_s: TCP connect timeout
    :param failure_threshold: consecutive failures that open a peer's breaker
    :param breaker_reset_s: open-breaker cooldown before a half-open probe
    """

    def __init__(self, coord_dir, host_id, cache, serve=True, join=True,
                 listen_host='127.0.0.1', port=0, lease_s=5.0, deadline_s=10.0,
                 io_timeout_s=2.0, connect_timeout_s=1.0, failure_threshold=3,
                 breaker_reset_s=5.0):
        self.coord_dir = coord_dir
        self.host_id = str(host_id)
        self.cache = cache
        self.serve = bool(serve)
        self.join = bool(join)
        self.listen_host = listen_host
        self.port = int(port)
        self.lease_s = float(lease_s)
        self.deadline_s = float(deadline_s)
        self.io_timeout_s = float(io_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.failure_threshold = int(failure_threshold)
        self.breaker_reset_s = float(breaker_reset_s)

    def for_worker(self):
        """The fetch-only copy shipped to reader worker processes: no server
        (the host serves this mirror) and no lease (a pod has one member per
        host, not per process)."""
        return FabricConfig(
            coord_dir=self.coord_dir, host_id=self.host_id, cache=self.cache, serve=False,
            join=False, listen_host=self.listen_host, port=self.port, lease_s=self.lease_s,
            deadline_s=self.deadline_s, io_timeout_s=self.io_timeout_s,
            connect_timeout_s=self.connect_timeout_s,
            failure_threshold=self.failure_threshold, breaker_reset_s=self.breaker_reset_s)

    def __repr__(self):
        return 'FabricConfig(host_id={!r}, coord_dir={!r}, serve={}, join={})'.format(
            self.host_id, self.coord_dir, self.serve, self.join)


class FabricNode(object):
    """One process's part in the fabric: store, optional server, membership
    and client, started and stopped as a unit."""

    def __init__(self, config, monitor=None, on_request=None):
        from petastorm_tpu_torch.chunkstore.store import open_store

        self.config = config
        self._on_request = on_request
        self._monitor = monitor
        self.store = open_store(config.cache)
        self.server = None
        self.membership = None
        self.client = None
        self._started = False

    def start(self):
        from petastorm_tpu_torch.analysis.protocol.monitor import fabric_monitor_from_env
        from petastorm_tpu_torch.elastic.membership import MembershipRegistry

        if self._started:
            return self
        cfg = self.config
        annotations = None
        if cfg.serve:
            self.server = FabricServer(self.store, listen_host=cfg.listen_host, port=cfg.port,
                                       io_timeout_s=cfg.io_timeout_s,
                                       on_request=self._on_request).start()
            annotations = {'fabric': list(self.server.endpoint)}
        self.membership = MembershipRegistry(cfg.coord_dir, cfg.host_id, lease_s=cfg.lease_s,
                                             annotations=annotations)
        if cfg.join:
            self.membership.join()
        self.client = FabricClient(
            self.store, PeerRegistry(self.membership), cfg.coord_dir, deadline_s=cfg.deadline_s,
            io_timeout_s=cfg.io_timeout_s, connect_timeout_s=cfg.connect_timeout_s,
            failure_threshold=cfg.failure_threshold, breaker_reset_s=cfg.breaker_reset_s,
            monitor=fabric_monitor_from_env(self._monitor, 'fabric:' + cfg.host_id))
        self._started = True
        return self

    def stop(self):
        if not self._started:
            return
        self._started = False
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.membership is not None and self.config.join:
            self.membership.leave()
        if self.client is not None:
            self.client.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def start_node(config, monitor=None, on_request=None):
    """Build and start a :class:`FabricNode` for ``config``."""
    return FabricNode(config, monitor=monitor, on_request=on_request).start()


# -- process-wide installation ------------------------------------------------

_install_lock = threading.Lock()
_active_node = None


def install(node):
    """Point the chunk store's ``PEER_SOURCE`` hook at ``node``'s client:
    from here on every chunk miss in this process tries the fabric first.
    Takes a :class:`FabricNode` (tracked for :func:`shippable_config`) or a
    bare :class:`FabricClient`."""
    global _active_node
    from petastorm_tpu_torch.chunkstore import store as store_mod

    client = node.client if isinstance(node, FabricNode) else node
    with _install_lock:
        store_mod.PEER_SOURCE = client.fetch
        _active_node = node if isinstance(node, FabricNode) else None


def uninstall():
    """Detach the fabric from the chunk store (misses go straight to the
    object store again)."""
    global _active_node
    from petastorm_tpu_torch.chunkstore import store as store_mod

    with _install_lock:
        store_mod.PEER_SOURCE = None
        _active_node = None


def installed_node():
    """The installed :class:`FabricNode`, if any."""
    with _install_lock:
        return _active_node


def shippable_config():
    """The fetch-only config of the installed node, or None without one:
    the process pool ships it to its spawned workers with their setup
    arguments, as it ships an installed fault plan."""
    with _install_lock:
        node = _active_node
    return None if node is None else node.config.for_worker()


def install_from_config(config, monitor=None):
    """Worker-side bootstrap: start a (fetch-only) node for a shipped config
    and install it. Returns the node."""
    node = start_node(config, monitor=monitor)
    install(node)
    return node


__all__ = ['CLOSED', 'CircuitBreaker', 'Deadline', 'FabricClient', 'FabricConfig',
           'FabricError', 'FabricNode', 'FabricProtocolError', 'FabricServer', 'FabricTimeout',
           'HALF_OPEN', 'OPEN', 'PeerInfo', 'PeerRegistry', 'install', 'install_from_config',
           'installed_node', 'rank_peers', 'shippable_config', 'start_node', 'uninstall']
