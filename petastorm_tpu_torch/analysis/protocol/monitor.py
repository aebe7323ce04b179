"""Runtime conformance monitor for the worker-pool supervision protocol.

The observer projection of ``spec.py``: a :class:`ProtocolMonitor` ingests the
consumer-visible events of a live pool — dispatches, requeues, consumed
messages with the pool's live/stale classification, completions, epoch drains
— and raises :class:`~petastorm_tpu_torch.errors.ProtocolViolation` on any sequence
the spec rejects. Where the model checker proves the *design* for small
scopes, the monitor checks that the *implementation* actually walks the
spec's transition relation on every real run (ThreadSanitizer-style: the
checking rides the workload you already run). Twin of
``petastorm_tpu/analysis/protocol/monitor.py``: the same events, rules and
messages. :class:`FabricMonitor` is here for the chunk fabric, which is not
ported yet (ROADMAP.md, "fabric"), so nothing feeds it.

Opt in per pool (``ProcessPool(..., protocol_monitor=True)``), per reader
(``make_reader(..., protocol_monitor=True)``), or process-wide via
``PSTPU_PROTOCOL_MONITOR=1`` — which is how
``tests/test_torch_fault_tolerance.py`` and ``chip_smoke.py``'s ``raw_chaos``
path turn every crash / requeue / poison scenario into a conformance proof. Overhead is one guarded
method call per *item-level* event (never per row); with the monitor off the
pools pay a single ``None`` check.

Event rules (the spec's conformance contract, ``docs/protocol.md``):

* dispatch ids are issued monotonically and NEVER reused;
* a requeue must take a live id out of flight and issue a fresh one — and must
  never requeue an item whose payload was already delivered (that is the
  double-delivery defect the model checker surfaces as ``requeue_published``);
* every consumed message must reference an issued id, and the pool's
  live/stale classification must match the monitor's in-flight view;
* each logical item (a dispatch-id chain linked by requeues) completes at most
  once, and only from a live id;
* at epoch drain the pool's ventilated/completed counters must equal the
  monitor's, with nothing left in flight.
"""

from __future__ import annotations

import threading

from petastorm_tpu_torch.errors import ProtocolViolation


class ProtocolMonitor(object):
    """Thread-safe conformance monitor (pools emit events from consumer and
    worker threads). All state is dispatch-id keyed, so it works for the
    process pool's wire protocol and the thread/dummy pools' in-process
    equivalent alike."""

    def __init__(self, name='pool'):
        self._name = name
        self._lock = threading.Lock()
        self._last_id = -1
        self._inflight = {}    # live dispatch id -> root id (logical item chain)
        self._resolved = {}    # retired/completed dispatch id -> root id
        self._published = set()  # live ids whose payload reached the consumer
        self._completed_roots = set()
        self._seq_by_root = {}
        self.ventilated = 0
        self.completed = 0
        self.violations_checked = 0

    def _fail(self, message):
        raise ProtocolViolation('[protocol monitor: {}] {}'.format(self._name, message))

    def _fresh(self, d, what):
        if d in self._inflight or d in self._resolved:
            self._fail('{} reuses dispatch id {} — ids must never be reused or '
                       'stale messages become indistinguishable from live ones'
                       .format(what, d))
        if d <= self._last_id:
            self._fail('{} issued non-monotonic dispatch id {} (last was {})'
                       .format(what, d, self._last_id))
        self._last_id = d

    # -- events --------------------------------------------------------------

    def on_dispatch(self, d, seq=None):
        """A new item was ventilated under dispatch id ``d``."""
        with self._lock:
            self.violations_checked += 1
            self._fresh(d, 'dispatch')
            self._inflight[d] = d
            self._seq_by_root[d] = seq
            self.ventilated += 1

    def on_requeue(self, old_d, new_d):
        """An in-flight item moved from ``old_d`` to a fresh ``new_d``."""
        with self._lock:
            self.violations_checked += 1
            root = self._inflight.get(old_d)
            if root is None:
                self._fail('requeue of dispatch id {} which is not in flight '
                           '(stale or never issued)'.format(old_d))
            if old_d in self._published:
                self._fail('requeue of dispatch id {} whose payload was already '
                           'delivered — re-running it would deliver the item '
                           'twice'.format(old_d))
            self._fresh(new_d, 'requeue')
            del self._inflight[old_d]
            self._resolved[old_d] = root
            self._inflight[new_d] = root

    def on_message(self, kind, d, live=None):
        """The consumer processed a ``kind`` message for dispatch ``d``.
        ``live`` is the pool's stale/live classification (None when the kind
        carries no such decision, e.g. claims)."""
        if d is None:
            return  # untagged message (startup, idle beacon): nothing to check
        with self._lock:
            self.violations_checked += 1
            known = d in self._inflight or d in self._resolved
            if not known:
                self._fail('{} message for dispatch id {} which was never '
                           'issued'.format(kind, d))
            if live is True and d not in self._inflight:
                self._fail('pool treated a {} for retired dispatch id {} as '
                           'live — stale stragglers must be dropped'.format(kind, d))
            if live is False and d in self._inflight:
                self._fail('pool dropped a {} for live dispatch id {} as '
                           'stale'.format(kind, d))
            if kind == 'data' and live:
                self._published.add(d)

    def on_complete(self, d, delivered, quarantined=False):
        """The pool resolved dispatch ``d`` (done consumed / orphan published /
        quarantine / error-completion) and advanced its completion counter."""
        with self._lock:
            self.violations_checked += 1
            root = self._inflight.pop(d, None)
            if root is None:
                self._fail('completion for dispatch id {} which is not in '
                           'flight — a stale duplicate must not advance the '
                           'epoch accounting'.format(d))
            self._resolved[d] = root
            self._published.discard(d)
            if root in self._completed_roots:
                self._fail('item (root dispatch {}, seq {}) completed twice'
                           .format(root, self._seq_by_root.get(root)))
            self._completed_roots.add(root)
            self.completed += 1

    def on_drained(self, pool_ventilated, pool_completed):
        """The pool declared the epoch drained (``EmptyResultError``)."""
        with self._lock:
            self.violations_checked += 1
            if self._inflight:
                self._fail('epoch declared drained with {} dispatch id(s) still '
                           'in flight: {}'.format(
                               len(self._inflight), sorted(self._inflight)))
            if (pool_ventilated, pool_completed) != (self.ventilated, self.completed):
                self._fail('pool counters (ventilated={}, completed={}) diverge '
                           'from observed events (ventilated={}, completed={})'
                           .format(pool_ventilated, pool_completed,
                                   self.ventilated, self.completed))
            if pool_ventilated != pool_completed:
                self._fail('drained epoch with ventilated={} != completed={}'
                           .format(pool_ventilated, pool_completed))

    @property
    def snapshot(self):
        """Diagnostics view: counters + in-flight ids (for test assertions)."""
        with self._lock:
            return {'ventilated': self.ventilated, 'completed': self.completed,
                    'in_flight': sorted(self._inflight),
                    'events_checked': self.violations_checked}


class ServeMonitor(object):
    """Runtime conformance monitor for the serve fan-out plane
    (``docs/serve.md``, multi-consumer invariant catalog in
    ``docs/protocol.md``). Each process checks its observable projection of
    the broadcast protocol:

    * daemon side — a tenant attaches at most once and only detaches/evicts
      while attached; a stream never publishes the SAME item seq twice (a
      repeat means a batch was decoded-and-published twice: the retry path
      may reorder seqs, but never duplicate them); nothing is published to a
      stream after its END;
    * consumer side — no seq is delivered twice to this consumer (a duplicate
      means a ring slot was re-delivered: the released-exactly-once-per-
      consumer invariant broken), and nothing is delivered after the
      stream's END frame.

    Violations raise :class:`~petastorm_tpu_torch.errors.ProtocolViolation`.
    """

    def __init__(self, name='serve'):
        self._name = name
        self._lock = threading.Lock()
        self._attached = set()          # live tenant ids (daemon side)
        self._seen_tenants = set()
        self._published = {}            # stream id -> set of published seqs
        self._ended = set()             # stream ids past their END frame
        self._delivered = set()         # consumer side: seqs delivered here
        self._consumer_ended = False
        self.events_checked = 0

    def _fail(self, message):
        raise ProtocolViolation('[serve monitor: {}] {}'.format(self._name, message))

    # -- daemon-side events --------------------------------------------------

    def on_attach(self, tenant_id, stream_id):
        with self._lock:
            self.events_checked += 1
            if tenant_id in self._attached:
                self._fail('tenant {} attached twice'.format(tenant_id))
            self._attached.add(tenant_id)
            self._seen_tenants.add(tenant_id)

    def on_detach(self, tenant_id):
        with self._lock:
            self.events_checked += 1
            if tenant_id not in self._attached:
                self._fail('detach of tenant {} which is not attached — a '
                           'double detach would free another tenant\'s ring '
                           'slot'.format(tenant_id))
            self._attached.discard(tenant_id)

    def on_evict(self, tenant_id):
        with self._lock:
            self.events_checked += 1
            if tenant_id not in self._attached:
                self._fail('eviction of tenant {} which is not attached'
                           .format(tenant_id))
            # an evicted tenant stays 'attached' until its client detaches —
            # eviction only stops its cursor from constraining the producer

    def on_publish(self, stream_id, seq):
        with self._lock:
            self.events_checked += 1
            if stream_id in self._ended:
                self._fail('publish on stream {} after its END frame'
                           .format(stream_id))
            if seq is not None:
                seen = self._published.setdefault(stream_id, set())
                if seq in seen:
                    self._fail('stream {} published seq {} twice — one decode '
                               'must publish exactly once (retries may '
                               'reorder seqs, never duplicate them)'
                               .format(stream_id, seq))
                seen.add(seq)

    def on_end(self, stream_id):
        with self._lock:
            self.events_checked += 1
            if stream_id in self._ended:
                self._fail('stream {} ended twice'.format(stream_id))
            self._ended.add(stream_id)

    # -- consumer-side events ------------------------------------------------

    def on_deliver(self, seq):
        with self._lock:
            self.events_checked += 1
            if self._consumer_ended:
                self._fail('batch delivered after the stream END frame')
            if seq is not None:
                if seq in self._delivered:
                    self._fail('batch seq {} delivered twice — the ring '
                               'delivered a slot twice to this consumer'
                               .format(seq))
                self._delivered.add(seq)

    def on_consumer_end(self):
        with self._lock:
            self.events_checked += 1
            if self._consumer_ended:
                self._fail('stream END delivered twice to this consumer')
            self._consumer_ended = True


class ElasticMonitor(object):
    """Runtime conformance monitor for the elastic resharding protocol
    (``docs/parallelism.md`` "Elastic pod sharding"; spec in
    ``analysis/protocol/elastic_spec.py``). Each host checks its observable
    projection of the pod-wide protocol:

    * the generation number is strictly monotonic (``on_reshard``);
    * no row group is claimed after it was committed, and no row group is
      claimed while another host's un-expired lease pins it in flight;
    * no row group is committed twice, and every commit follows a claim by
      the committing host (a commit without a claim is the signature of a
      lease being honored after it was handed off);
    * a lease expiry releases the departed host's claims for adoption;
      a (re)join clears its expired status.

    Violations raise :class:`~petastorm_tpu_torch.errors.ProtocolViolation`.
    """

    def __init__(self, name='elastic'):
        self._name = name
        self._lock = threading.Lock()
        self._generation = 0
        self._claims = {}       # item -> claiming host
        self._delivered = set()
        self._expired = set()
        self.events_checked = 0

    def _fail(self, message):
        raise ProtocolViolation('[elastic monitor: {}] {}'.format(self._name,
                                                                  message))

    def on_join(self, host):
        with self._lock:
            self.events_checked += 1
            self._expired.discard(host)

    def on_lease_expire(self, host):
        with self._lock:
            self.events_checked += 1
            self._expired.add(host)
            # the departed host's claims become adoptable exactly now
            for item, holder in list(self._claims.items()):
                if holder == host:
                    del self._claims[item]

    def on_reshard(self, generation, members=()):
        with self._lock:
            self.events_checked += 1
            if generation <= self._generation:
                self._fail('generation regressed: {} -> {} — shard maps '
                           'must advance monotonically or two hosts can '
                           'disagree about ownership forever'
                           .format(self._generation, generation))
            self._generation = generation

    def on_claim(self, host, item):
        with self._lock:
            self.events_checked += 1
            if item in self._delivered:
                self._fail('host {} claimed row group {!r} which was already '
                           'committed — re-reading it would deliver the '
                           'group twice'.format(host, item))
            holder = self._claims.get(item)
            if holder is not None and holder != host:
                self._fail('host {} claimed row group {!r} while host {} '
                           'still holds it under a live lease — in-flight '
                           'groups move only after lease expiry'
                           .format(host, item, holder))
            self._claims[item] = host

    def on_deliver(self, host, item):
        with self._lock:
            self.events_checked += 1
            if item in self._delivered:
                self._fail('row group {!r} committed twice (second commit by '
                           'host {})'.format(item, host))
            holder = self._claims.pop(item, None)
            if holder is None:
                self._fail('host {} committed row group {!r} without a live '
                           'claim — its lease was already handed off'
                           .format(host, item))
            if holder != host:
                self._fail('host {} committed row group {!r} claimed by host '
                           '{}'.format(host, item, holder))
            self._delivered.add(item)

    @property
    def snapshot(self):
        with self._lock:
            return {'generation': self._generation,
                    'claims': dict(self._claims),
                    'delivered': len(self._delivered),
                    'expired': sorted(self._expired),
                    'events_checked': self.events_checked}


class FabricMonitor(object):
    """Runtime conformance monitor for the chunk-fabric transfer protocol
    (``docs/fabric.md``; spec in ``analysis/protocol/fabric_spec.py``). Each
    fetching process checks its observable projection:

    * a request is only ever issued to a peer whose breaker admitted it
      (``on_request`` with ``allowed=False`` is the violation — a breaker
      that opened mid-flight on an already-issued request is NOT one, which
      is why the client reports the admission decision, not the later state);
    * bytes are only populated into the mirror after verification
      (``on_populate`` with ``verified=False``), and a chunk is populated at
      most once per process between invalidations (``on_invalidate`` is how
      an eviction legitimately re-opens a chunk for population);
    * every fetch resolves through exactly one of the spec's terminal
      outcomes: ``peer``, ``fallback``, or ``error`` (``on_outcome``).

    Violations raise :class:`~petastorm_tpu_torch.errors.ProtocolViolation`.
    """

    _OUTCOMES = ('peer', 'fallback', 'error')

    def __init__(self, name='fabric'):
        self._name = name
        self._lock = threading.Lock()
        self._populated = set()     # digests currently mirrored (our view)
        self.events_checked = 0

    def _fail(self, message):
        raise ProtocolViolation('[fabric monitor: {}] {}'.format(self._name,
                                                                 message))

    def on_request(self, peer, allowed):
        with self._lock:
            self.events_checked += 1
            if not allowed:
                self._fail('request issued to peer {} whose circuit breaker '
                           'is open — an open breaker must shed load, not '
                           'shape it'.format(peer))

    def on_populate(self, digest, verified):
        with self._lock:
            self.events_checked += 1
            if not verified:
                self._fail('unverified bytes for chunk {} reached the mirror '
                           '— bytes that fail the content hash must be '
                           'discarded'.format(digest))
            if digest in self._populated:
                self._fail('chunk {} populated twice without an intervening '
                           'invalidation — population must be exactly-once '
                           'per host'.format(digest))
            self._populated.add(digest)

    def on_invalidate(self, digest):
        """The mirror for ``digest`` was evicted: population is legal again."""
        with self._lock:
            self.events_checked += 1
            self._populated.discard(digest)

    def on_outcome(self, key, outcome):
        with self._lock:
            self.events_checked += 1
            if outcome not in self._OUTCOMES:
                self._fail('fetch of {!r} resolved with unknown outcome {!r} '
                           '(must be one of {})'.format(key, outcome,
                                                        self._OUTCOMES))

    @property
    def snapshot(self):
        with self._lock:
            return {'populated': len(self._populated),
                    'events_checked': self.events_checked}


def fabric_monitor_from_env(explicit, name):
    """Resolve a fabric ``monitor`` argument exactly like
    :func:`monitor_from_env`, honoring ``PSTPU_FABRIC_MONITOR`` (with
    ``PSTPU_PROTOCOL_MONITOR`` as the umbrella opt-in)."""
    import os
    if explicit is None:
        env = os.environ.get('PSTPU_FABRIC_MONITOR',
                             os.environ.get('PSTPU_PROTOCOL_MONITOR', ''))
        explicit = env not in ('', '0')
    if not explicit:
        return None
    if isinstance(explicit, FabricMonitor):
        return explicit
    return FabricMonitor(name=name)


def elastic_monitor_from_env(explicit, name):
    """Resolve an elastic ``monitor`` argument exactly like
    :func:`monitor_from_env`, honoring ``PSTPU_ELASTIC_MONITOR`` (with
    ``PSTPU_PROTOCOL_MONITOR`` as the umbrella opt-in)."""
    import os
    if explicit is None:
        env = os.environ.get('PSTPU_ELASTIC_MONITOR',
                             os.environ.get('PSTPU_PROTOCOL_MONITOR', ''))
        explicit = env not in ('', '0')
    if not explicit:
        return None
    if isinstance(explicit, ElasticMonitor):
        return explicit
    return ElasticMonitor(name=name)


def serve_monitor_from_env(explicit, name):
    """Resolve a serve-side ``monitor`` argument exactly like
    :func:`monitor_from_env`, honoring ``PSTPU_SERVE_MONITOR`` (with
    ``PSTPU_PROTOCOL_MONITOR`` as the umbrella opt-in)."""
    import os
    if explicit is None:
        env = os.environ.get('PSTPU_SERVE_MONITOR',
                             os.environ.get('PSTPU_PROTOCOL_MONITOR', ''))
        explicit = env not in ('', '0')
    if not explicit:
        return None
    if isinstance(explicit, ServeMonitor):
        return explicit
    return ServeMonitor(name=name)


def monitor_from_env(explicit, name):
    """Resolve a pool's ``protocol_monitor`` constructor argument: a
    :class:`ProtocolMonitor` instance is used as-is, truthy builds a fresh
    one, ``None`` consults ``PSTPU_PROTOCOL_MONITOR`` (the process-wide
    opt-in used by the fault-tolerance suite and the bench ``--protocol-
    monitor`` flags), falsy disables."""
    import os
    if explicit is None:
        explicit = os.environ.get('PSTPU_PROTOCOL_MONITOR', '') not in ('', '0')
    if not explicit:
        return None
    if isinstance(explicit, ProtocolMonitor):
        return explicit
    return ProtocolMonitor(name=name)


__all__ = ['ElasticMonitor', 'FabricMonitor', 'ProtocolMonitor',
           'ProtocolViolation', 'ServeMonitor', 'elastic_monitor_from_env',
           'fabric_monitor_from_env', 'monitor_from_env',
           'serve_monitor_from_env']
