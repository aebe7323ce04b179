"""The per-host shared reader service, daemon side: decode once, serve many.

Twin of ``petastorm_tpu/serve/service.py``. One :class:`ReaderService` per
host owns one worker fleet (a pool of
:class:`~petastorm_tpu_torch.serve.worker.MultiplexWorker`) and one
:class:`~petastorm_tpu_torch.workers.ventilator.FairShareVentilator`, and
serves decoded batches to many local consumer processes over per-stream
broadcast rings (:class:`~petastorm_tpu_torch.native.shm_ring.BcastRing`):

* a **stream** is a distinct dataset and decode configuration; its id is
  the hash of the canonical spec (:func:`canonical_stream_id`). All the
  consumers of one stream share one decode: the pump publishes each batch
  once and the ring fans it out.
* a **tenant** is one attached consumer. Admission control and weighted
  fair share live in the ventilator (per-stream in-flight budgets,
  starvation-free weighted round-robin); a tenant's weight joins its
  stream's share.
* **eviction**: a consumer lagging far enough to stall the others is
  evicted from its ring slot with a loud log; the others keep flowing and
  the evictee's next read raises
  :class:`~petastorm_tpu_torch.errors.ConsumerEvictedError`.
* a stream over a remote store read with ``chunk_cache`` mirrors each
  chunk once for every tenant; :meth:`ReaderService.stats` shows the
  cache's counters per stream.
* the control plane is a ``multiprocessing.connection`` AF_UNIX listener in
  the service directory; the spawn handshake and the client live in
  ``serve/client.py``.

Every admit, evict and detach runs inside a span carrying the tenant id, so
a long-lived daemon's decisions can be read back from its trace ring. The
opt-in protocol monitor (``monitor=``, ``PSTPU_SERVE_MONITOR`` or the
umbrella ``PSTPU_PROTOCOL_MONITOR``) checks the daemon's side of the serve
fan-out protocol (``analysis/protocol/serve_spec.py``): each attach, detach,
eviction, publish and stream end, raising
:class:`~petastorm_tpu_torch.errors.ProtocolViolation` on a sequence the
spec rejects.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import tempfile
import threading
import time

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.chunkstore import cache_diagnostics
from petastorm_tpu_torch.errors import EmptyResultError, ServeError
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.serve.worker import (DEFAULT_SERVE_BLOB_THRESHOLD, BlobRef,
                                              FusedBlobRef, MultiplexWorker,
                                              remove_stream_spec, write_stream_spec)
from petastorm_tpu_torch.workers.protocol import (SERVE_BLOB, SERVE_COLS, SERVE_DATA,
                                                  SERVE_DONE, SERVE_END, SERVE_ERROR,
                                                  ring_header)
from petastorm_tpu_torch.workers.ventilator import FairShareVentilator

logger = logging.getLogger(__name__)

#: default per-stream broadcast ring capacity
DEFAULT_SERVE_RING_BYTES = 64 << 20
#: a blocked broadcast publish evicts the slowest consumer after this long
DEFAULT_EVICT_BLOCK_S = 10.0
#: the daemon exits after this long with no attached tenant
DEFAULT_IDLE_TIMEOUT_S = 60.0
#: per-stream (per ventilator tenant) in-flight row-group budget
DEFAULT_STREAM_IN_FLIGHT = 3
#: bound on a stream's blob bytes not yet consumed by every consumer: the
#: blob plane's backpressure, as the ring capacity is the ring's
DEFAULT_BLOB_BUDGET_BYTES = 256 << 20
#: a blob stays on disk this long after the last cursor passed its frame,
#: covering a consumer's window between reading the path and mapping it
DEFAULT_BLOB_GC_GRACE_S = 1.0

ENDPOINT_FILE = 'endpoint.json'
LOCK_FILE = 'daemon.lock'


def canonical_stream_id(spec):
    """Stable id of a stream spec: consumers sending byte-identical
    canonical specs share one decode pipeline."""
    blob = pickle.dumps([(k, spec[k]) for k in sorted(spec)], protocol=pickle.HIGHEST_PROTOCOL)
    return hashlib.sha256(blob).hexdigest()[:16]


def endpoint_path(service_dir):
    return os.path.join(service_dir, ENDPOINT_FILE)


def read_endpoint(service_dir):
    """``{'address', 'pid'}`` of the published daemon, or None."""
    try:
        with open(endpoint_path(service_dir)) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get('address') and doc.get('pid'):
            return doc
    except (OSError, ValueError):
        pass
    return None


class _Tenant(object):
    __slots__ = ('tenant_id', 'stream_id', 'token', 'weight', 'batches', 'bytes',
                 'shared_hits', 'evicted', 'joined_shared')

    def __init__(self, tenant_id, stream_id, token, weight, joined_shared):
        self.tenant_id = tenant_id
        self.stream_id = stream_id
        self.token = token
        self.weight = weight
        self.batches = 0
        self.bytes = 0
        self.shared_hits = 0
        self.evicted = False
        self.joined_shared = joined_shared  # attached to a stream already running

    def stats(self):
        return {'stream_id': self.stream_id, 'weight': self.weight,
                'batches_served': self.batches, 'bytes_served': self.bytes,
                'shared_decode_hits': self.shared_hits,
                'evicted': self.evicted, 'joined_shared': self.joined_shared}


class _Stream(object):
    __slots__ = ('stream_id', 'spec', 'plan', 'ring', 'ring_name', 'tenants', 'finished',
                 'errored', 'write_lock', 'decoded_batches', 'blocked_since', 'blobs',
                 'blob_outstanding')

    def __init__(self, stream_id, spec, plan, ring, ring_name):
        self.stream_id = stream_id
        self.spec = spec
        self.plan = plan
        self.ring = ring
        self.ring_name = ring_name
        self.tenants = {}       # tenant_id -> _Tenant
        self.finished = False
        self.errored = False
        # serializes the producer-side ring calls (the pump's writes against
        # the control plane's joins): a join never races a write burst
        self.write_lock = threading.Lock()
        self.decoded_batches = 0
        self.blocked_since = None
        # the blob ledger: [frame_end_pos, path, size, eligible_at] in publish
        # order (the pump appends; the GC pops from the front)
        self.blobs = []
        self.blob_outstanding = 0


class ReaderService(object):
    """The broker, pump and control plane of one serve daemon. Create, then
    :meth:`start`; :meth:`serve_forever` blocks until the idle timeout or a
    shutdown."""

    def __init__(self, service_dir, pool_type='thread', workers_count=4,
                 ring_bytes=DEFAULT_SERVE_RING_BYTES,
                 evict_block_s=DEFAULT_EVICT_BLOCK_S,
                 idle_timeout_s=DEFAULT_IDLE_TIMEOUT_S,
                 stream_in_flight=DEFAULT_STREAM_IN_FLIGHT,
                 blob_threshold_bytes=DEFAULT_SERVE_BLOB_THRESHOLD,
                 blob_budget_bytes=DEFAULT_BLOB_BUDGET_BYTES,
                 blob_gc_grace_s=DEFAULT_BLOB_GC_GRACE_S,
                 monitor=None, telemetry=None):
        from petastorm_tpu_torch.analysis.protocol.monitor import serve_monitor_from_env
        #: the daemon side's serve monitor, or None
        self.monitor = serve_monitor_from_env(monitor, 'serve-daemon')
        self.service_dir = os.path.abspath(service_dir)
        # applied at start(): 'spans' makes served batches traceable end to
        # end (the client fetches the daemon's half with the 'trace' op)
        self._telemetry = telemetry
        self._pool_type = pool_type
        self._workers_count = workers_count
        self._ring_bytes = ring_bytes
        self._evict_block_s = evict_block_s
        self._idle_timeout_s = idle_timeout_s
        self._stream_in_flight = stream_in_flight
        self._blob_threshold = blob_threshold_bytes
        self._blob_budget = blob_budget_bytes
        self._blob_grace_s = blob_gc_grace_s
        self._blob_dir = None
        self._serializer = NumpyBlockSerializer()
        self._lock = threading.RLock()
        self._streams = {}          # stream_id -> _Stream (the live generation)
        self._retired_streams = []  # finished streams with consumers still attached
        self._tenants = {}          # tenant_id -> _Tenant
        self._next_tenant = 0
        # ring names are unique per generation: a retired generation's ring
        # may still be linked when a fresh one of the same spec is created
        self._ring_generation = 0
        self._idle_since = time.monotonic()
        self._shutdown = threading.Event()
        # a second shutdown caller (the daemon's main thread after
        # serve_forever) returns only once the first finished its teardown,
        # so the process never exits mid-teardown with its blob dir on disk
        self._teardown_lock = threading.Lock()
        self._closed = threading.Event()
        self._listener = None
        self._threads = []
        self._evictions = 0
        self._pool = None
        self._ventilator = None
        self._pump_thread = None
        self._address = os.path.join(self.service_dir, 'ctrl.sock')

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        os.makedirs(os.path.join(self.service_dir, 'streams'), exist_ok=True)
        obs.configure(self._telemetry)  # None keeps the process's level
        # before the pool starts, so the flight file carries the daemon's
        # label (the recorder is a per-process singleton named by its first
        # caller)
        flight = blackbox.maybe_enable('serve-daemon')
        if flight is not None:
            flight.register_lock('serve.state_lock', self._lock)
            flight.watch('serve_published',
                         lambda: obs.get_registry().value('serve_batches_published_total'))
        from petastorm_tpu_torch.reader import _make_pool
        # a poison item is quarantined (loud, counted) instead of ending every
        # tenant's stream
        self._pool = _make_pool(self._pool_type, self._workers_count,
                                results_queue_size=max(16, 4 * self._workers_count),
                                on_error='skip')
        self._ventilator = FairShareVentilator(self._pool.ventilate,
                                               on_tenant_done=self._on_stream_done)
        # what a hard-killed daemon left: its broadcast rings (only the owner
        # unlinks them; a consumer still attached keeps its mapping) and its
        # blob dir, which has the process pool's naming
        if os.path.isdir('/dev/shm'):
            from petastorm_tpu_torch.workers.process_pool import _sweep_dead_owner_entries
            _sweep_dead_owner_entries('/dev/shm', 'pstpu_bc_', require_pid=True)
        if self._blob_threshold and os.path.isdir('/dev/shm'):
            from petastorm_tpu_torch.workers.process_pool import _sweep_stale_blob_dirs
            _sweep_stale_blob_dirs('/dev/shm')
            try:
                self._blob_dir = tempfile.mkdtemp(
                    prefix='pstpu_blobs_{}_'.format(os.getpid()), dir='/dev/shm')
            except OSError:
                self._blob_dir = None
        worker_args = {'service_dir': self.service_dir,
                       'blob_dir': self._blob_dir,
                       'blob_threshold': self._blob_threshold,
                       'telemetry': obs.configure(None)}
        self._pool.start(MultiplexWorker, worker_args, ventilator=self._ventilator)
        self._start_listener()
        self._pump_thread = self._start_thread(self._pump_loop, 'pstpu-torch-serve-pump')
        self._start_thread(self._housekeeping_loop, 'pstpu-torch-serve-housekeeping')
        logger.info('serve daemon up: dir=%s pool=%s x%d', self.service_dir,
                    self._pool_type, self._workers_count)

    def _start_thread(self, target, name, args=()):
        t = threading.Thread(target=target, args=args, daemon=True, name=name)
        t.start()
        self._threads.append(t)
        return t

    def _start_listener(self):
        from multiprocessing.connection import Listener
        try:
            os.unlink(self._address)
        except OSError:
            pass
        self._listener = Listener(self._address, family='AF_UNIX')
        tmp = endpoint_path(self.service_dir) + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'address': self._address, 'pid': os.getpid()}, f)
        os.replace(tmp, endpoint_path(self.service_dir))
        self._start_thread(self._accept_loop, 'pstpu-torch-serve-accept')

    def serve_forever(self):
        """Block until shutdown (the idle timeout, the shutdown op, or a
        fatal error)."""
        self._shutdown.wait()

    def shutdown(self):
        with self._teardown_lock:
            first = not self._shutdown.is_set()
            self._shutdown.set()
        if first:
            try:
                self._teardown()
            finally:
                self._closed.set()
        else:
            self._closed.wait(timeout=60)

    def _teardown(self):
        logger.info('serve daemon shutting down')
        if self._ventilator is not None:
            self._ventilator.stop()   # the pump drains to EmptyResultError and exits
        if self._listener is not None:
            from multiprocessing.connection import Client
            try:
                # closing a listening socket does not wake a blocked accept():
                # one connection does, and the loop then sees the flag
                Client(self._address, family='AF_UNIX').close()
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # the pump leaves the ring write path before the rings close (a
        # blocked publish gives up on the shutdown flag)
        if self._pump_thread is not None and self._pump_thread is not threading.current_thread():
            self._pump_thread.join(timeout=15)
        with self._lock:
            streams = list(self._streams.values()) + list(self._retired_streams)
            self._streams = {}
            self._retired_streams = []
        for stream in streams:
            self._broadcast_error(stream, ServeError('serve daemon shut down'))
            self._gc_blobs(stream, drop_all=True)
            with stream.write_lock:
                stream.ring.close()
            remove_stream_spec(self.service_dir, stream.stream_id)
        if self._pool is not None:
            self._pool.stop()
            self._pool.join()
        if self._blob_dir is not None:
            shutil.rmtree(self._blob_dir, ignore_errors=True)
            self._blob_dir = None
        for name in (ENDPOINT_FILE, LOCK_FILE):
            try:
                os.unlink(os.path.join(self.service_dir, name))
            except OSError:
                pass
        # the control threads end on the shutdown flag and closed connections
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    # -- control plane -----------------------------------------------------------

    def _accept_loop(self):
        while not self._shutdown.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._shutdown.is_set():
                    return
                continue
            self._start_thread(self._client_loop, 'pstpu-torch-serve-client', (conn,))

    def _client_loop(self, conn):
        owned = []  # tenant ids attached over this connection
        try:
            while not self._shutdown.is_set():
                # poll, so the thread sees a shutdown with a client still
                # connected
                try:
                    if not conn.poll(0.25):
                        continue
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                try:
                    reply = self._dispatch(msg, owned)
                except Exception as e:  # noqa: BLE001 - a bad request must not kill the daemon
                    logger.exception('serve control request failed')
                    reply = {'ok': False, 'error': '{}: {}'.format(type(e).__name__, e)}
                try:
                    conn.send(reply)
                except (OSError, ValueError, pickle.PicklingError):
                    break
        finally:
            # a client gone without a detach still releases its slots
            for tenant_id in owned:
                self.detach(tenant_id)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, msg, owned):
        op = msg.get('op')
        if op == 'ping':
            return {'ok': True, 'pid': os.getpid()}
        if op == 'attach':
            reply = self.attach(msg['spec'], weight=msg.get('weight', 1))
            if reply.get('ok'):
                owned.append(reply['tenant_id'])
            return reply
        if op == 'detach':
            tenant_id = msg.get('tenant_id')
            if tenant_id in owned:
                owned.remove(tenant_id)
            return {'ok': self.detach(tenant_id)}
        if op == 'stats':
            return {'ok': True, 'stats': self.stats()}
        if op == 'trace':
            # a snapshot, not a drain: many tenants may ask, and a drain would
            # hand each a disjoint slice of the ring
            return {'ok': True, 'events': obs.get_ring().snapshot()}
        if op == 'shutdown':
            threading.Thread(target=self.shutdown, daemon=True,
                             name='pstpu-torch-serve-shutdown').start()
            return {'ok': True}
        return {'ok': False, 'error': 'unknown op {!r}'.format(op)}

    # -- broker --------------------------------------------------------------------

    def attach(self, spec, weight=1):
        """Admit one tenant: find or create its stream, grant a ring slot,
        register its weight with the fair-share scheduler."""
        stream_id = canonical_stream_id(spec)
        with self._lock:
            stream = self._streams.get(stream_id)
            if stream is not None and (stream.finished or stream.errored):
                # a finished generation cannot be joined: retire it (its
                # consumers drain and detach on their own) and start afresh
                self._retired_streams.append(stream)
                self._streams.pop(stream_id, None)
                stream = None
            fresh = stream is None
            if fresh:
                stream = self._create_stream(stream_id, spec)
            tenant_id = 't{}'.format(self._next_tenant)
            self._next_tenant += 1
            with obs.span('serve.admit', cat='serve', tenant=tenant_id, stream=stream_id):
                with stream.write_lock:
                    token = stream.ring.join()  # noqa: PT1303 - bcast-ring consumer-slot grant: a nonblocking C call, not a thread join
                tenant = _Tenant(tenant_id, stream_id, token, weight, joined_shared=not fresh)
                stream.tenants[tenant_id] = tenant
                self._tenants[tenant_id] = tenant
                self._idle_since = None
                if fresh:
                    self._ventilator.add_tenant(
                        stream_id,
                        [dict(item, stream_id=stream_id) for item in stream.plan.items],
                        iterations=stream.plan.num_epochs,
                        weight=self._stream_weight(stream),
                        max_in_flight=self._stream_in_flight,
                        shuffle=stream.plan.shuffle_row_groups,
                        seed=stream.plan.seed)
                else:
                    self._retune_stream_weight(stream)
            if self.monitor is not None:
                self.monitor.on_attach(tenant_id, stream_id)
        obs.count('serve_tenants_attached_total')
        logger.info('serve: tenant %s attached to stream %s (%s, weight %d, shared=%s)',
                    tenant_id, stream_id, spec.get('dataset_url'), weight, not fresh)
        return {'ok': True, 'tenant_id': tenant_id, 'stream_id': stream_id,
                'ring_name': stream.ring_name, 'token': token,
                'daemon_pid': os.getpid(),
                # the broker's trace namespace: a client derives each frame's
                # trace root from the seq already in the ring header
                'trace_ns': self._ventilator.trace_ns,
                'client_plan': stream.plan.client_plan()}

    def _create_stream(self, stream_id, spec):
        from petastorm_tpu_torch.native.shm_ring import BcastRing
        from petastorm_tpu_torch.serve.plan import build_read_plan
        plan = build_read_plan(**spec)
        write_stream_spec(self.service_dir, stream_id, plan.worker_class,
                          dict(plan.worker_args, telemetry=obs.configure(None)))
        self._ring_generation += 1
        ring_name = '/pstpu_bc_{}_{}g{}'.format(os.getpid(), stream_id[:8],
                                                self._ring_generation)
        ring = BcastRing.create(ring_name, self._ring_bytes)
        stream = _Stream(stream_id, spec, plan, ring, ring_name)
        self._streams[stream_id] = stream
        obs.count('serve_streams_created_total')
        return stream

    def _stream_weight(self, stream):
        return sum(t.weight for t in stream.tenants.values()) or 1

    def _retune_stream_weight(self, stream):
        """A stream's share is its tenants' summed weight; retuned on attach
        and detach (from the scheduler's next credit refill)."""
        self._ventilator.set_tenant_weight(stream.stream_id, self._stream_weight(stream))

    def detach(self, tenant_id):
        """Release one tenant's ring slot. The stream keeps flowing for the
        others; a stream with no tenant left stops being scheduled."""
        with self._lock:
            tenant = self._tenants.pop(tenant_id, None)
            if tenant is None:
                return False
            stream = self._find_stream(tenant.stream_id)
            with obs.span('serve.detach', cat='serve', tenant=tenant_id,
                          stream=tenant.stream_id):
                if stream is not None:
                    stream.tenants.pop(tenant_id, None)
                    with stream.write_lock:
                        stream.ring.leave(tenant.token)
                    self._finish_stream_if_abandoned(stream)
            if not self._tenants:
                self._idle_since = time.monotonic()
            if self.monitor is not None:
                self.monitor.on_detach(tenant_id)
        obs.count('serve_tenants_detached_total')
        logger.info('serve: tenant %s detached from stream %s', tenant_id, tenant.stream_id)
        return True

    def _find_stream(self, stream_id):
        with self._lock:  # an RLock: callers that hold it nest freely
            stream = self._streams.get(stream_id)
            if stream is not None:
                return stream
            for s in self._retired_streams:
                if s.stream_id == stream_id:
                    return s
            return None

    def _finish_stream_if_abandoned(self, stream):
        """Under the lock: reclaim a stream nobody is attached to."""
        if stream.tenants:
            self._retune_stream_weight(stream)
            return
        with obs.span('serve.reclaim', cat='serve', tenant=stream.stream_id):
            self._ventilator.remove_tenant(stream.stream_id)
            self._streams.pop(stream.stream_id, None)
            if stream in self._retired_streams:
                self._retired_streams.remove(stream)
            self._gc_blobs(stream, drop_all=True)
            with stream.write_lock:
                # under the write lock: the pump's publish loop either saw
                # consumer_count() == 0 and dropped its frame, or will on the
                # closed handle; never a ring call on freed memory
                stream.ring.close()
            remove_stream_spec(self.service_dir, stream.stream_id)
        logger.info('serve: stream %s reclaimed (no tenants left)', stream.stream_id)

    # -- the pump: the pool's results -> the per-stream broadcast rings ----------

    def _pump_loop(self):
        pool = self._pool
        pool.done_callback = self._forward_done
        try:
            while not self._shutdown.is_set():
                try:
                    payload = pool.get_results()
                except EmptyResultError:
                    return  # the ventilator stopped (shutdown) and the fleet drained
                seq = pool.last_result_seq
                stream_id = self._ventilator.tenant_of_seq(seq)
                stream = self._find_stream(stream_id) if stream_id is not None else None
                if stream is None:
                    if isinstance(payload, (BlobRef, FusedBlobRef)):
                        try:
                            os.unlink(payload.path)
                        except OSError:
                            pass
                    obs.count('serve_orphan_batches_total')
                    continue  # the stream was abandoned while its batch was in flight
                if isinstance(payload, FusedBlobRef):
                    # the fused decode wrote the batch into the shared blob:
                    # only its column layout crosses the ring
                    self._publish(stream, SERVE_COLS, seq,
                                  pickle.dumps({'path': payload.path, 'size': payload.size,
                                                'rows': payload.rows, 'cols': payload.cols},
                                               protocol=pickle.HIGHEST_PROTOCOL),
                                  raw=True, blob=payload)
                elif isinstance(payload, BlobRef):
                    # the batch sits in shared memory after one worker-side
                    # copy: only the path crosses the ring
                    self._publish(stream, SERVE_BLOB, seq,
                                  '{}|{}'.format(payload.size, payload.path).encode(),
                                  raw=True, blob=payload)
                else:
                    self._publish(stream, SERVE_DATA, seq, payload)
        except Exception as e:  # noqa: BLE001 - the pump dying must fail loudly everywhere
            logger.exception('serve pump failed; shutting the daemon down')
            with self._lock:
                streams = list(self._streams.values())
            for stream in streams:
                self._broadcast_error(stream, e)
            threading.Thread(target=self.shutdown, daemon=True,
                             name='pstpu-torch-serve-shutdown').start()

    def _forward_done(self, seq):
        """The pool's completion of a delivered item -> a SERVE_DONE frame
        on its stream (runs on the pump thread, inside get_results)."""
        stream_id = self._ventilator.tenant_of_seq(seq)
        stream = self._find_stream(stream_id) if stream_id is not None else None
        if stream is not None:
            self._publish(stream, SERVE_DONE, seq, None)

    def _on_stream_done(self, stream_id):
        """FairShareVentilator: every epoch of the stream completed."""
        stream = self._find_stream(stream_id)
        if stream is None:
            return
        stream.finished = True
        self._publish(stream, SERVE_END, None, None)
        if self.monitor is not None:
            self.monitor.on_end(stream_id)
        logger.info('serve: stream %s finished all epochs', stream_id)

    def _broadcast_error(self, stream, exc):
        stream.errored = True
        try:
            self._publish(stream, SERVE_ERROR, None,
                          pickle.dumps(exc, protocol=pickle.HIGHEST_PROTOCOL), raw=True)
        except Exception:  # noqa: BLE001 - last resort; the clients' pid check covers the rest
            logger.debug('error broadcast to stream %s failed', stream.stream_id)

    def _publish(self, stream, kind, seq, payload, raw=False, blob=None):
        """Broadcast one frame. When the write stays blocked (the ring full,
        or the blob plane over its byte budget) past ``evict_block_s``, the
        slowest consumer is evicted rather than stalling the others."""
        from petastorm_tpu_torch.native.shm_ring import IdleWait
        header = ring_header(kind, seq)
        if payload is None:
            parts = [header]
        elif raw:
            parts = [header, payload]
        else:
            body = self._serializer.serialize_parts(payload)
            if body is None:
                parts = [header, self._serializer.serialize(payload)]
            else:
                parts = [header] + body
        idle = IdleWait()
        while True:
            # the lock order is service._lock -> stream.write_lock: no
            # accounting (which takes service._lock) under write_lock
            written = False
            blocked_on_blobs = False
            with stream.write_lock:
                if stream.ring.consumer_count() == 0:
                    # nobody to deliver to (all evicted or detached): drop the
                    # frame instead of spinning on a min head of tail
                    stream.blocked_since = None
                    if blob is not None:
                        try:
                            os.unlink(blob.path)
                        except OSError:
                            pass
                    return
                if blob is not None and stream.blob_outstanding > self._blob_budget:
                    blocked_on_blobs = True  # backpressure: the consumers catch up first
                else:
                    try:
                        written = stream.ring.try_writev(parts)
                    except ValueError:
                        logger.error('serve: frame larger than the broadcast ring; dropping '
                                     '(raise serve ring_bytes)')
                        return
                if written and blob is not None:
                    # keyed on the producer position after the write: the blob
                    # is reclaimable once every attached cursor passed it
                    # (min_head >= end), plus the grace
                    stream.blobs.append([stream.ring.tail(), blob.path, blob.size, None])
                    stream.blob_outstanding += blob.size
            if written:
                stream.blocked_since = None
                if kind in (SERVE_DATA, SERVE_BLOB, SERVE_COLS):
                    self._account_publish(stream, parts, blob=blob)
                    if self.monitor is not None:
                        self.monitor.on_publish(stream.stream_id, seq)
                return
            if self._shutdown.is_set():
                return  # teardown: one best-effort attempt, never a block
            self._gc_blobs(stream)
            now = time.monotonic()
            if stream.blocked_since is None:
                stream.blocked_since = now
            elif now - stream.blocked_since > self._evict_block_s:
                self._evict_slowest(stream)
                stream.blocked_since = now
            if blocked_on_blobs:
                time.sleep(0.002)
            else:
                idle.wait()

    def _gc_blobs(self, stream, drop_all=False):
        """Reclaim the blob files every consumer has read past (every blob,
        on teardown). Runs on the pump and housekeeping threads; the ledger
        is guarded by the stream's write lock."""
        now = time.monotonic()
        with stream.write_lock:
            if drop_all:
                doomed, stream.blobs = stream.blobs, []
                stream.blob_outstanding = 0
            else:
                min_head = stream.ring.min_head()
                doomed = []
                keep = []
                for entry in stream.blobs:
                    end, _path, size, eligible_at = entry
                    if end <= min_head:
                        if eligible_at is None:
                            entry[3] = now
                            stream.blob_outstanding -= size
                            keep.append(entry)
                        elif now - eligible_at >= self._blob_grace_s:
                            doomed.append(entry)
                        else:
                            keep.append(entry)
                    else:
                        keep.append(entry)
                stream.blobs = keep
        for _end, path, _size, _eligible in doomed:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _account_publish(self, stream, parts, blob=None):
        if blob is not None:
            nbytes = blob.size
        else:
            nbytes = sum(p.nbytes if isinstance(p, np.ndarray) else len(p) for p in parts)
        with self._lock:
            stream.decoded_batches += 1
            first = True
            for tenant in stream.tenants.values():
                tenant.batches += 1
                tenant.bytes += nbytes
                if not first:
                    # every consumer past the first rides a decode already
                    # paid for: this design's shared-cache hit
                    tenant.shared_hits += 1
                    obs.count('serve_shared_decode_hits_total')
                first = False
        obs.count('serve_batches_published_total')
        obs.count('serve_bytes_published_total', nbytes)

    def _evict_slowest(self, stream):
        """The slow-consumer policy: the tenant with the largest ring lag is
        evicted with a loud log; its next read raises ConsumerEvictedError."""
        with self._lock:
            laggards = sorted(((stream.ring.lag(t.token), t)
                               for t in stream.tenants.values() if not t.evicted),
                              key=lambda x: -x[0])
            if not laggards:
                return
            lag, tenant = laggards[0]
            with obs.span('serve.evict', cat='serve', tenant=tenant.tenant_id,
                          stream=stream.stream_id, lag_bytes=int(lag)):
                with stream.write_lock:
                    stream.ring.evict(tenant.token)
                tenant.evicted = True
            self._evictions += 1
            if self.monitor is not None:
                self.monitor.on_evict(tenant.tenant_id)
        obs.count('serve_evictions_total')
        logger.error(
            'serve: EVICTED tenant %s from stream %s (lag %d bytes blocked the others for '
            '%.1fs); the consumer will see ConsumerEvictedError. Consume faster, lower its '
            'weight, or raise serve ring_bytes', tenant.tenant_id, stream.stream_id, lag,
            self._evict_block_s)

    # -- housekeeping ----------------------------------------------------------------

    def _housekeeping_loop(self):
        while not self._shutdown.wait(0.25):
            with self._lock:
                idle_since = self._idle_since
                streams = list(self._streams.values()) + list(self._retired_streams)
            for stream in streams:
                self._gc_blobs(stream)
            if (idle_since is not None and self._idle_timeout_s is not None
                    and time.monotonic() - idle_since > self._idle_timeout_s):
                logger.info('serve daemon idle for %.0fs; exiting', self._idle_timeout_s)
                self.shutdown()
                return

    # -- observability -------------------------------------------------------------

    def stats(self):
        """The serving evidence per stream and tenant: fair-share occupancy,
        shared-decode hits, evictions, the pool's diagnostics and, for a
        stream read through a chunk cache, its ``chunk_cache_*`` counters
        (merged over every process that shares the cache's root)."""
        with self._lock:
            fsv = self._ventilator.tenant_stats() if self._ventilator else {}
            total_dispatched = sum(s['dispatched'] for s in fsv.values()) or 1
            streams = {}
            for stream in list(self._streams.values()) + list(self._retired_streams):
                sched = fsv.get(stream.stream_id, {})
                streams[stream.stream_id] = {
                    'dataset_url': stream.spec.get('dataset_url'),
                    'decoded_batches': stream.decoded_batches,
                    'finished': stream.finished,
                    'tenants': {tid: t.stats() for tid, t in stream.tenants.items()},
                    'fair_share': dict(sched, occupancy=round(
                        sched.get('dispatched', 0) / total_dispatched, 4)),
                    'ring_free_bytes': stream.ring.free_space(),
                    'ring_capacity': stream.ring.capacity,
                    'chunk_cache': (None if stream.plan.chunk_cache_config is None else
                                    cache_diagnostics(stream.plan.chunk_cache_config)),
                }
            return {
                'pid': os.getpid(),
                'pool': self._pool.diagnostics if self._pool else {},
                'streams': streams,
                'evictions': self._evictions,
                'tenants_attached': len(self._tenants),
            }


__all__ = ['DEFAULT_EVICT_BLOCK_S', 'DEFAULT_IDLE_TIMEOUT_S', 'DEFAULT_SERVE_RING_BYTES',
           'ReaderService', 'canonical_stream_id', 'endpoint_path', 'read_endpoint']
