"""Process pool: spawned worker processes, results over shm rings or zmq.

Trimmed twin of ``petastorm_tpu/workers/process_pool.py``. The consumer
process PUSHes work to the workers and PUBlishes control over zmq ``ipc://``
endpoints in a private temp dir; workers are started with ``spawn``, never
``fork`` (a forked child inherits locked mutexes and threads from Arrow and
CUDA). Results come back over:

* ``transport='shm'`` (the default when the ring library builds): one
  first-party shared-memory SPSC ring per worker (``native/shm_ring.cpp``),
  one memcpy in and one out. With ``zero_copy=True`` the consumer delivers
  data messages as numpy views straight into the ring slot, each view
  accounted by the lifetime ledger (``native/lifetime.py``), so the slot's
  bytes return to the producer only when the batch's arrays die. A worker
  whose publish function offers ``reserve_block`` lets the row worker decode
  a whole fused row group straight into a reserved slot (the in-place
  channel).
* ``transport='zmq'``: a PULL socket, the fallback when the ring library is
  unavailable or ``/dev/shm`` cannot hold the rings.
* payloads of ``blob_threshold_bytes`` or more ride a ``/dev/shm`` blob
  sidechannel on either transport: the worker writes the message into an
  mmapped tmpfs file and only its name crosses the transport; the consumer
  maps it copy-on-write.

Supervision: every ventilated item gets a dispatch id; a worker claims the
item it runs with a heartbeat on the results channel, and the consumer's
poll loop polls ``Process.exitcode``, so a dead worker is found within a
tick. On death the pool drains the dead worker's ring, respawns it on a
fresh ring and requeues exactly the item it owned under a new dispatch id
(stale messages of the old attempt are dropped), so each item completes
exactly once. Items that keep failing follow the ``on_error`` /
``max_item_retries`` policy (``workers/supervision.py``). When respawning a
slot keeps failing the slot is shed; only a pool with no slot left fails.

The ventilator's ``_seq`` tag stays in the consumer's record of an item,
which a requeue moves to the new dispatch id, so ``last_result_seq`` and
``done_callback`` (fired once, when a delivered item completes) serve
checkpoints exactly once across worker deaths, as in the other pools.

Each worker ships, after every item and in one ``MSG_METRICS`` frame, a
cumulative snapshot of its process's route counts (``native.read_routes``,
``codecs.image_routes``), its publishes per channel, its telemetry registry
and, at the ``'spans'`` level, its drained span events. The pool adds the
route counts' increase to the consumer's counters, keeps the latest registry
snapshot of every spawned process (:meth:`ProcessPool.telemetry_snapshots`;
keyed by spawn, so a respawned worker's fresh registry never double-counts
its predecessor's) and merges the span events into the consumer's ring. The
worker configures its telemetry level from the setup args and enables its
own flight recorder in the consumer's run directory.

The autotuner's worker knob: :meth:`ProcessPool.add_worker_slot` and
:meth:`ProcessPool.retire_worker_slot` only move the target worker count,
from any thread; the consumer thread's next :meth:`ProcessPool.get_results`
tick applies the requests, so every spawn and all slot bookkeeping stay on
that one thread (the JAX pool spawns on the caller's thread). A grow spawns a
supervised slot on a fresh ring; a retire asks one worker to exit after its
current item (``CONTROL_RETIRE``; the JAX pool terminates it), and the slot
then goes through the death path, which sheds it instead of respawning it. Its ring is closed through the borrow
ledger, so ring slots the loader still borrows outlive it. Items left in a
departed worker's dispatch pipe are found by the dispatch watermarks
(:meth:`ProcessPool._sweep_stranded_items`) and requeued, so every item is
still delivered once.

Supervision under test: an installed :class:`~petastorm_tpu_torch.faults.
FaultPlan` rides the setup args into every spawned worker, which marks
itself as one (kills and segfaults are honoured there) and calls
``faults.on_item`` before each item, inside its ``item`` stage. The opt-in
protocol monitor (``protocol_monitor=``, ``PSTPU_PROTOCOL_MONITOR``) sees
every dispatch, requeue (after an error, a death, or a sweep of a departed
worker's pipe), claim, data/done/error message with the live/stale decision
the pool took on it, completion, and the drain; its events are emitted under
``_state_lock`` where they must order with the accounting they describe
(the only nesting is ``_state_lock`` -> monitor lock).

The chunk fabric: an installed fabric node (``fabric.install``) ships its
fetch-only config (:meth:`~petastorm_tpu_torch.fabric.FabricConfig.
for_worker`) with the setup args, and each spawned worker installs a node
with no server and no lease, so its chunk misses ask pod peers first. An
install that fails is logged and the worker reads from the object store:
the fabric is an optimisation tier.

Scripts that create a pool at module level must guard that code with
``if __name__ == '__main__':``: spawned children re-import ``__main__``.
"""

from __future__ import annotations

import logging
import mmap
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import uuid

import zmq

from petastorm_tpu_torch import faults, observability as obs
from petastorm_tpu_torch.errors import (EmptyResultError, PoisonItemError,
                                        TimeoutWaitingForResultError, WorkerPoolDepletedError)
from petastorm_tpu_torch.native.lifetime import RingBorrowLedger
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.workers.protocol import (CONTROL_FINISHED, CONTROL_RETIRE, MSG_BLOB,
                                                  MSG_DATA,
                                                  MSG_DONE, MSG_ERROR, MSG_HEARTBEAT,
                                                  MSG_METRICS, MSG_STARTED, RING_HEADER_LEN,
                                                  DispatchIds, ring_header, ring_unpack)
from petastorm_tpu_torch.workers.supervision import (ErrorPolicy, attach_remote_context,
                                                     format_exception_tb, quarantine_record)

logger = logging.getLogger(__name__)

_WORKER_STARTUP_TIMEOUT_S = 30
_DEFAULT_RESULTS_HWM = 50
DEFAULT_RING_BYTES = 64 << 20
#: worker heartbeat period; a death shows in one supervise tick (<= 0.2 s)
_DEFAULT_HEARTBEAT_S = 0.5
#: wait after a death before requeueing its items: messages of the dead
#: worker still in transit land first, so an item that finished is not re-run
_REQUEUE_GRACE_S = 0.25
#: consecutive startup deaths (no item claimed) before a slot is shed
_MAX_RESPAWN_FAILURES = 3
#: payloads at least this large ride the /dev/shm blob sidechannel
DEFAULT_BLOB_THRESHOLD = 1 << 20
#: bound on the pool's unconsumed blob bytes (blobs are unlinked on read, so
#: the blob dir's size is the backlog); one blob over the budget still passes
_BLOB_BUDGET_BYTES = 256 << 20
#: age before a blob dir whose owner is gone may be reaped
_BLOB_SWEEP_GRACE_S = 600
#: consecutive blob allocation failures before a worker stops using blobs
_BLOB_DISABLE_AFTER = 3
#: the publish channels counted per worker and merged into ``diagnostics``
PUBLISH_CHANNELS = ('publish_inplace', 'publish_ring', 'publish_blob', 'publish_zmq')
#: ring framing of one message beyond its payload: 8-byte length prefix +
#: the protocol header
_RING_FRAMING = 8 + RING_HEADER_LEN


def _sweep_stale_blob_dirs(shm_root):
    """Reap ``pstpu_blobs_<pid>_*`` dirs whose owning process is gone and
    whose mtime is older than a grace period: blobs of a hard-killed run stay
    in tmpfs forever. Dirs without a parseable pid count as dead-owner but
    keep the grace. Best effort: an error skips that entry."""
    _sweep_dead_owner_entries(shm_root, 'pstpu_blobs_', require_pid=False)


def _sweep_dead_owner_entries(shm_root, prefix, require_pid):
    """Remove the ``<prefix><pid>_*`` entries of ``shm_root`` (dirs or files)
    whose owner pid is dead and whose mtime is older than
    :data:`_BLOB_SWEEP_GRACE_S`; never this process's. An entry without a
    parseable pid is kept when ``require_pid``, else counts as dead-owner."""
    try:
        entries = list(os.scandir(shm_root))
    except OSError:
        return
    now = time.time()
    for entry in entries:
        if not entry.name.startswith(prefix):
            continue
        try:
            owner_alive = require_pid
            parts = entry.name.split('_')
            # <= 10 digits: longer would overflow a C pid_t in os.kill
            if (len(parts) >= 3 and parts[2].isascii() and parts[2].isdigit()
                    and len(parts[2]) <= 10):
                pid = int(parts[2])
                if pid == os.getpid():
                    continue
                try:
                    os.kill(pid, 0)  # signal 0: existence probe only
                    owner_alive = True
                except ProcessLookupError:
                    owner_alive = False
                except PermissionError:
                    owner_alive = True  # exists, owned by someone else
            if not owner_alive and now - entry.stat().st_mtime >= _BLOB_SWEEP_GRACE_S:
                if entry.is_dir(follow_symlinks=False):
                    shutil.rmtree(entry.path, ignore_errors=True)
                else:
                    os.unlink(entry.path)
        except (OSError, OverflowError, ValueError):
            continue


def _read_blob(path):
    """Map a blob file copy-on-write and unlink it: ``(memoryview, slot)``.
    The views built over it keep the mapping alive; the name goes at once,
    so nothing leaks if deserializing fails. ``ACCESS_COPY`` gives writable
    views without an upfront copy, as the ring and zmq channels give writable
    buffers.

    :borrows: the returned view borrows the mapping; the caller adopts the
        deserialized arrays into ``slot`` and seals it, so the map closes
        (and counts in ``lifetime_live_borrows`` while alive) exactly when
        the batch dies."""
    with open(path, 'rb') as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    os.unlink(path)

    def _close():
        try:
            mm.close()
        except BufferError:
            pass  # a straggler export closes it when the GC drops the chain

    slot = lifetime_registry().open_slot(on_release=_close, label='pool-blob')
    return memoryview(mm), slot  # noqa: PT500 - registered with the lifetime registry


def _shm_free_bytes():
    """Free bytes of ``/dev/shm``, or None where it cannot be read."""
    try:
        st = os.statvfs('/dev/shm')
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


class ProcessPoolOptions(object):
    """A ``reader_pool_type`` value: the process pool, built with these
    further :class:`ProcessPool` arguments (``transport``, ``ring_bytes``,
    ``results_timeout_s``, ``blob_threshold_bytes``, ``heartbeat_interval_s``,
    ...). The reader factories set ``on_error``, ``protocol_monitor``,
    ``zero_copy`` and the serializer themselves."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __repr__(self):
        return 'ProcessPoolOptions({})'.format(
            ', '.join('{}={!r}'.format(k, v) for k, v in sorted(self.kwargs.items())))


class ProcessPool(object):
    """
    :param results_timeout_s: raise :class:`TimeoutWaitingForResultError`
        when no worker message arrives for this long (None: wait forever)
    :param transport: ``'shm'`` | ``'zmq'`` | None (shm when the ring
        library is available, else zmq)
    :param ring_bytes: per-worker ring capacity of the shm transport; one
        serialized row group must fit
    :param blob_threshold_bytes: payloads at least this large ride the
        ``/dev/shm`` blob sidechannel when the serializer splits payloads
        (``serialize_parts``); 0 disables it
    :param on_error/max_item_retries: the item-failure policy
    :param supervision: heartbeats and exitcode polling with respawn and
        requeue; off, a dead worker strands its items until the timeout
    :param heartbeat_interval_s: worker liveness beacon period
    :param protocol_monitor: opt-in runtime conformance checking of the
        supervision protocol: truthy attaches a fresh
        :class:`~petastorm_tpu_torch.analysis.protocol.monitor.ProtocolMonitor`,
        an instance is used as is, None honours ``PSTPU_PROTOCOL_MONITOR``
    :param zero_copy: shm transport only: deliver data messages as
        lifetime-tracked views into the ring slot instead of a copy each
    """

    def __init__(self, workers_count, results_queue_size=_DEFAULT_RESULTS_HWM, serializer=None,
                 results_timeout_s=None, transport=None, ring_bytes=DEFAULT_RING_BYTES,
                 blob_threshold_bytes=DEFAULT_BLOB_THRESHOLD, on_error='raise',
                 max_item_retries=None, supervision=True,
                 heartbeat_interval_s=_DEFAULT_HEARTBEAT_S, protocol_monitor=None,
                 zero_copy=False):
        from petastorm_tpu_torch.native.shm_ring import IdleWait
        from petastorm_tpu_torch.serializers import PickleSerializer

        self._workers_count = workers_count
        self._results_hwm = results_queue_size
        self._serializer = serializer or PickleSerializer()
        self._results_timeout_s = results_timeout_s
        if transport is None:
            from petastorm_tpu_torch.native import shm_ring
            transport = 'shm' if shm_ring.is_available() else 'zmq'
        if transport not in ('shm', 'zmq'):
            raise ValueError("transport must be 'shm', 'zmq' or None, got {!r}".format(transport))
        self._transport = transport
        self._ring_bytes = ring_bytes
        self._blob_threshold = blob_threshold_bytes
        self._zero_copy = bool(zero_copy) and transport == 'shm'
        self._ring_ledgers = {}     # id(ring) -> RingBorrowLedger (consumer side)
        self._policy = ErrorPolicy.resolve(on_error, max_item_retries)
        self._supervision = bool(supervision)
        self._heartbeat_interval_s = heartbeat_interval_s
        self._blob_dir = None
        self._rings = []            # per-slot ring (or None); index == worker_id
        self._retired_rings = []    # dead workers' rings, polled until drained
        self._context = None
        self._ventilator_send = self._control_send = self._results_receive = None
        self._processes = []        # per-slot Process (None = slot shed)
        self._ventilator = None
        self._ventilated_items = 0
        self._completed_items = 0
        self._stopped = False
        self._ipc_dir = None
        # the C ring is single-consumer: this lock serializes the poll loop
        # against join()'s drain
        self._ring_lock = threading.Lock()
        self._idle_wait = IdleWait()
        # item ownership and accounting, touched by the ventilator thread
        # (ventilate) and the consumer thread (get_results, supervise), and
        # the resize requests of the autotuner's thread; callbacks into the
        # ventilator run with it released
        self._state_lock = threading.Lock()
        self._dispatch_ids = DispatchIds()
        self._inflight = {}         # dispatch id -> item record
        self._orphans = {}          # dispatch id -> monotonic death time
        self._quarantined = []
        self._items_requeued = 0
        self._worker_restarts = 0
        # zmq sockets are not thread-safe: the ventilator thread and the
        # consumer's requeue both send on _ventilator_send; stop() and the
        # consumer's supervision both send control messages
        self._vent_lock = threading.Lock()
        self._control_lock = threading.Lock()
        # supervision bookkeeping (consumer thread only)
        self._worker_state = {}     # worker_id -> {'pid', 'busy', 'last_hb', 'claimed_since_spawn'}
        self._heartbeats_received = 0
        self._dying = {}            # worker_id -> {'proc', 'ring', 'at'} awaiting drain
        self._respawn_failures = {}
        self._deaths_seen = False
        self._idle_sweep_since = None
        self._last_supervise = 0.0
        self._spawn_info = None
        self._spawns = 0            # spawns so far: each process's token
        self._retiring = set()      # worker_ids asked to exit: shed, not respawned
        # slots asked for (+) or asked to retire (-), not yet applied by the
        # consumer thread (under _state_lock)
        self._slot_requests = 0
        self._run_id = uuid.uuid4().hex[:12]
        # spawn token -> the process's latest cumulative counts snapshot
        self._metrics_by_spawn = {}
        #: seq of the item whose payload get_results returned last
        self.last_result_seq = None
        #: virtual-root trace context of that item (None below the spans level)
        self.last_result_trace = None
        #: callable(seq) fired when a delivered item completes
        self.done_callback = None
        #: the opt-in protocol conformance monitor (docs/protocol.md), or None
        self.protocol_monitor = None
        if protocol_monitor or (protocol_monitor is None and
                                os.environ.get('PSTPU_PROTOCOL_MONITOR', '') not in ('', '0')):
            from petastorm_tpu_torch.analysis.protocol.monitor import monitor_from_env
            self.protocol_monitor = monitor_from_env(protocol_monitor, 'process-pool')

    @property
    def transport(self):
        return self._transport

    @property
    def workers_count(self):
        return self._workers_count

    def workers_alive(self):
        """Live worker processes (shed slots do not count)."""
        return sum(1 for p in self._processes if p is not None and p.is_alive())

    def add_worker_slot(self):
        """Ask for one more supervised worker slot, from any thread. The
        consumer thread spawns it (a fresh ring on the shm transport) at its
        next :meth:`get_results` tick, under the same heartbeats, claims and
        respawns as the others. Slot ids are never reused. Returns the new
        target ``workers_count``."""
        if self._spawn_info is None or self._stopped:
            raise RuntimeError('Pool not started (or already stopped)')
        with self._state_lock:
            self._workers_count += 1
            self._slot_requests += 1
            return self._workers_count

    def retire_worker_slot(self):
        """Ask for one worker slot to retire, from any thread (the target
        never drops below 1). The consumer thread picks the slot at its next
        :meth:`get_results` tick, an idle one when the heartbeats show one:
        it is asked to exit after its current item, and its exit goes through
        the death path, which sheds the slot instead of respawning it. Items
        still in its dispatch pipe are requeued by
        :meth:`_sweep_stranded_items`. Returns the new target
        ``workers_count``."""
        with self._state_lock:
            if self._stopped or self._workers_count <= 1:
                return self._workers_count
            self._workers_count -= 1
            self._slot_requests -= 1
            return self._workers_count

    def _apply_slot_requests(self):
        """On the consumer thread: spawn or retire the slots that
        :meth:`add_worker_slot`/:meth:`retire_worker_slot` asked for."""
        with self._state_lock:
            n, self._slot_requests = self._slot_requests, 0
        if self._stopped:
            return
        for _ in range(n):
            self._grow_slot()
        for _ in range(-n):
            self._retire_slot()

    def _grow_slot(self):
        worker_id = len(self._processes)
        ring = ring_name = None
        try:
            if self._transport == 'shm':
                from petastorm_tpu_torch.native.shm_ring import ShmRing
                ring_name = self._ring_name(worker_id, 0)
                ring = ShmRing.create(ring_name, self._ring_bytes)
            process = self._spawn_worker(worker_id, ring_name)
        except Exception as e:  # noqa: BLE001 - a failed grow leaves the pool as it was, never kills the consumer
            if ring is not None:
                ring.close()
            with self._state_lock:
                self._workers_count -= 1
            logger.error('Growing the process pool failed (%s); staying at %d workers', e,
                         self._workers_count)
            return
        with self._ring_lock:
            self._rings.append(ring)
        self._processes.append(process)
        logger.info('process pool grew to %d workers (slot %d)', self._workers_count, worker_id)

    def _retire_slot(self):
        live = [w for w, p in enumerate(self._processes)
                if p is not None and p.is_alive() and w not in self._retiring
                and w not in self._dying]
        if len(live) <= 1:
            with self._state_lock:
                self._workers_count += 1  # declined: the last live worker stays
            return
        idle = [w for w in live if self._worker_state.get(w, {}).get('busy') is None]
        worker_id = (idle or live)[-1]
        self._retiring.add(worker_id)
        self._send_control(CONTROL_RETIRE + str(worker_id).encode())
        logger.info('process pool retiring worker slot %d (target %d workers)', worker_id,
                    self._workers_count)

    def _send_control(self, msg):
        with self._control_lock:
            self._control_send.send(msg)

    def _all_slots_shed(self):
        """True when every slot was given up on: the only state in which the
        supervised pool declares itself depleted."""
        return bool(self._processes) and all(p is None for p in self._processes)

    def _ring_name(self, worker_id, generation):
        return '/pstpu_{}_{}_{}g{}'.format(os.getpid(), self._run_id, worker_id, generation)

    def _create_rings(self, ring_names):
        from petastorm_tpu_torch.native.shm_ring import ShmRing
        # rings smaller than asked would break the one-payload-must-fit rule
        # mid-run, so a /dev/shm too small for them falls back to zmq here
        avail = _shm_free_bytes()
        if avail is not None and self._ring_bytes * self._workers_count > avail * 0.9:
            raise OSError('/dev/shm has {} bytes free; {} rings of {} bytes will not fit'.format(
                avail, self._workers_count, self._ring_bytes))
        for worker_id in range(self._workers_count):
            name = self._ring_name(worker_id, 0)
            with self._ring_lock:
                self._rings.append(ShmRing.create(name, self._ring_bytes))
            ring_names[worker_id] = name

    def _spawn_worker(self, worker_id, ring_name):
        setup_blob, vent_addr, result_addr, control_addr = self._spawn_info
        ctx = multiprocessing.get_context('spawn')
        self._spawns += 1
        # the items a new process can hold are those dispatched from now on
        # (the dispatch watermarks of _sweep_stranded_items)
        with self._vent_lock:
            first = self._dispatch_ids.peek()
        p = ctx.Process(
            target=_worker_bootstrap,
            args=(worker_id, os.getpid(), setup_blob, vent_addr, result_addr, control_addr,
                  self._results_hwm, ring_name, self._blob_dir, self._blob_threshold,
                  self._workers_count,
                  self._heartbeat_interval_s if self._supervision else None, self._spawns),
            daemon=True)
        p.start()
        self._worker_state[worker_id] = {'pid': p.pid, 'busy': None,
                                         'last_hb': time.monotonic(),
                                         'claimed_since_spawn': False,
                                         'first_dispatch': first, 'max_claimed': -1}
        return p

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._processes:
            raise RuntimeError('Pool already started')
        # the flight recorder: on by default at the counters level; every
        # worker's recorder goes to the consumer's run directory
        flight = blackbox.maybe_enable('consumer')
        if flight is not None:
            flight.register_lock('process_pool.state_lock', self._state_lock)
            flight.watch('pool_completed', lambda: self._completed_items)
            if isinstance(worker_setup_args, dict) and 'flight_dir' not in worker_setup_args:
                worker_setup_args = dict(worker_setup_args,
                                         flight_dir=os.path.dirname(flight.path))
        self._context = zmq.Context()
        self._ipc_dir = tempfile.mkdtemp(prefix='pstpu_pool_')
        vent_addr = 'ipc://' + os.path.join(self._ipc_dir, 'vent')
        result_addr = 'ipc://' + os.path.join(self._ipc_dir, 'result')
        control_addr = 'ipc://' + os.path.join(self._ipc_dir, 'control')

        self._ventilator_send = self._context.socket(zmq.PUSH)
        self._ventilator_send.setsockopt(zmq.LINGER, 0)
        self._ventilator_send.bind(vent_addr)
        self._control_send = self._context.socket(zmq.PUB)
        self._control_send.setsockopt(zmq.LINGER, 0)
        self._control_send.bind(control_addr)

        ring_names = [None] * self._workers_count
        if self._transport == 'shm':
            try:
                self._create_rings(ring_names)
            except OSError as e:
                # /dev/shm too small (a catchable error from the pre-faulting
                # create, not a SIGBUS later): degrade to zmq
                logger.warning('shm ring allocation failed (%s); falling back to zmq transport', e)
                with self._ring_lock:
                    for ring in self._rings:
                        ring.close()
                    self._rings = []
                ring_names = [None] * self._workers_count
                self._transport = 'zmq'
                self._zero_copy = False
        if self._transport == 'zmq':
            with self._ring_lock:
                self._rings = [None] * self._workers_count
            self._results_receive = self._context.socket(zmq.PULL)
            self._results_receive.setsockopt(zmq.RCVHWM, self._results_hwm)
            self._results_receive.bind(result_addr)

        # one blob dir per run, when the serializer splits payloads and tmpfs
        # has some headroom; the owner pid in the name lets a later pool reap
        # a dir a hard-killed run left behind
        if (self._blob_threshold and hasattr(self._serializer, 'serialize_parts')
                and os.path.isdir('/dev/shm')):
            _sweep_stale_blob_dirs('/dev/shm')
            avail = _shm_free_bytes()
            if avail is not None and avail >= 4 * self._blob_threshold:
                try:
                    self._blob_dir = tempfile.mkdtemp(
                        prefix='pstpu_blobs_{}_'.format(os.getpid()), dir='/dev/shm')
                except OSError:
                    self._blob_dir = None

        # an installed fault plan rides the setup args into the spawned
        # workers, as the telemetry config does
        if isinstance(worker_setup_args, dict) and 'fault_plan' not in worker_setup_args \
                and faults.get_plan() is not None:
            worker_setup_args = dict(worker_setup_args, fault_plan=faults.get_plan())
        # an installed chunk fabric ships its fetch-only config the same way:
        # the workers miss on the same chunk store and ask pod peers first,
        # as the consumer does
        if isinstance(worker_setup_args, dict) and 'fabric' not in worker_setup_args:
            from petastorm_tpu_torch import fabric
            fabric_config = fabric.shippable_config()
            if fabric_config is not None:
                worker_setup_args = dict(worker_setup_args, fabric=fabric_config)
        setup_blob = pickle.dumps((worker_class, worker_setup_args, self._serializer),
                                  protocol=pickle.HIGHEST_PROTOCOL)
        self._spawn_info = (setup_blob, vent_addr, result_addr, control_addr)
        for worker_id in range(self._workers_count):
            self._processes.append(self._spawn_worker(worker_id, ring_names[worker_id]))

        # startup handshake: every worker connected and reported in
        deadline = time.monotonic() + _WORKER_STARTUP_TIMEOUT_S
        started = 0
        while started < self._workers_count:
            if time.monotonic() > deadline:
                self.stop()
                self.join()
                raise TimeoutWaitingForResultError('Only {} of {} workers started within {}s'.format(
                    started, self._workers_count, _WORKER_STARTUP_TIMEOUT_S))
            msg = self._poll_message(100)
            if msg is None:
                continue
            if msg[0] == MSG_STARTED:
                started += 1
            elif msg[0] == MSG_HEARTBEAT:
                self._note_heartbeat(msg[2])
            else:
                logger.warning('dropping pre-handshake message of kind %r', msg[0])

        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    # -- the results transport ---------------------------------------------

    def _poll_message(self, timeout_ms):
        """Next ``(kind, dispatch, payload, slot)`` from the results
        transport, or None after ``timeout_ms``. shm: round robin over the
        rings (and dead workers' rings until they drain). ``slot`` is the
        lifetime slot of a zero-copy payload (None for owned payloads): the
        caller adopts the deserialized arrays into it and seals it."""
        if self._transport == 'zmq':
            if not self._results_receive.poll(timeout_ms):
                return None
            kind, seq_bytes, payload = self._results_receive.recv_multipart()
            if kind == MSG_DATA:
                # bytes are immutable and would make the views read-only; the
                # ring and blob channels hand out writable buffers
                payload = bytearray(payload)
            return kind, (int(seq_bytes) if seq_bytes else None), payload, None
        deadline = time.monotonic() + timeout_ms / 1000.0
        idle = self._idle_wait
        while True:
            with self._ring_lock:
                for ring in self._rings + self._retired_rings:
                    if ring is None:
                        continue
                    msg = self._ring_take(ring)
                    if msg is not None:
                        idle.reset()
                        return msg
            if time.monotonic() >= deadline:
                return None
            idle.wait()

    def _ring_take(self, ring):
        """One ``(kind, dispatch, payload, slot)`` off ``ring``, or None when
        it is empty. The caller holds ``_ring_lock``.

        Copy mode: every message lands in a fresh buffer. Zero-copy mode: a
        data payload stays a view into the ring slot, and ``slot`` is its
        ledger entry, which the caller must adopt or release (dropping both
        wedges the ring's FIFO release). Other kinds are copied out and
        their span released at once."""
        if not self._zero_copy:
            view = ring.try_read_view()
            return None if view is None else ring_unpack(view) + (None,)
        item = ring.try_read_zero_copy()
        if item is None:
            return None
        view, span, borrowed = item
        ledger = self._ring_ledgers.get(id(ring))
        if ledger is None:
            ledger = self._ring_ledgers[id(ring)] = RingBorrowLedger(ring)
        slot = ledger.take(view, span, borrowed)
        kind, d, payload = ring_unpack(view)
        if not borrowed:
            slot.release_now()  # a wrapped message came back as an owned copy
            return kind, d, payload, None
        if kind != MSG_DATA:
            payload = memoryview(bytearray(payload))
            slot.release_now()
            return kind, d, payload, None
        return kind, d, payload, slot

    def _close_ring(self, ring):
        """Close a consumer-side ring, deferring the unmap while zero-copy
        views into it are alive (closing under a live view would turn a
        stale read into a segfault)."""
        ledger = self._ring_ledgers.pop(id(ring), None)
        if ledger is None:
            ring.close()
        else:
            ledger.close_when_drained(ring.close)

    # -- items ----------------------------------------------------------------

    def ventilate(self, *args, **kwargs):
        # the ventilator's tag stays in the consumer's item record, never
        # crosses to a worker, and so survives a requeue after a death
        seq = kwargs.pop('_seq', None)
        # called inside the ventilator's mint block: the item's trace context
        # rides the ventilation tuple
        ctx = obs.current_trace()
        # ids are allocated and sent under one lock, so every dispatch pipe
        # holds its items in id order (what the watermarks rely on)
        with self._vent_lock:
            with self._state_lock:
                self._ventilated_items += 1
                d = self._dispatch_ids.next()
                self._inflight[d] = {'seq': seq, 'args': args, 'kwargs': kwargs, 'attempts': 0,
                                     'published': False, 'claimed': False, 'trace': ctx}
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_dispatch(d, seq)
            self._ventilator_send.send_pyobj((d, args, kwargs, ctx))

    def _requeue(self, d, rec):
        """Dispatch an in-flight item again under a new id (messages tagged
        with the old one are then stale). The ventilated/completed counters
        stay: it is the same logical item."""
        with self._vent_lock:
            with self._state_lock:
                if self._inflight.get(d) is not rec:
                    return  # resolved concurrently
                del self._inflight[d]
                nd = self._dispatch_ids.next()
                rec['attempts'] += 1
                rec['published'] = False
                rec['claimed'] = False
                self._inflight[nd] = rec
                self._items_requeued += 1
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_requeue(d, nd)
            # a retry keeps the item's trace context: one item, one tree
            self._ventilator_send.send_pyobj((nd, rec['args'], rec['kwargs'], rec['trace']))
        obs.count('items_requeued')

    def _complete(self, d, rec, delivered):
        """Completion of one logical item, exactly once: the epoch's
        completed count and the ventilator's in-flight budget advance, and a
        ``delivered`` item (its payload reached the consumer) fires
        ``done_callback``; an undelivered one is re-read by a checkpoint."""
        with self._state_lock:
            if d is not None and self._inflight.pop(d, None) is None:
                return  # stale duplicate
            self._completed_items += 1
            if self.protocol_monitor is not None and d is not None:
                self.protocol_monitor.on_complete(d, delivered)
        seq = rec['seq'] if rec is not None else None
        if self._ventilator is not None:
            self._ventilator.processed_item(seq)
        if delivered and seq is not None and self.done_callback is not None:
            self.done_callback(seq)

    def get_results(self, timeout_s=None):
        """The next payload, timed as the ``pool_wait`` stage."""
        with obs.stage('pool_wait', cat='pool') as sp:
            payload = self._get_results(timeout_s)
            # the item is known only once its frame arrives: the wait span
            # joins its tree afterwards
            sp.link(self.last_result_trace)
            return payload

    def _get_results(self, timeout_s=None):
        timeout_s = timeout_s if timeout_s is not None else self._results_timeout_s
        deadline = (time.monotonic() + timeout_s) if timeout_s is not None else None
        while True:
            if self._slot_requests:
                self._apply_slot_requests()
            msg = self._poll_message(50)
            if self._supervision and self._processes and (
                    msg is None or time.monotonic() - self._last_supervise > 0.2):
                self._supervise(idle=msg is None)
            if msg is None:
                if self._all_done():
                    if self.protocol_monitor is not None:
                        with self._state_lock:
                            ventilated, completed = (self._ventilated_items,
                                                     self._completed_items)
                        self.protocol_monitor.on_drained(ventilated, completed)
                    raise EmptyResultError()
                if self._stopped and not self._processes:
                    # (a thread still waiting here after join() gets no more)
                    raise EmptyResultError()
                if self._supervision and self._all_slots_shed():
                    raise WorkerPoolDepletedError(
                        'All {} worker slots are dead and respawn kept failing; {} items in '
                        'flight will never complete'.format(
                            self._workers_count, self._ventilated_items - self._completed_items))
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError(self._timeout_message(timeout_s))
                continue
            kind, d, payload, slot = msg
            if kind == MSG_DATA or kind == MSG_BLOB:
                with self._state_lock:
                    rec = self._inflight.get(d) if d is not None else None
                if self.protocol_monitor is not None and d is not None:
                    self.protocol_monitor.on_message('data', d, live=rec is not None)
                if d is not None and rec is None:
                    # stale duplicate of a requeued attempt
                    if kind == MSG_BLOB:
                        try:
                            os.unlink(bytes(payload).decode())
                        except OSError:
                            pass
                    if slot is not None:
                        slot.release_now()
                    continue
                if rec is not None:
                    rec['published'] = True
                self.last_result_seq = rec['seq'] if rec is not None else None
                # from the in-flight record: the frame carries no trace bytes
                self.last_result_trace = obs.root_of(rec['trace']) if rec is not None else None
                if kind == MSG_DATA:
                    result = self._serializer.deserialize(payload)
                    if slot is not None:
                        # zero-copy: the batch's arrays are views of the ring
                        # slot, whose bytes return when they die
                        slot.adopt(result)
                        slot.seal()
                    return result
                blob_view, blob_slot = _read_blob(bytes(payload).decode())
                result = self._serializer.deserialize(blob_view)
                blob_slot.adopt(result)
                blob_slot.seal()
                return result
            elif kind == MSG_DONE:
                self._clear_claim(d)
                with self._state_lock:
                    rec = self._inflight.get(d) if d is not None else None
                if self.protocol_monitor is not None and d is not None:
                    self.protocol_monitor.on_message('done', d, live=rec is not None)
                if d is not None and rec is None:
                    continue  # stale duplicate
                self._complete(d, rec, delivered=True)
            elif kind == MSG_METRICS:
                self._absorb_metrics(payload)
            elif kind == MSG_HEARTBEAT:
                self._note_heartbeat(payload)
            elif kind == MSG_ERROR:
                self._clear_claim(d)
                exc = self._handle_worker_error(d, payload)
                if exc is not None:
                    raise exc
            elif kind == MSG_STARTED:
                pass  # a respawned worker reporting in
            else:
                logger.warning('dropping message with unknown protocol kind %r', kind)

    def _handle_worker_error(self, d, payload):
        """Apply the policy to a worker-raised exception: the exception to
        raise to the consumer, or None when the item was requeued,
        quarantined or completed."""
        try:
            err = pickle.loads(bytes(payload))
        except Exception as e:  # noqa: BLE001 - a malformed report must still fail loudly
            err = {'exc': RuntimeError('worker error report could not be unpickled: {}'.format(e))}
        exc, tb = err.get('exc'), err.get('tb')
        worker_id, pid = err.get('worker_id'), err.get('pid')
        with self._state_lock:
            rec = self._inflight.get(d) if d is not None else None
        if self.protocol_monitor is not None and d is not None:
            self.protocol_monitor.on_message('error', d, live=rec is not None)
        if d is not None and rec is None:
            return None  # stale report of an earlier attempt
        attempts = (rec['attempts'] if rec is not None else 0) + 1
        seq = rec['seq'] if rec is not None else None
        if rec is not None and rec['published'] and self._policy.on_error != 'raise':
            # its payload reached the consumer already (the channel is FIFO):
            # a re-run would deliver it twice, so it completes as delivered
            logger.warning('Worker %s failed on item seq=%s AFTER its payload was delivered; '
                           'completing the item rather than re-running it: %s',
                           worker_id, seq, exc)
            self._complete(d, rec, delivered=True)
            return None
        if rec is not None and self._policy.should_retry_error(attempts):
            logger.warning('Worker %s failed on item seq=%s (attempt %d/%d); requeueing: %s',
                           worker_id, seq, attempts, self._policy.max_item_retries + 1, exc)
            self._requeue(d, rec)
            return None
        if rec is not None and self._policy.quarantines():
            self._quarantine(d, rec, kind='error', error=exc, tb=tb, worker_id=worker_id)
            return None
        self._complete(d, rec, delivered=False)
        return attach_remote_context(exc, tb, worker_id=worker_id, seq=seq, pid=pid)

    def _quarantine(self, d, rec, kind, error=None, tb=None, worker_id=None):
        record = quarantine_record(rec['seq'], rec['attempts'] + 1, kind, error=error, tb=tb,
                                   worker_id=worker_id,
                                   item={'args': rec['args'], 'kwargs': rec['kwargs']})
        with self._state_lock:
            self._quarantined.append(record)
        obs.count('items_quarantined')
        logger.error('Quarantining item seq=%s after %d failed attempts (%s): %s', rec['seq'],
                     record['attempts'], kind, record['error'])
        self._complete(d, rec, delivered=False)

    # -- supervision ------------------------------------------------------------

    def _clear_claim(self, d):
        """A MSG_DONE/MSG_ERROR for ``d`` releases its owner's claim (the
        claim always precedes it on the FIFO channel) and proves liveness."""
        if d is None:
            return
        for state in self._worker_state.values():
            if state.get('busy') == d:
                state['busy'] = None
                state['last_hb'] = time.monotonic()
                return

    def _note_heartbeat(self, payload):
        try:
            hb = pickle.loads(bytes(payload))
            worker_id = hb['worker_id']
        except Exception as e:  # noqa: BLE001 - a malformed beacon must not stop the read loop
            logger.debug('dropping malformed heartbeat: %s', e)
            return
        self._heartbeats_received += 1
        if self.protocol_monitor is not None and hb.get('busy') is not None:
            # a claim beacon: its dispatch id must have been issued (a stale
            # claim is legal: the requeue may have happened already)
            self.protocol_monitor.on_message('claim', hb.get('busy'))
        state = self._worker_state.setdefault(worker_id, {})
        state['pid'] = hb.get('pid')
        state['busy'] = busy = hb.get('busy')
        state['last_hb'] = time.monotonic()
        if busy is not None:
            state['claimed_since_spawn'] = True
            state['max_claimed'] = max(state.get('max_claimed', -1), busy)
            with self._state_lock:
                rec = self._inflight.get(busy)
                if rec is not None:
                    rec['claimed'] = True

    def _supervise(self, idle):
        """The supervisor tick, on the consumer thread: poll exitcodes,
        respawn the dead, resolve orphaned items, and sweep items lost in a
        dead worker's unclaimed dispatch pipe."""
        now = time.monotonic()
        self._last_supervise = now
        for worker_id, p in enumerate(self._processes):
            if p is not None and p.exitcode is not None and worker_id not in self._dying:
                self._begin_worker_death(worker_id, p, now)
        for worker_id in list(self._dying):
            if self._death_drained(worker_id, now):
                info = self._dying.pop(worker_id)
                self._finish_worker_death(worker_id, info, time.monotonic())
        if self._worker_state:
            ages = [now - s['last_hb'] for s in self._worker_state.values() if 'last_hb' in s]
            if ages:
                obs.gauge_set('heartbeat_age_s', round(max(ages), 3))
        if self._orphans:
            self._resolve_orphans(now)
        # a PUB message reaches only subscribers already connected: a retire
        # is sent again until its worker is gone (a worker spawned a moment
        # ago may not have subscribed yet)
        for worker_id in list(self._retiring):
            p = self._processes[worker_id]
            if p is not None and p.exitcode is None:
                self._send_control(CONTROL_RETIRE + str(worker_id).encode())
        if self._deaths_seen and not self._dying:
            self._sweep_stranded_items()
        if idle:
            self._sweep_lost_items(now)
        else:
            self._idle_sweep_since = None

    def _sweep_stranded_items(self):
        """Requeue the unclaimed items no live worker can hold any more. A
        worker takes its dispatch pipe in id order (ids are sent in order),
        so it can hold item ``d`` only if it was spawned before ``d`` was
        sent and has claimed no id above ``d``. An unclaimed, unpublished
        item that no live worker can hold was in the pipe of a worker that
        died or retired: it is requeued under a new id. This finds such
        items while the pipeline keeps the others busy, where the quiet
        window of :meth:`_sweep_lost_items` never comes."""
        live = [self._worker_state.get(w) for w, p in enumerate(self._processes)
                if p is not None and p.exitcode is None and w not in self._retiring]
        if not live or any(s is None or 'first_dispatch' not in s for s in live):
            return
        with self._state_lock:
            candidates = [(d, rec) for d, rec in self._inflight.items()
                          if not rec['claimed'] and not rec['published']
                          and d not in self._orphans]
        for d, rec in candidates:
            if all(d < s['first_dispatch'] or s['max_claimed'] > d for s in live):
                logger.warning('Requeueing item %s stranded in a departed worker\'s dispatch '
                               'pipe', rec['kwargs'])
                self._requeue(d, rec)

    def _begin_worker_death(self, worker_id, p, now):
        """Stage 1: retire the dead worker's ring so the poll loop drains its
        last committed messages (a half-written message is invisible: the
        writer commits by advancing the index). Ownership and respawn wait
        until the ring is drained: the worker's last claim may sit in it."""
        p.join()  # reap the zombie
        if worker_id in self._retiring:
            logger.info('Retired worker %d (pid %s) exited; draining its results', worker_id,
                        p.pid)
        else:
            logger.warning('Worker %d (pid %s) died with exitcode %s; draining its results',
                           worker_id, p.pid, p.exitcode)
            # a negative exitcode names the signal even when the worker's own
            # flight file got no footer
            blackbox.record_event({'event': 'worker_death', 'worker_id': worker_id,
                                   'pid': p.pid, 'exitcode': p.exitcode})
        self._deaths_seen = True
        with self._ring_lock:
            old_ring = self._rings[worker_id] if worker_id < len(self._rings) else None
            if old_ring is not None:
                self._retired_rings.append(old_ring)
                self._rings[worker_id] = None
        self._dying[worker_id] = {'proc': p, 'ring': old_ring, 'at': now}

    def _death_drained(self, worker_id, now):
        """The dead worker's messages are all consumed: shm, its ring holds
        no unread message; zmq, a grace period passed."""
        info = self._dying[worker_id]
        ring = info['ring']
        if ring is not None:
            with self._ring_lock:
                return not ring.has_message()
        return now - info['at'] >= _REQUEUE_GRACE_S

    def _finish_worker_death(self, worker_id, info, now):
        """Stage 2: orphan what the dead worker held, account the respawn
        budget, and start a replacement on a fresh ring."""
        state = self._worker_state.get(worker_id, {})
        owned = state.get('busy')
        if owned is not None:
            logger.warning('Dead worker %d owned item dispatch=%s; scheduling requeue',
                           worker_id, owned)
            blackbox.record_event({'event': 'worker_owned_item', 'worker_id': worker_id,
                                   'pid': info['proc'].pid, 'dispatch': owned})
            self._orphans.setdefault(owned, now)
        if worker_id in self._retiring:
            # a deliberate retire sheds the slot: no respawn, no restart
            self._retiring.discard(worker_id)
            self._processes[worker_id] = None
            self._worker_state.pop(worker_id, None)
            logger.info('Worker slot %d retired; pool at %d live workers', worker_id,
                        self.workers_alive())
            return
        # a death before any claim counts toward the slot's respawn budget; a
        # death while working is the item's and resets it
        if state.get('claimed_since_spawn'):
            self._respawn_failures[worker_id] = 0
        else:
            self._respawn_failures[worker_id] = self._respawn_failures.get(worker_id, 0) + 1
        if self._respawn_failures[worker_id] >= _MAX_RESPAWN_FAILURES:
            self._processes[worker_id] = None
            logger.error('Worker slot %d died %d consecutive times at startup; shedding the '
                         'slot. Pool degraded to %d live workers (of %d configured).',
                         worker_id, self._respawn_failures[worker_id], self.workers_alive(),
                         self._workers_count)
            self._worker_state.pop(worker_id, None)
            return
        try:
            new_ring_name = None
            if info['ring'] is not None:
                from petastorm_tpu_torch.native.shm_ring import ShmRing
                new_ring_name = self._ring_name(worker_id, self._worker_restarts + 1)
                new_ring = ShmRing.create(new_ring_name, self._ring_bytes)
                with self._ring_lock:
                    self._rings[worker_id] = new_ring
            self._processes[worker_id] = self._spawn_worker(worker_id, new_ring_name)
        except Exception as e:  # noqa: BLE001 - a failed respawn degrades the pool, never kills the consumer
            with self._ring_lock:
                ring, self._rings[worker_id] = self._rings[worker_id], None
            if ring is not None:
                self._close_ring(ring)
            self._processes[worker_id] = None
            self._respawn_failures[worker_id] = _MAX_RESPAWN_FAILURES
            logger.error('Respawning worker %d failed (%s); shedding the slot. Pool degraded to '
                         '%d live workers.', worker_id, e, self.workers_alive())
            self._worker_state.pop(worker_id, None)
            return
        self._worker_restarts += 1
        obs.count('worker_restarts')
        blackbox.record_event({'event': 'worker_respawned', 'worker_id': worker_id,
                               'pid': self._processes[worker_id].pid})
        logger.warning('Respawned worker %d as pid %s', worker_id, self._processes[worker_id].pid)

    def _retired_rings_drained(self):
        """True when no retired ring holds an unread message; drained ones
        are closed and dropped on the way."""
        with self._ring_lock:
            for ring in list(self._retired_rings):
                if ring.has_message():
                    return False
                self._close_ring(ring)
                self._retired_rings.remove(ring)
        return True

    def _resolve_orphans(self, now):
        """Requeue (or quarantine, or fail) the items dead workers owned,
        once their in-transit messages had a chance to land: an item whose
        result arrived is completed, not re-run."""
        if not self._retired_rings_drained():
            return
        for d, died_at in list(self._orphans.items()):
            if now - died_at < _REQUEUE_GRACE_S:
                continue
            self._orphans.pop(d)
            with self._state_lock:
                rec = self._inflight.get(d)
            if rec is None:
                continue  # its MSG_DONE landed during the grace window
            if rec['published']:
                self._complete(d, rec, delivered=True)  # only the completion sentinel was lost
                continue
            self._fail_crashed_item(d, rec)

    def _fail_crashed_item(self, d, rec):
        attempts = rec['attempts'] + 1
        if self._policy.should_retry_crash(attempts):
            logger.warning('Requeueing item %s lost to a dead worker (attempt %d/%d)',
                           rec['kwargs'], attempts, self._policy.max_item_retries + 1)
            self._requeue(d, rec)
            return
        if self._policy.quarantines():
            self._quarantine(d, rec, kind='crash', error=RuntimeError(
                'item killed {} consecutive worker processes'.format(attempts)))
            return
        self._complete(d, rec, delivered=False)
        raise PoisonItemError(
            'Item (kwargs={}) killed {} consecutive worker processes; use on_error=\'skip\' to '
            'quarantine poison items instead'.format(rec['kwargs'], attempts))

    def _sweep_lost_items(self, now):
        """Recover items lost in a dead worker's unclaimed dispatch pipe
        (zmq PUSH had routed them to the dead peer, so no claim named an
        owner): after a death, once every live worker has been idle with
        fresh heartbeats for a quiet window and items are still in flight,
        nothing can run them, so they are requeued. Requeued items get new
        ids, so even a wrong sweep delivers exactly once."""
        if not self._deaths_seen or self._orphans or not self._supervision:
            return
        with self._state_lock:
            in_flight = len(self._inflight)
        if in_flight == 0 or not self._retired_rings_drained():
            self._idle_sweep_since = None
            return
        hb = self._heartbeat_interval_s or _DEFAULT_HEARTBEAT_S
        for worker_id, p in enumerate(self._processes):
            if p is None:
                continue
            state = self._worker_state.get(worker_id)
            if state is None or state.get('busy') is not None \
                    or now - state.get('last_hb', 0) > 2 * hb + 0.5:
                self._idle_sweep_since = None
                return
        if self._idle_sweep_since is None:
            self._idle_sweep_since = now
            return
        if now - self._idle_sweep_since < max(2 * hb, 1.0):
            return
        self._idle_sweep_since = None
        with self._state_lock:
            lost = list(self._inflight.items())
        logger.warning("Sweeping %d item(s) lost in dead workers' dispatch pipes", len(lost))
        for d, rec in lost:
            if rec['published']:
                self._complete(d, rec, delivered=True)
            else:
                self._fail_crashed_item(d, rec)

    def _timeout_message(self, timeout_s):
        """Per-worker liveness for :class:`TimeoutWaitingForResultError`:
        alive or exitcode, heartbeat age and the item held."""
        with self._state_lock:
            in_flight = self._ventilated_items - self._completed_items
            owned = {d: rec['kwargs'] for d, rec in self._inflight.items()}
        now = time.monotonic()
        lines = ['No results from worker processes in {}s; {} items in flight.'.format(
            timeout_s, in_flight), 'Worker liveness:']
        for worker_id, p in enumerate(self._processes):
            if p is None:
                lines.append('  worker {}: slot shed after repeated respawn failures'.format(
                    worker_id))
                continue
            state = self._worker_state.get(worker_id, {})
            status = 'DEAD exitcode={}'.format(p.exitcode) if p.exitcode is not None else 'alive'
            hb_age = '{:.1f}s ago'.format(now - state['last_hb']) if state.get('last_hb') \
                else 'never'
            busy = state.get('busy')
            owning = 'idle' if busy is None else 'processing item {}'.format(owned.get(busy, '?'))
            lines.append('  worker {}: pid {} {}, last heartbeat {}, {}'.format(
                worker_id, p.pid, status, hb_age, owning))
        if not self._supervision:
            lines.append('  (supervision disabled: no heartbeat/ownership data)')
        return '\n'.join(lines)

    # -- counts shipped by the workers ------------------------------------------

    def _absorb_metrics(self, payload):
        """A worker's ``MSG_METRICS`` frame: add the increase of its
        cumulative route counts since its last frame to this process's
        ``read_routes`` and ``image_routes``, keep its publish counts and its
        registry snapshot (the latest supersedes the earlier ones), and merge
        its span events into this process's ring."""
        from petastorm_tpu_torch.codecs import image_routes
        from petastorm_tpu_torch.native import read_routes
        try:
            rec = pickle.loads(bytes(payload))
            key = rec.get('spawn', rec['pid'])
        except Exception as e:  # noqa: BLE001 - malformed counts must not stop the read loop
            logger.debug('dropping malformed worker counts: %s', e)
            return
        last = self._metrics_by_spawn.get(key, {})
        for name, counter in (('read_routes', read_routes), ('image_routes', image_routes)):
            before = last.get(name, {})
            for k, value in rec.get(name, {}).items():
                if value != before.get(k, 0):
                    counter.add(k, value - before.get(k, 0))
        obs.absorb_trace_events(rec.pop('events', None))
        self._metrics_by_spawn[key] = rec

    def telemetry_snapshots(self):
        """The latest registry snapshot of every worker process this pool
        ran (for :func:`~petastorm_tpu_torch.observability.merge_snapshots`)."""
        return [rec['metrics'] for rec in list(self._metrics_by_spawn.values())
                if rec.get('metrics')]

    def publish_counts(self):
        """Publishes per channel (``publish_inplace``: fused batches decoded
        into a ring slot; ``publish_ring``: in-band over a ring;
        ``publish_blob``; ``publish_zmq``), summed over every worker process
        this pool ran."""
        out = dict.fromkeys(PUBLISH_CHANNELS, 0)
        for rec in list(self._metrics_by_spawn.values()):
            for key, value in rec.get('publishes', {}).items():
                out[key] = out.get(key, 0) + value
        return out

    def _all_done(self):
        # completed() first: once true, the ventilated count is final
        if self._ventilator is not None and not self._ventilator.completed():
            return False
        with self._state_lock:
            return self._ventilated_items <= self._completed_items

    def stop(self):
        if self._stopped:
            return
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stopped = True
        if self._control_send is not None:
            # a worker that connects after this send misses it: join() sends
            # it again while draining
            self._send_control(CONTROL_FINISHED)

    def join(self):
        if not self._stopped:
            raise RuntimeError('join() must be called after stop()')
        deadline = time.monotonic() + 10
        while any(p is not None and p.is_alive() for p in self._processes) \
                and time.monotonic() < deadline:
            self._send_control(CONTROL_FINISHED)
            # drain so workers blocked on a full transport can exit
            if self._transport == 'zmq':
                while self._results_receive.poll(0):
                    self._results_receive.recv_multipart()
            else:
                with self._ring_lock:
                    for ring in self._rings + self._retired_rings:
                        if ring is None:
                            continue
                        while True:
                            drained = self._ring_take(ring)
                            if drained is None:
                                break
                            if drained[3] is not None:
                                drained[3].release_now()
            time.sleep(0.05)
        for p in self._processes:
            if p is None:
                continue
            if p.is_alive():
                logger.warning('Terminating unresponsive worker pid=%s', p.pid)
                p.terminate()
            p.join()
        self._processes = []
        with self._ring_lock:
            for ring in self._rings + self._retired_rings:
                if ring is not None:
                    self._close_ring(ring)
            self._rings = []
            self._retired_rings = []
        for sock in (self._ventilator_send, self._results_receive, self._control_send):
            if sock is not None:
                sock.close()
        if self._context is not None:
            self._context.term()
        if self._ipc_dir:
            shutil.rmtree(self._ipc_dir, ignore_errors=True)
        if self._blob_dir:
            # unconsumed blobs; consumed ones were unlinked on read
            shutil.rmtree(self._blob_dir, ignore_errors=True)
            self._blob_dir = None

    @property
    def quarantined_items(self):
        """Records of the items quarantined under ``on_error='skip'``."""
        with self._state_lock:
            return list(self._quarantined)

    @property
    def diagnostics(self):
        """The pool diagnostics every pool type reports with the same keys,
        plus the transport, whether zero-copy delivery is on, the publishes
        per channel and the ``lifetime_*`` counters. ``results_queue_depth``
        is 0: buffered results live in transport buffers."""
        with self._state_lock:
            out = {'workers_count': self._workers_count,
                   'items_ventilated': self._ventilated_items,
                   'items_completed': self._completed_items,
                   'items_in_flight': self._ventilated_items - self._completed_items,
                   'results_queue_depth': 0,
                   'worker_restarts': self._worker_restarts,
                   'items_requeued': self._items_requeued,
                   'items_quarantined': len(self._quarantined)}
        out.update({'transport': self._transport, 'zero_copy': self._zero_copy,
                    'ring_bytes': self._ring_bytes if self._transport == 'shm' else None})
        out.update(self.publish_counts())
        out.update(lifetime_registry().counters())
        return out

    @property
    def results_qsize(self):
        return 0  # unknown: buffered results live in transport buffers


# ---------------------------------------------------------------------------
# Worker process side
# ---------------------------------------------------------------------------

def _worker_bootstrap(worker_id, main_pid, setup_blob, vent_addr, result_addr, control_addr,
                      results_hwm, ring_name=None, blob_dir=None, blob_threshold=0,
                      workers_count=1, heartbeat_interval_s=None, spawn=None):
    """Entry point of a spawned worker process. ``ring_name`` selects the shm
    results transport (None: zmq PUSH); ``blob_dir`` enables the blob
    sidechannel; ``heartbeat_interval_s`` enables the supervision beacons;
    ``spawn`` is this process's token in its ``MSG_METRICS`` frames."""
    # the native image decode thread budget is per process, and siblings
    # cannot see each other's grants: each worker takes an equal share of
    # the cores unless the user set the variable (children inherit it)
    if 'PSTPU_IMG_THREADS' not in os.environ:
        os.environ['PSTPU_IMG_THREADS'] = str(max(1, (os.cpu_count() or 1) // max(1, workers_count)))

    worker_class, worker_setup_args, serializer = pickle.loads(setup_blob)
    # the reader's telemetry config rides the setup args: this process's
    # level and span ring match the consumer's before any stage runs
    if isinstance(worker_setup_args, dict) and worker_setup_args.get('telemetry') is not None:
        obs.configure(worker_setup_args['telemetry'])
    # fault injection rides the same route (pool plumbing, popped like the
    # flight dir); kills and segfaults are honoured only here, in a process
    # whose death the supervisor absorbs
    faults.mark_in_spawned_worker()
    plan = (worker_setup_args.pop('fault_plan', None)
            if isinstance(worker_setup_args, dict) else None)
    if plan is not None:
        faults.install(plan)
    # this worker's flight recorder, in the consumer's run directory (the key
    # is pool plumbing, not the worker's setup args)
    flight_dir = (worker_setup_args.pop('flight_dir', None)
                  if isinstance(worker_setup_args, dict) else None)
    blackbox.maybe_enable('worker{}'.format(worker_id), run_dir=flight_dir)
    # a shipped fabric config installs a fetch-only node (no server, no
    # lease), so this worker's chunk misses ask pod peers first (pool
    # plumbing, popped like the flight dir)
    fabric_config = (worker_setup_args.pop('fabric', None)
                     if isinstance(worker_setup_args, dict) else None)
    fabric_node = None
    if fabric_config is not None:
        from petastorm_tpu_torch import fabric
        try:
            fabric_node = fabric.install_from_config(fabric_config)
        except Exception as e:  # noqa: BLE001 - the fabric is an optimisation tier only
            logger.warning('fabric install failed in worker %s: %s', worker_id, e)
    _start_orphan_monitor(main_pid)

    context = zmq.Context()
    vent_recv = context.socket(zmq.PULL)
    vent_recv.connect(vent_addr)
    control_recv = context.socket(zmq.SUB)
    control_recv.setsockopt(zmq.SUBSCRIBE, b'')
    control_recv.connect(control_addr)

    finished = {'flag': False, 'retire': False}
    retire_msg = CONTROL_RETIRE + str(worker_id).encode()

    def read_control():
        """One control message: FINISHED stops the worker at once; a retire
        addressed to it stops it after the current item."""
        msg = control_recv.recv()
        if msg == CONTROL_FINISHED:
            finished['flag'] = True
        elif msg == retire_msg:
            finished['retire'] = True

    def check_finished():
        """Also polled while blocked on a full ring, so shutdown never waits
        on an unconsumed transport."""
        while not finished['flag'] and control_recv.poll(0):
            read_control()
        return finished['flag']

    ring = None
    result_send = None
    if ring_name is not None:
        from petastorm_tpu_torch.native.shm_ring import ShmRing
        ring = ShmRing.attach(ring_name)

        def send(kind, seq, payload=b''):
            ring.write2(ring_header(kind, seq), payload, stop_check=check_finished)
    else:
        result_send = context.socket(zmq.PUSH)
        result_send.setsockopt(zmq.SNDHWM, results_hwm)
        result_send.connect(result_addr)

        def send(kind, seq, payload=b''):
            result_send.send_multipart([kind, b'' if seq is None else str(seq).encode(), payload])

    current = {'seq': None}  # dispatch id of the item being processed
    last_hb = {'t': 0.0}
    publishes = dict.fromkeys(PUBLISH_CHANNELS, 0)
    in_band = 'publish_ring' if ring is not None else 'publish_zmq'

    def send_heartbeat(busy, blocking=False):
        """Liveness and ownership beacon. Claim beacons (``busy`` set) must
        land: they make a crashed item requeueable. Idle beacons are skipped
        when the transport is congested (results are flowing then)."""
        if heartbeat_interval_s is None:
            return
        payload = pickle.dumps({'worker_id': worker_id, 'pid': os.getpid(), 'busy': busy},
                               protocol=pickle.HIGHEST_PROTOCOL)
        try:
            if ring is not None:
                header = ring_header(MSG_HEARTBEAT, None)
                if blocking:
                    ring.write2(header, payload, stop_check=check_finished)
                else:
                    ring.try_write2(header, payload)
            elif blocking:
                result_send.send_multipart([MSG_HEARTBEAT, b'', payload])
            else:
                result_send.send_multipart([MSG_HEARTBEAT, b'', payload], flags=zmq.NOBLOCK)
        except zmq.Again:
            return
        last_hb['t'] = time.monotonic()

    def _blob_backpressure(incoming):
        """Block (stop-aware) until the new blob fits the pool's budget of
        unconsumed blob bytes, the byte analog of the ring's capacity."""
        while True:
            try:
                backlog = 0
                for e in os.scandir(blob_dir):
                    try:
                        backlog += e.stat().st_size
                    except FileNotFoundError:
                        continue  # consumed mid-scan
            except OSError:
                return  # dir swept at shutdown: the write fails loudly
            if backlog + incoming <= _BLOB_BUDGET_BYTES or backlog == 0:
                return
            if check_finished():
                return
            time.sleep(0.002)

    blob_fail = {'consecutive': 0, 'disabled': False}

    def _note_blob_failure(e):
        blob_fail['consecutive'] += 1
        if blob_fail['consecutive'] >= _BLOB_DISABLE_AFTER:
            blob_fail['disabled'] = True
            logger.warning('blob allocation failed %d times (%s); disabling the /dev/shm '
                           'sidechannel for this worker', blob_fail['consecutive'], e)
        else:
            logger.warning('blob allocation failed (%s); payload falling back in-band', e)

    def _try_blob_write(parts, total):
        """Write a split payload into a fresh /dev/shm blob and send its
        name; False when allocation failed (the caller goes in-band).
        ``posix_fallocate`` first, so tmpfs exhaustion is a catchable ENOSPC
        here, not a SIGBUS on an mmap write."""
        _blob_backpressure(total)
        try:
            fd, path = tempfile.mkstemp(prefix='b', dir=blob_dir)
        except OSError as e:
            _note_blob_failure(e)
            return False
        try:
            try:
                os.posix_fallocate(fd, 0, total)
                mm = mmap.mmap(fd, total)
            except OSError as e:
                os.close(fd)
                os.unlink(path)
                _note_blob_failure(e)
                return False
            try:
                buf = serializer.write_parts_into(parts, mm)
                buf.release()  # the mmap refuses to close with live views
            finally:
                try:
                    mm.close()
                except BufferError:
                    pass
                os.close(fd)
        except BaseException:
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        blob_fail['consecutive'] = 0
        send(MSG_BLOB, current['seq'], path.encode())
        return True

    def reserve_block(meta_entries, payload_max):
        """The in-place channel: reserve a contiguous ring slot, write the
        serializer header for a column layout known ahead of the decode, and
        hand back the payload region, so the fused native decode assembles
        the batch in the memory the consumer maps. Returns ``(payload_view,
        commit, abort)``, or None when the transport or serializer cannot
        serve it (callers use the copy path)."""
        if ring is None or not hasattr(serializer, 'frame_for_layout'):
            return None
        prefix = serializer.frame_for_layout(meta_entries)
        if prefix is None:
            return None
        header = ring_header(MSG_DATA, current['seq'])
        base = len(header) + len(prefix)
        try:
            mv = ring.reserve(base + payload_max, stop_check=check_finished)
        except ValueError:
            return None  # can never fit this ring: the copy path
        if mv is None:
            return None  # shutdown while waiting for space
        mv[:len(header)] = header
        mv[len(header):base] = prefix

        def commit(actual_payload=payload_max):
            ring.commit(base + actual_payload)
            publishes['publish_inplace'] += 1

        return mv[base:], commit, ring.abort

    def publish(data):
        # the payload is split once (serialize_parts) and every channel uses
        # the parts: under the blob threshold they gather-write straight
        # into the ring; at or above it they ride a blob, whose consumer
        # views are lazy copy-on-write maps; everything else goes in-band
        blob_live = blob_dir is not None and not blob_fail['disabled']
        parts = serializer.serialize_parts(data) if hasattr(serializer, 'serialize_parts') \
            else None
        if parts is not None:
            total = serializer.parts_size(parts)
            fits_ring = ring is not None and total + _RING_FRAMING <= ring.capacity
            if fits_ring and (not blob_live or total < blob_threshold):
                ring.writev([ring_header(MSG_DATA, current['seq'])] + parts,
                            stop_check=check_finished)
                publishes['publish_ring'] += 1
                return
            if blob_live and total >= blob_threshold and _try_blob_write(parts, total):
                publishes['publish_blob'] += 1
                return
            send(MSG_DATA, current['seq'], serializer.join_parts(parts))
        else:
            send(MSG_DATA, current['seq'], serializer.serialize(data))
        publishes[in_band] += 1

    # the row worker probes this attribute for the in-place mode
    publish.reserve_block = reserve_block

    def send_counts():
        """One ``MSG_METRICS`` frame: this process's cumulative route and
        publish counts, its registry snapshot and (at the spans level) its
        drained span events, sent before each item's completion message, so
        the consumer holds them once it sees the item complete. Cumulative,
        so the latest frame supersedes the earlier ones. Best effort: a
        failure here must not resend the completion."""
        from petastorm_tpu_torch.codecs import image_routes
        from petastorm_tpu_torch.native import read_routes
        try:
            rec = {'pid': os.getpid(), 'spawn': spawn, 'read_routes': read_routes.snapshot(),
                   'image_routes': image_routes.snapshot(), 'publishes': dict(publishes)}
            if obs.counters_on():
                rec['metrics'] = obs.snapshot()
                if obs.spans_on():
                    rec['events'] = obs.drain_trace_events()
            send(MSG_METRICS, None, pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception as e:  # noqa: BLE001 - counts are best effort
            logger.debug('sending counts failed: %s', e)

    worker = worker_class(worker_id, publish, worker_setup_args)
    send(MSG_STARTED, None)
    send_heartbeat(None)

    poller = zmq.Poller()
    poller.register(vent_recv, zmq.POLLIN)
    poller.register(control_recv, zmq.POLLIN)

    try:
        while True:
            events = dict(poller.poll(100))
            if control_recv in events and not finished['flag']:
                read_control()
            if finished['flag'] or finished['retire']:
                break
            if vent_recv in events:
                dispatch, args, kwargs, trace_ctx = vent_recv.recv_pyobj()
                current['seq'] = dispatch
                # claim first: if this item kills the process, the supervisor
                # knows what to requeue
                send_heartbeat(dispatch, blocking=True)
                try:
                    # the item stage keeps the flight recorder's activity slot
                    # set for the whole item; the item's trace context (minted
                    # in the consumer) parents the worker's stages
                    with obs.stage('item', cat='worker', dispatch=dispatch):
                        faults.on_item(kwargs)
                        with obs.use_trace(trace_ctx):
                            worker.process(*args, **kwargs)
                except Exception:  # noqa: BLE001 - forwarded to the consumer process
                    exc = sys.exc_info()[1]
                    logger.exception('Worker %d failed', worker_id)
                    report = {'tb': format_exception_tb(exc), 'worker_id': worker_id,
                              'pid': os.getpid()}
                    try:
                        blob = pickle.dumps(dict(report, exc=exc))
                    except Exception:  # noqa: BLE001 - unpicklable exception: a summary
                        blob = pickle.dumps(dict(report, exc=RuntimeError(
                            '{}: {}'.format(type(exc).__name__, exc))))
                    send_counts()
                    # the consumer decides the item's completion (requeue,
                    # quarantine or raise): no MSG_DONE here
                    send(MSG_ERROR, current['seq'], blob)
                else:
                    send_counts()
                    send(MSG_DONE, current['seq'])
                current['seq'] = None
            elif heartbeat_interval_s is not None \
                    and time.monotonic() - last_hb['t'] >= heartbeat_interval_s:
                send_heartbeat(None)
    finally:
        worker.shutdown()
        if fabric_node is not None:
            # flushes the client's last per-peer counters to its stats file
            fabric_node.stop()
        if ring is not None:
            ring.close()
        for sock in (vent_recv, result_send, control_recv):
            if sock is not None:
                sock.close()
        context.term()


def _start_orphan_monitor(main_pid):
    """Exit this worker when the consumer process is gone."""

    def monitor():
        while True:
            try:
                os.kill(main_pid, 0)
            except OSError:
                logger.warning('Main process %d is gone; worker exiting', main_pid)
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=monitor, daemon=True).start()
