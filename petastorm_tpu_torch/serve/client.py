"""Consumer side of the shared reader service: spawn or join, then
:class:`ServedReader`.

Twin of ``petastorm_tpu/serve/client.py``. ``make_reader(serve='auto' |
<service dir>)`` lands here: the client resolves the service directory,
joins the running daemon (or wins the ``O_EXCL`` spawn race and starts one),
sends its stream spec over the control socket, and gets back a broadcast
ring name, a consumer token and the client half of the read plan.
:class:`ServedReader` is then a drop-in reader: the same iterator,
``diagnostics`` and ``stop``/``join``, with the pool replaced by a facade
that reads frames off the fan-out ring.

The 'auto' directory is the port's own (:func:`default_service_dir`), not the
JAX package's, so a port client never joins a JAX daemon on the same host or
the reverse.

Failures: a daemon crash raises
:class:`~petastorm_tpu_torch.errors.ServeDaemonDiedError` instead of
waiting; an eviction raises
:class:`~petastorm_tpu_torch.errors.ConsumerEvictedError`; a tenant's clean
end of stream is a normal ``StopIteration``.
"""

from __future__ import annotations

import logging
import mmap
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.errors import (ConsumerEvictedError, EmptyResultError,
                                        ServeDaemonDiedError, ServeError)
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.serve.service import (LOCK_FILE, endpoint_path, read_endpoint,
                                               refuse_monitor)
from petastorm_tpu_torch.workers.protocol import (SERVE_BLOB, SERVE_COLS, SERVE_DATA,
                                                  SERVE_DONE, SERVE_END, SERVE_ERROR,
                                                  ring_unpack)

logger = logging.getLogger(__name__)

_SPAWN_TIMEOUT_S = 30.0
#: liveness-probe period while blocked on a quiet ring
_LIVENESS_PERIOD_S = 1.0


def default_service_dir():
    """The 'auto' service directory, one daemon per host and user:
    ``$PSTPU_TORCH_SERVE_DIR``, else ``$TMPDIR/pstpu-torch-serve-<uid>``
    (the JAX package's is ``pstpu-serve-<uid>``)."""
    base = os.environ.get('PSTPU_TORCH_SERVE_DIR')
    if base:
        return base
    return os.path.join(tempfile.gettempdir(), 'pstpu-torch-serve-{}'.format(os.getuid()))


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    # signal 0 succeeds on a zombie too, and a daemon this process spawned
    # becomes one when it dies (nothing reaps it until exit): that would turn
    # "the daemon crashed" into an endless liveness loop
    try:
        with open('/proc/{}/stat'.format(pid)) as f:
            # field 3, after the parenthesized comm (which may hold spaces)
            return f.read().rsplit(')', 1)[-1].split()[0] != 'Z'
    except (OSError, IndexError):
        return True  # no procfs: assume alive (the conservative direction)


def _spawn_daemon(service_dir, spawn_args):
    """Launch the daemon process (its own session; it logs into the service
    directory). The caller holds the ``O_EXCL`` lock."""
    argv = [sys.executable, '-m', 'petastorm_tpu_torch.serve', '--service-dir', service_dir]
    for key, flag in (('pool_type', '--pool-type'),
                      ('workers_count', '--workers-count'),
                      ('ring_bytes', '--ring-bytes'),
                      ('idle_timeout_s', '--idle-timeout'),
                      ('evict_block_s', '--evict-block'),
                      ('telemetry', '--telemetry')):
        value = spawn_args.get(key)
        if value is not None:
            argv += [flag, str(value)]
    if spawn_args.get('telemetry') is None and obs.spans_on():
        # a tracing client spawns a tracing daemon: else a served batch's tree
        # has a client half only
        argv += ['--telemetry', 'spans']
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env['PYTHONPATH'] = pkg_parent + os.pathsep + env.get('PYTHONPATH', '')
    log_path = os.path.join(service_dir, 'daemon.log')
    with open(log_path, 'ab') as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=log, start_new_session=True, env=env)
    logger.info('spawned serve daemon pid %d (dir=%s, log=%s)', proc.pid, service_dir, log_path)
    return proc


def connect_service(service_dir, spawn_args=None, timeout_s=_SPAWN_TIMEOUT_S):
    """Join the daemon of ``service_dir``, spawning one through the
    ``O_EXCL`` handshake when none runs. Returns an open control
    connection."""
    from multiprocessing.connection import Client
    service_dir = os.path.abspath(service_dir)
    os.makedirs(service_dir, exist_ok=True)
    lock_path = os.path.join(service_dir, LOCK_FILE)
    deadline = time.monotonic() + timeout_s
    spawned = False
    while time.monotonic() < deadline:
        endpoint = read_endpoint(service_dir)
        if endpoint is not None:
            if not _pid_alive(endpoint['pid']):
                # a dead daemon's endpoint: clear it and the lock, so the
                # spawn race can run again
                for p in (endpoint_path(service_dir), lock_path):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            else:
                try:
                    conn = Client(endpoint['address'], family='AF_UNIX')
                    conn.send({'op': 'ping'})
                    if conn.recv().get('ok'):
                        return conn
                    conn.close()
                except (OSError, EOFError):
                    time.sleep(0.05)
                    continue
        if not spawned:
            try:
                fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                _spawn_daemon(service_dir, spawn_args or {})
                spawned = True
            except FileExistsError:
                # another process won the race (or a daemon is starting up);
                # clear a stale lock whose owner died before publishing
                try:
                    with open(lock_path) as f:
                        owner = int(f.read().strip() or '0')
                    if owner and not _pid_alive(owner) and read_endpoint(service_dir) is None:
                        os.unlink(lock_path)
                except (OSError, ValueError):
                    pass
        time.sleep(0.05)
    raise ServeError('no serve daemon reachable under {} within {}s (see {} for daemon-side '
                     'errors)'.format(service_dir, timeout_s,
                                      os.path.join(service_dir, 'daemon.log')))


def _map_blob(path, size, tenant_id):
    """Map a served batch's blob copy-on-write: ``(memoryview, slot)``,
    writable views with no upfront copy. The mapping, not the name, keeps
    the pages alive past the daemon's reclaim. A blob already gone means
    this consumer fell behind the daemon's GC horizon: raised like an
    eviction, never a hang or torn data.

    :borrows: the view borrows the mapping; the caller adopts the batch's
        arrays into ``slot`` (``native/lifetime.py``) and seals it, so the
        map closes exactly when the batch dies and counts in
        ``lifetime_live_borrows`` while it lives."""
    try:
        with open(path, 'rb') as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            mm.madvise(mmap.MADV_WILLNEED)  # fault the pages in-kernel, not one by one
        except (AttributeError, OSError):
            pass
    except OSError as e:
        raise ConsumerEvictedError(
            'served batch blob {} was reclaimed before this consumer mapped it (the consumer '
            'is far behind the others): {}; consume faster or raise the daemon blob '
            'budget'.format(path, e), tenant_id=tenant_id)

    def _close():
        try:
            mm.close()
        except BufferError:
            pass  # a straggler export closes it when the GC drops the chain

    slot = lifetime_registry().open_slot(on_release=_close, label='serve-blob')
    return memoryview(mm)[:size], slot  # noqa: PT500 - registered with the lifetime registry


class _ServedPoolFacade(object):
    """The pool surface the results readers consume (``get_results``,
    ``last_result_seq``, ``done_callback``) over a broadcast-ring consumer
    slot."""

    def __init__(self, ring, token, daemon_pid, tenant_id, trace_ns=None):
        self._ring = ring
        self._token = token
        self._daemon_pid = daemon_pid
        self._tenant_id = tenant_id
        # the broker's trace namespace (attach reply): each frame's trace root
        # derives from the seq in the ring header, so the client's spans join
        # the daemon's tree with no extra bytes on the wire
        self._trace_ns = trace_ns
        self._serializer = NumpyBlockSerializer()
        self._stopped = False
        self._ended = False
        self.last_result_seq = None
        self.done_callback = None
        self.batches_received = 0
        self.bytes_received = 0
        #: batches received per frame kind: in-band, by blob, fused into a blob
        self.frames = {'data': 0, 'blob': 0, 'cols': 0}
        self.last_result_trace = None

    def _note_result(self, seq, kind):
        """Bookkeeping shared by every frame kind that carries a batch."""
        self.frames[kind] += 1
        self.last_result_seq = seq
        if self._trace_ns is not None and seq is not None and obs.spans_on():
            self.last_result_trace = obs.trace_root(self._trace_ns, seq)
        self.batches_received += 1

    def get_results(self):
        with obs.stage('pool_wait', cat='pool') as sp:
            payload = self._get_results()
            # the frame's identity is known only after the read: the wait
            # span joins the batch's tree afterwards
            sp.link(self.last_result_trace)
            return payload

    def _get_results(self):
        from petastorm_tpu_torch.native.shm_ring import BcastConsumerGone
        while True:
            if self._ended:
                raise EmptyResultError()
            try:
                view = self._ring.read_view(self._token, stop_check=lambda: self._stopped,
                                            timeout_s=_LIVENESS_PERIOD_S)
            except BcastConsumerGone as e:
                if e.evicted:
                    raise ConsumerEvictedError(
                        'this consumer was evicted by the serve daemon (it lagged far enough '
                        'to stall the others); consume faster, raise serve ring_bytes, or '
                        're-attach', tenant_id=self._tenant_id)
                raise ServeError('serve consumer slot was released (detached elsewhere?)')
            if view is None:
                if self._stopped:
                    raise EmptyResultError()
                if not _pid_alive(self._daemon_pid):
                    raise ServeDaemonDiedError(
                        'serve daemon (pid {}) died with this consumer attached; re-run '
                        'make_reader(serve=...) to spawn a replacement'.format(
                            self._daemon_pid))
                continue
            kind, seq, payload = ring_unpack(view)
            if kind == SERVE_DATA:
                self._note_result(seq, 'data')
                self.bytes_received += len(payload)
                return self._serializer.deserialize(payload)
            if kind == SERVE_COLS:
                # the fused decode wrote the batch into the blob: typed views
                # over the copy-on-write mapping, from the layout descriptor
                desc = pickle.loads(bytes(payload))
                self._note_result(seq, 'cols')
                self.bytes_received += desc['size']
                mv, slot = _map_blob(desc['path'], desc['size'], self._tenant_id)
                block = {}
                for name, dtype_str, shape, off, nbytes in desc['cols']:
                    block[name] = np.frombuffer(mv[off:off + nbytes],
                                                dtype=np.dtype(dtype_str)).reshape(shape)
                slot.adopt(block)
                slot.seal()
                return block
            if kind == SERVE_BLOB:
                # the batch sits in a shared /dev/shm blob: map it copy-on-write;
                # the daemon reclaims the file once every cursor passed this
                # frame (plus a grace covering this very window)
                size_s, path = bytes(payload).decode().split('|', 1)
                self._note_result(seq, 'blob')
                self.bytes_received += int(size_s)
                mv, slot = _map_blob(path, int(size_s), self._tenant_id)
                result = self._serializer.deserialize(mv)
                slot.adopt(result)
                slot.seal()
                return result
            if kind == SERVE_DONE:
                if self.done_callback is not None and seq is not None:
                    self.done_callback(seq)
            elif kind == SERVE_END:
                self._ended = True
                raise EmptyResultError()
            elif kind == SERVE_ERROR:
                try:
                    err = pickle.loads(bytes(payload))
                except Exception:  # noqa: BLE001 - a garbled report must still fail loudly
                    err = ServeError('serve daemon reported an unreadable error')
                raise ServeError('serve daemon stream failed: {}'.format(err))
            else:
                logger.warning('dropping serve frame with unknown kind %r', kind)

    def stop(self):
        self._stopped = True

    @property
    def diagnostics(self):
        out = {'serve_batches_received': self.batches_received,
               'serve_bytes_received': self.bytes_received}
        out.update({'serve_frames_' + k: v for k, v in self.frames.items()})
        out.update(lifetime_registry().counters())
        return out


class ServedReader(object):
    """A drop-in reader over a shared serve daemon.

    Iterates like the reader it replaces (rows, columnar blocks or
    rebatched blocks, as the ``make_reader`` arguments say), but the decode
    runs once in the per-host daemon however many local consumers attach.
    Not supported when served: ``resume_state`` and :meth:`state_dict` (the
    stream is shared; this consumer has no read position of its own) and
    ``autotune`` (the daemon owns the fleet); the factories refuse them.
    """

    def __init__(self, conn, reply, results_queue_reader_factory, service_dir):
        self._conn = conn
        self._service_dir = service_dir
        self.tenant_id = reply['tenant_id']
        self.stream_id = reply['stream_id']
        self.daemon_pid = reply['daemon_pid']
        plan = reply['client_plan']
        self.schema = plan['schema']
        self.output_schema = plan['output_schema']
        self.transformed_schema = plan['transformed_schema']
        self.ngram = plan['ngram']
        from petastorm_tpu_torch.native.shm_ring import BcastRing
        self._ring = BcastRing.attach(reply['ring_name'])
        self._facade = _ServedPoolFacade(self._ring, reply['token'], reply['daemon_pid'],
                                         self.tenant_id, trace_ns=reply.get('trace_ns'))
        self._results_queue_reader = results_queue_reader_factory(self.transformed_schema)
        self.last_row_consumed = False
        self._stopped = False
        # the flight recorder: a wedged served consumer beside a dead daemon
        # pid is the post-mortem pairing to look for
        flight = blackbox.maybe_enable('serve-client')
        if flight is not None:
            flight.record(blackbox.K_EVENT,
                          {'event': 'serve_attach', 'tenant_id': self.tenant_id,
                           'stream_id': self.stream_id, 'daemon_pid': reply['daemon_pid']})

    @property
    def batched_output(self):
        return self._results_queue_reader.batched_output

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self._results_queue_reader.read_next(self._facade)
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration

    def reset(self):
        raise ServeError('reset() is not supported on a served reader: the stream is shared. '
                         'Re-attach with make_reader(serve=...) for another pass.')

    def state_dict(self):
        raise ServeError('state_dict() is not supported on a served reader: the read position '
                         'belongs to the shared stream, not to this consumer.')

    @property
    def quarantined_items(self):
        return []

    @property
    def diagnostics(self):
        """This process's counters and this tenant's serving stats from the
        daemon (fair-share occupancy, shared-decode hits)."""
        diag = obs.flatten_snapshot(obs.snapshot())
        diag.update(self._facade.diagnostics)
        stats = self.service_stats()
        if stats is not None:
            stream = stats.get('streams', {}).get(self.stream_id, {})
            tenant = stream.get('tenants', {}).get(self.tenant_id, {})
            diag.update({'serve_tenant_' + k: v for k, v in tenant.items()
                         if not isinstance(v, dict)})
            fair = stream.get('fair_share', {})
            if 'occupancy' in fair:
                diag['serve_fair_share_occupancy'] = fair['occupancy']
            diag['serve_stream_decoded_batches'] = stream.get('decoded_batches', 0)
            diag['serve_evictions'] = stats.get('evictions', 0)
        return diag

    @property
    def last_trace(self):
        """The virtual-root trace context of the last delivered batch
        (derived from the frame's seq and the daemon's ``trace_ns``)."""
        return self._facade.last_result_trace

    def service_stats(self):
        """The daemon's stats document, or None when it is unreachable."""
        if self._conn is None:
            return None
        try:
            self._conn.send({'op': 'stats'})
            reply = self._conn.recv()
            return reply.get('stats') if reply.get('ok') else None
        except (OSError, EOFError, ValueError):
            return None

    def service_trace_events(self, absorb=True):
        """A snapshot of the daemon's span ring (ventilate, worker and pool
        spans), for a served batch's whole cross-process tree; merged into
        this process's ring with ``absorb``. [] when the daemon is
        unreachable."""
        if self._conn is None:
            return []
        try:
            self._conn.send({'op': 'trace'})
            reply = self._conn.recv()
        except (OSError, EOFError, ValueError):
            return []
        events = (reply.get('events') if reply.get('ok') else None) or []
        if absorb:
            obs.absorb_trace_events(events)
        return events

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._facade.stop()
        if self._conn is not None:
            try:
                self._conn.send({'op': 'detach', 'tenant_id': self.tenant_id})
                self._conn.recv()
            except (OSError, EOFError, ValueError):
                pass  # the daemon is gone already: nothing to release
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def join(self):
        if self._ring is not None:
            self._ring.close()
            self._ring = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if not self._stopped:
            self.stop()
            self.join()


def make_served_reader(spec, serve, results_queue_reader_factory, weight=1, spawn_args=None,
                       monitor=None):
    """Attach ``spec`` to the service of ``serve`` ('auto' or a service
    directory), spawning the daemon when none runs. Returns a
    :class:`ServedReader`. ``monitor`` (the protocol monitor) is not ported
    yet and raises when asked for."""
    refuse_monitor(monitor)
    service_dir = default_service_dir() if serve in (True, 'auto') else str(serve)
    conn = connect_service(service_dir, spawn_args=spawn_args)
    conn.send({'op': 'attach', 'spec': spec, 'weight': weight})
    reply = conn.recv()
    if not reply.get('ok'):
        try:
            conn.close()
        except OSError:
            pass
        raise ServeError('serve attach failed: {}'.format(reply.get('error')))
    return ServedReader(conn, reply, results_queue_reader_factory, service_dir)


__all__ = ['ServedReader', 'connect_service', 'default_service_dir', 'make_served_reader']
