"""Fabric serving side: a daemon thread that streams mirrored chunks.

Twin of ``petastorm_tpu/fabric/server.py``. One listener socket, one
accept-loop daemon thread, and one short-lived handler thread per
connection (a connection carries one request/response exchange, so a
handler is bounded by the request deadline). The server never fetches: it
answers ``miss`` for chunks its :class:`~petastorm_tpu_torch.chunkstore.
store.ChunkStore` does not mirror, and the asking client falls back to the
object store.

While a chunk is read and streamed, its mirror is pinned through
:meth:`ChunkStore.pin_for_send`, so the evictor refuses it (a counted skip)
instead of unlinking a file under an in-flight transfer.

Injected network faults (``faults.NetFaultPlan``) act at the payload send:
a stall sleeps before the body (the window in which a chaos driver
SIGKILLs a peer), a reset aborts the TCP stream mid-body, a truncation
closes it cleanly half-way, a corruption flips bytes. The header's content
hash is always of the true bytes, so the receiver detects every
destructive fault.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.fabric import protocol as P
from petastorm_tpu_torch.observability import blackbox

logger = logging.getLogger(__name__)

#: accept-loop poll period: how fast stop() is noticed, not a request timeout
_ACCEPT_POLL_S = 0.2


class FabricServer(object):
    """Chunk-serving daemon over one host's chunk mirror.

    :param store: the host's :class:`ChunkStore`
    :param listen_host: bind address (default loopback; a pod binds its
        pod-network interface)
    :param port: bind port (0: ephemeral; read :attr:`endpoint`)
    :param io_timeout_s: per-socket-operation timeout
    :param request_deadline_s: end-to-end budget of one exchange: a client
        that stops reading cannot hold a handler thread forever
    :param on_request: optional callable ``(key)`` called when a request
        arrives (chaos drills mark "a transfer is in flight" with it)
    """

    def __init__(self, store, listen_host='127.0.0.1', port=0, io_timeout_s=2.0,
                 request_deadline_s=30.0, on_request=None):
        self._store = store
        self._listen_host = listen_host
        self._port = int(port)
        self.io_timeout_s = float(io_timeout_s)
        self.request_deadline_s = float(request_deadline_s)
        self._on_request = on_request
        self._sock = None
        self._thread = None
        self._stop = threading.Event()
        self._endpoint = None

    @property
    def endpoint(self):
        """``(address, port)`` once started, else None."""
        return self._endpoint

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Bind, listen and start the accept-loop daemon thread."""
        if self._thread is not None:
            return self
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self._listen_host, self._port))
            sock.listen(16)
            sock.settimeout(_ACCEPT_POLL_S)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._endpoint = sock.getsockname()[:2]
        self._stop.clear()
        self._thread = threading.Thread(target=self._accept_loop, args=(sock,),
                                        name='pstpu-torch-fabric-serve', daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting, join the accept loop and close the listener.
        In-flight handlers finish their deadline-bounded exchange alone."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=_ACCEPT_POLL_S * 10)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._endpoint = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- serving -------------------------------------------------------------

    def _accept_loop(self, sock):
        while not self._stop.is_set():
            try:
                sock.settimeout(_ACCEPT_POLL_S)
                conn, addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed
            threading.Thread(target=self._handle, args=(conn, addr),
                             name='pstpu-torch-fabric-handler', daemon=True).start()

    def _handle(self, conn, addr):
        try:
            deadline = P.Deadline(self.request_deadline_s)
            msg = P.decode_message(P.recv_frame(conn, deadline, self.io_timeout_s))
            if msg.get('op') != 'get':
                P.send_frame(conn, P.encode_error('unsupported op {!r}'.format(msg.get('op'))),
                             deadline, self.io_timeout_s)
                return
            key = msg.get('key')
            length = int(msg.get('length') or 0)
            if not isinstance(key, str) or length <= 0:
                P.send_frame(conn, P.encode_error('malformed get request'), deadline,
                             self.io_timeout_s)
                return
            if self._on_request is not None:
                self._on_request(key)
            with obs.stage('fabric_serve', cat='fabric', bytes=length):
                self._serve_chunk(conn, key, length, deadline)
        except (OSError, P.FabricError) as e:
            # a dead or flaky client is not this host's problem
            logger.debug('fabric handler for %s failed: %s', addr, e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_chunk(self, conn, key, length, deadline):
        with self._store.pin_for_send(key) as path:
            data = None
            if path is not None:
                try:
                    with open(path, 'rb') as f:
                        data = f.read()
                except OSError:
                    data = None
            if data is None or len(data) != length:
                P.send_frame(conn, P.encode_miss(), deadline, self.io_timeout_s)
                return
            # the header's hash is of the true bytes: every injected
            # corruption or truncation below is detectable by the receiver
            digest = P.content_hash(data)
            action = faults.net_payload_action()
            kind = action[0] if action is not None else None
            if kind == 'corrupt':
                corrupted = bytearray(data)
                corrupted[len(corrupted) // 2] ^= 0xFF
                corrupted[0] ^= 0xFF
                data = bytes(corrupted)
            P.send_frame(conn, P.encode_ok(length, digest), deadline, self.io_timeout_s)
            if kind == 'stall':
                self._stall(action[1])
            if kind in ('reset', 'truncate'):
                P.send_all(conn, data[:length // 2], deadline, self.io_timeout_s)
                if kind == 'reset':
                    # RST instead of FIN: the client sees ECONNRESET mid-body
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack('ii', 1, 0))
                return
            P.send_all(conn, data, deadline, self.io_timeout_s)
        obs.count('fabric_chunks_served')
        obs.count('fabric_bytes_served', length)
        blackbox.record_event({'kind': 'fabric', 'op': 'serve', 'key': key, 'bytes': length})

    def _stall(self, stall_s):
        """Sleep in small slices, so stop() is honoured mid-stall."""
        t_end = time.monotonic() + float(stall_s)
        while time.monotonic() < t_end and not self._stop.is_set():
            time.sleep(min(0.05, max(0.0, t_end - time.monotonic())))


__all__ = ['FabricServer']
