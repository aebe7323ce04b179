"""Wire protocol of the chunk-transfer fabric (``docs/fabric.md``).

Twin of ``petastorm_tpu/fabric/protocol.py``, byte for byte on the wire, so a
JAX peer and a port peer of one pod serve each other. One request/response
exchange per connection, built from length-prefixed frames, so a reader
always knows how many bytes remain and a torn TCP stream surfaces as a
:class:`FabricProtocolError` (truncated frame), never as short data:

* **frame**: ``b'PTFB'`` magic + big-endian u32 body length + body;
* **request**: one JSON frame ``{"v": 1, "op": "get", "key": ..., "length": ...}``;
* **response**: one JSON header frame (``{"status": "ok", "length": N,
  "sha256": hex}`` / ``{"status": "miss"}`` / ``{"status": "error",
  "message": ...}``), then, for ``ok`` only, exactly N raw payload bytes.

The payload travels outside the JSON frame, so chunk bytes are never
base64-inflated, and its sha256 rides the header so the receiver verifies
the bytes before they reach the mirror.

Every socket operation here runs with an explicit per-operation timeout and
under a :class:`Deadline`, the end-to-end budget of one transfer across all
of its connects, sends and receives. Lint rule PT1500 (the JAX package's
``analysis/fabric_lints.py``) rejects fabric code that touches a socket
without both.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time

from petastorm_tpu_torch.errors import PetastormTpuError

MAGIC = b'PTFB'
VERSION = 1

#: bound on any frame body: a corrupt length prefix must not make the
#: receiver allocate unbounded memory (column chunks are row-group sized)
MAX_FRAME_BYTES = 512 * 2 ** 20

_HEADER = struct.Struct('>4sI')

#: recv granularity: large enough to amortize syscalls, small enough that a
#: per-operation timeout stays responsive on a stalled link
_IO_CHUNK = 256 * 1024


class FabricError(PetastormTpuError):
    """Base class of chunk-fabric transfer failures (all handled by the
    object-store fallback: a fabric error never fails the batch)."""


class FabricTimeout(FabricError):
    """A transfer's end-to-end deadline ran out."""


class FabricProtocolError(FabricError):
    """The peer sent bytes that do not parse as the fabric protocol, or the
    stream ended mid-frame (a torn or truncated transfer)."""


class Deadline(object):
    """End-to-end time budget for one logical transfer.

    Each socket operation asks :meth:`op_timeout` for its timeout: the
    per-operation cap, shrunk to what remains of the budget, so N slow
    operations cannot stack their timeouts past the transfer budget. An
    exhausted budget raises :class:`FabricTimeout` instead of returning a
    non-positive timeout.
    """

    __slots__ = ('budget_s', '_t_end', '_clock')

    def __init__(self, budget_s, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t_end = clock() + self.budget_s

    def remaining(self):
        """Seconds left in the budget (negative once expired)."""
        return self._t_end - self._clock()

    @property
    def expired(self):
        return self.remaining() <= 0.0

    def op_timeout(self, cap_s):
        """The timeout the next socket operation may use: ``min(cap_s,
        remaining)``. Raises :class:`FabricTimeout` when the budget is gone."""
        remaining = self.remaining()
        if remaining <= 0.0:
            raise FabricTimeout('fabric deadline of {:.3f}s exhausted'.format(self.budget_s))
        return min(float(cap_s), remaining)


def send_all(sock, data, deadline, io_timeout_s):
    """Send every byte of ``data``, re-arming the per-operation timeout from
    ``deadline`` before each partial send."""
    view = memoryview(data)
    sent = 0
    while sent < len(view):
        sock.settimeout(deadline.op_timeout(io_timeout_s))
        sent += sock.send(view[sent:sent + _IO_CHUNK])


def recv_exactly(sock, n, deadline, io_timeout_s):
    """Receive exactly ``n`` bytes or raise: EOF before ``n`` means the peer
    died or cut the stream, a truncated transfer."""
    parts = []
    got = 0
    while got < n:
        sock.settimeout(deadline.op_timeout(io_timeout_s))
        part = sock.recv(min(_IO_CHUNK, n - got))
        if not part:
            raise FabricProtocolError('peer closed the stream after {} of {} bytes '
                                      '(truncated transfer)'.format(got, n))
        parts.append(part)
        got += len(part)
    return b''.join(parts)


def send_frame(sock, body, deadline, io_timeout_s):
    """Send one length-prefixed frame."""
    if len(body) > MAX_FRAME_BYTES:
        raise FabricProtocolError('frame of {} bytes exceeds the {} byte bound'.format(
            len(body), MAX_FRAME_BYTES))
    send_all(sock, _HEADER.pack(MAGIC, len(body)) + bytes(body), deadline, io_timeout_s)


def recv_frame(sock, deadline, io_timeout_s, max_bytes=MAX_FRAME_BYTES):
    """Receive one length-prefixed frame body."""
    magic, length = _HEADER.unpack(recv_exactly(sock, _HEADER.size, deadline, io_timeout_s))
    if magic != MAGIC:
        raise FabricProtocolError('bad frame magic {!r} (not a fabric peer?)'.format(magic))
    if length > max_bytes:
        raise FabricProtocolError('frame length {} exceeds the {} byte bound'.format(
            length, max_bytes))
    return recv_exactly(sock, length, deadline, io_timeout_s)


# -- message encoding --------------------------------------------------------

def encode_request(key, length):
    return json.dumps({'v': VERSION, 'op': 'get', 'key': key,
                       'length': int(length)}).encode('utf-8')


def encode_ok(length, sha256_hex):
    return json.dumps({'v': VERSION, 'status': 'ok', 'length': int(length),
                       'sha256': sha256_hex}).encode('utf-8')


def encode_miss():
    return json.dumps({'v': VERSION, 'status': 'miss'}).encode('utf-8')


def encode_error(message):
    return json.dumps({'v': VERSION, 'status': 'error',
                       'message': str(message)[:512]}).encode('utf-8')


def decode_message(body):
    """Decode a JSON control frame, raising :class:`FabricProtocolError` on
    anything that does not parse as one."""
    try:
        msg = json.loads(body.decode('utf-8'))
    except (UnicodeDecodeError, ValueError) as e:
        raise FabricProtocolError('unparseable control frame: {}'.format(e))
    if not isinstance(msg, dict):
        raise FabricProtocolError('control frame is not an object')
    return msg


def content_hash(data):
    """The digest every ``ok`` header carries: bytes that do not match it
    are discarded, never written to the mirror."""
    return hashlib.sha256(data).hexdigest()


__all__ = ['Deadline', 'FabricError', 'FabricProtocolError', 'FabricTimeout', 'MAGIC',
           'MAX_FRAME_BYTES', 'VERSION', 'content_hash', 'decode_message', 'encode_error',
           'encode_miss', 'encode_ok', 'encode_request', 'recv_exactly', 'recv_frame',
           'send_all', 'send_frame']
