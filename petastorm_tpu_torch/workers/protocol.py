"""The worker-pool wire protocol: message kinds, ring framing, dispatch ids.

Twin of ``petastorm_tpu/workers/protocol.py``, with the same byte values, so
a ring message framed by either package reads the same in the other:

* Workers send messages over a per-worker FIFO results channel (shm ring or
  zmq PUSH). The first byte of every message is its *kind*.
* Every ventilated item carries a pool-assigned *dispatch id*, monotonically
  increasing and never reused. A requeued item gets a fresh id; a message
  tagged with a superseded id is stale and is dropped.
* A worker claims the item it is processing (``MSG_HEARTBEAT`` with
  ``busy=<dispatch id>``) before processing it; the item's ``MSG_DONE`` or
  ``MSG_ERROR`` releases the claim (the channel is FIFO, so the claim always
  precedes its item's completion).

The serve plane's frame kinds (``SERVE_*``) frame daemon -> consumer traffic
on the broadcast ring (``native/shm_ring.BcastRing``), with the same ring
header; the pools' consumer loops never see them.
"""

from __future__ import annotations

import struct

#: control-channel (PUB/SUB) shutdown broadcast; not a results-channel kind
CONTROL_FINISHED = b'FINISHED'
#: control-channel prefix retiring one worker slot: ``CONTROL_RETIRE + b'<id>'``
#: (the port's graceful retire; the JAX pool terminates the process)
CONTROL_RETIRE = b'RETIRE:'

# -- results-channel message kinds (the first byte of every message) --------

MSG_STARTED = b'S'    #: startup handshake: worker connected and reported in
MSG_DATA = b'D'       #: an item's serialized payload, in-band
MSG_DONE = b'F'       #: item completion sentinel (releases the claim)
MSG_ERROR = b'E'      #: pickled worker-side exception report (releases the claim)
MSG_BLOB = b'B'       #: an item's payload parked in a /dev/shm blob; payload = path
MSG_METRICS = b'M'    #: cumulative counts, metrics snapshot and span events piggyback
MSG_HEARTBEAT = b'H'  #: liveness + item-ownership beacon (claim when busy is set)

# -- serve-plane frame kinds (daemon -> consumers, on the broadcast ring) ---

SERVE_DATA = b'd'    #: one decoded batch payload, in-band (serializer framing)
SERVE_BLOB = b'b'    #: one decoded batch parked in a shared /dev/shm blob;
                     #: payload = ``<size>|<path>``: consumers map it
                     #: copy-on-write and the daemon reclaims the file once
                     #: every consumer's ring cursor passed the frame
SERVE_COLS = b'c'    #: a fused batch decoded straight into a shared blob:
                     #: payload = pickled ``{'path','size','rows','cols'}``
                     #: column layout; consumers view the mapping in place
SERVE_DONE = b'f'    #: item completion sentinel (carries the item seq)
SERVE_END = b'z'     #: per-tenant end of stream: the tenant's epochs finished
SERVE_ERROR = b'e'   #: pickled daemon-side error report; the stream is over

#: every serve-plane frame kind, in protocol order
SERVE_KINDS = (SERVE_DATA, SERVE_BLOB, SERVE_COLS, SERVE_DONE, SERVE_END,
               SERVE_ERROR)

# -- shm-ring framing -------------------------------------------------------

#: ring message header: kind byte + little-endian int64 dispatch id (-1 = None)
RING_HEADER_LEN = 9


def ring_header(kind, dispatch):
    """Ring message framing: kind byte + little-endian int64 dispatch id
    (-1 = None), then the payload; header and payload are gather-written as
    one message."""
    return kind + struct.pack('<q', -1 if dispatch is None else dispatch)


def ring_unpack(view):
    """``(kind, dispatch, payload_view)`` from a message memoryview; the
    payload stays a view handed straight to the deserializer."""
    dispatch = struct.unpack_from('<q', view, 1)[0]
    return bytes(view[0:1]), (None if dispatch < 0 else dispatch), view[RING_HEADER_LEN:]


# -- dispatch ids -----------------------------------------------------------

class DispatchIds(object):
    """Monotonic dispatch-id allocator. Ids are never reused: a requeued item
    gets a fresh id so straggler messages from its previous attempt are
    recognizable as stale, which is what makes each item complete exactly
    once. Not thread-safe by itself; callers allocate under their own lock."""

    __slots__ = ('_next',)

    def __init__(self, start=0):
        self._next = start

    def peek(self):
        """The id :meth:`next` returns next."""
        return self._next

    def next(self):
        d = self._next
        self._next += 1
        return d
