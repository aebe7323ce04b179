"""ctypes bindings for the shared-memory SPSC ring (``shm_ring.cpp``).

Twin of the ring half of ``petastorm_tpu/native/shm_ring.py``: one ring per
worker process, worker -> main. The C primitives never block; blocking, with
a stop-aware sleep-poll, lives here. The library is built by g++ at first use
into ``.torch_build/native/libpstpu_torch_ring.so`` (``build.build_ring``);
any build or load failure makes :func:`is_available` False and the process
pool then uses its zmq transport. The ring layout is the JAX package's, so a
ring created by either package can be attached by the other.

The broadcast ring (:class:`BcastRing`, ``pstpu_bcast_*``) is the serve
daemon's fan-out transport: one producer, up to eight consumers, each with
its own read cursor.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

_lib = None
_lib_lock = threading.Lock()
_load_failed = False

DEFAULT_RING_BYTES = 64 << 20

#: bytes of framing a message takes in the ring beyond its payload: the
#: 8-byte length prefix
MESSAGE_OVERHEAD = 8


class RingHeaderStruct(ctypes.Structure):
    """Field-for-field mirror of ``struct RingHeader`` (shm_ring.cpp): the
    shared-memory segment layout both sides of the ring map. Python never
    touches the header (all access goes through the C API); the mirror
    documents the cross-process layout and the ABI rules check it against
    the C struct."""

    _fields_ = [
        ('head', ctypes.c_uint64),
        ('tail', ctypes.c_uint64),
        ('capacity', ctypes.c_uint64),
        ('magic', ctypes.c_uint64),
        ('pad', ctypes.c_char * 32),
    ]


#: byte offset of the ring's data area inside the shm segment
RING_HEADER_BYTES = ctypes.sizeof(RingHeaderStruct)

#: broadcast-ring consumer slots per segment (``kBcastSlots`` in
#: shm_ring.cpp; the ABI rules check the whole header, which pins this too)
BCAST_MAX_CONSUMERS = 8


class BcastHeaderStruct(ctypes.Structure):
    """Field-for-field mirror of ``struct BcastHeader`` (shm_ring.cpp): the
    broadcast segment the serve daemon and its consumers map. Python never
    touches the header (all access goes through the C API); the mirror
    documents the layout and the ABI rules check it against the C struct."""

    _fields_ = [
        ('tail', ctypes.c_uint64),
        ('capacity', ctypes.c_uint64),
        ('magic', ctypes.c_uint64),
        ('max_consumers', ctypes.c_uint64),
        ('epoch', ctypes.c_uint64),
        ('pad0', ctypes.c_char * 24),
        ('heads', ctypes.c_uint64 * 8),
        ('states', ctypes.c_uint64 * 8),
        ('gens', ctypes.c_uint64 * 8),
    ]


#: byte offset of the broadcast ring's data area inside the shm segment
BCAST_HEADER_BYTES = ctypes.sizeof(BcastHeaderStruct)


class IdleWait(object):
    """Escalating wait for ring poll loops: spin, then ``sched_yield``, then
    sleeps that double up to ``max_sleep_s``. The first misses stay free of
    latency; an idle peer does not keep a core busy (many attached serve
    consumers would otherwise burn cores polling a quiet daemon). Spins count
    into ``ring_idle_spins``, flushed in batches so the hot loop never takes
    the metrics lock. Call :meth:`wait` per empty poll and :meth:`reset` on
    progress."""

    __slots__ = ('_spins', '_yields', '_sleep_s', '_max_sleep_s', '_misses', '_cur_sleep',
                 '_pending_spins')

    def __init__(self, spins=64, yields=64, sleep_s=0.0002, max_sleep_s=0.002):
        self._spins = spins
        self._yields = yields
        self._sleep_s = sleep_s
        self._max_sleep_s = max_sleep_s
        self._misses = 0
        self._cur_sleep = sleep_s
        self._pending_spins = 0

    def _flush(self):
        if self._pending_spins:
            from petastorm_tpu_torch import observability as obs
            obs.count('ring_idle_spins', self._pending_spins)
            self._pending_spins = 0

    def wait(self):
        """One empty-poll step: spin, yield, or sleep per the escalation."""
        self._misses += 1
        if self._misses <= self._spins:
            self._pending_spins += 1
            return
        if self._misses <= self._spins + self._yields:
            os.sched_yield()
            return
        if self._misses == self._spins + self._yields + 1:
            self._flush()  # entering the sleep tier: the peer is idle
        time.sleep(self._cur_sleep)
        self._cur_sleep = min(self._cur_sleep * 2, self._max_sleep_s)

    def reset(self):
        """Progress was made: restart the escalation at the spin tier."""
        if self._misses:
            self._flush()
            self._misses = 0
            self._cur_sleep = self._sleep_s


def bind(lib):
    """Declare the C signatures of the SPSC ring and the guard on a loaded
    library; returns it."""
    lib.pstpu_ring_create.restype = ctypes.c_void_p
    lib.pstpu_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.pstpu_ring_attach.restype = ctypes.c_void_p
    lib.pstpu_ring_attach.argtypes = [ctypes.c_char_p]
    lib.pstpu_ring_last_error.restype = ctypes.c_char_p
    lib.pstpu_ring_capacity.restype = ctypes.c_uint64
    lib.pstpu_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.pstpu_ring_free_space.restype = ctypes.c_uint64
    lib.pstpu_ring_free_space.argtypes = [ctypes.c_void_p]
    lib.pstpu_ring_write.restype = ctypes.c_int
    lib.pstpu_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.pstpu_ring_write2.restype = ctypes.c_int
    lib.pstpu_ring_write2.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_uint64]
    lib.pstpu_ring_writev.restype = ctypes.c_int
    lib.pstpu_ring_writev.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32]
    lib.pstpu_ring_reserve.restype = ctypes.c_void_p
    lib.pstpu_ring_reserve.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.POINTER(ctypes.c_int32)]
    lib.pstpu_ring_commit.restype = ctypes.c_int
    lib.pstpu_ring_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.pstpu_ring_abort.argtypes = [ctypes.c_void_p]
    lib.pstpu_ring_next_len.restype = ctypes.c_int64
    lib.pstpu_ring_next_len.argtypes = [ctypes.c_void_p]
    lib.pstpu_ring_read.restype = ctypes.c_int64
    lib.pstpu_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    # zero-copy consumer views and the slot-lifetime guard
    lib.pstpu_ring_peek.restype = ctypes.c_longlong
    lib.pstpu_ring_peek.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong),
                                    ctypes.c_ulonglong]
    lib.pstpu_ring_peek_copy.restype = ctypes.c_longlong
    lib.pstpu_ring_peek_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                                         ctypes.POINTER(ctypes.c_ulonglong)]
    lib.pstpu_ring_has_unread.restype = ctypes.c_int
    lib.pstpu_ring_has_unread.argtypes = [ctypes.c_void_p]
    lib.pstpu_ring_release.restype = ctypes.c_int
    lib.pstpu_ring_release.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    lib.pstpu_guard_protect.restype = ctypes.c_longlong
    lib.pstpu_guard_protect.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int]
    lib.pstpu_ring_close.argtypes = [ctypes.c_void_p]
    # the broadcast ring (one producer, many consumers): the serve plane
    lib.pstpu_bcast_create.restype = ctypes.c_void_p
    lib.pstpu_bcast_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.pstpu_bcast_attach.restype = ctypes.c_void_p
    lib.pstpu_bcast_attach.argtypes = [ctypes.c_char_p]
    lib.pstpu_bcast_capacity.restype = ctypes.c_uint64
    lib.pstpu_bcast_capacity.argtypes = [ctypes.c_void_p]
    for name in ('join', 'consumer_count'):
        getattr(lib, 'pstpu_bcast_' + name).restype = ctypes.c_int64
        getattr(lib, 'pstpu_bcast_' + name).argtypes = [ctypes.c_void_p]
    for name in ('leave', 'evict', 'state', 'lag', 'next_len'):
        getattr(lib, 'pstpu_bcast_' + name).restype = ctypes.c_int64
        getattr(lib, 'pstpu_bcast_' + name).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    for name in ('free_space', 'tail', 'min_head'):
        getattr(lib, 'pstpu_bcast_' + name).restype = ctypes.c_uint64
        getattr(lib, 'pstpu_bcast_' + name).argtypes = [ctypes.c_void_p]
    lib.pstpu_bcast_write.restype = ctypes.c_int
    lib.pstpu_bcast_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.pstpu_bcast_writev.restype = ctypes.c_int
    lib.pstpu_bcast_writev.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32]
    lib.pstpu_bcast_reserve.restype = ctypes.c_void_p
    lib.pstpu_bcast_reserve.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.POINTER(ctypes.c_int32)]
    lib.pstpu_bcast_commit.restype = ctypes.c_int
    lib.pstpu_bcast_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.pstpu_bcast_abort.argtypes = [ctypes.c_void_p]
    lib.pstpu_bcast_read.restype = ctypes.c_int64
    lib.pstpu_bcast_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_uint64]
    lib.pstpu_bcast_close.argtypes = [ctypes.c_void_p]
    return lib


def _load_library():
    """The ring library, built at first use; None when it is unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            from petastorm_tpu_torch.native.build import build_ring
            lib = ctypes.CDLL(build_ring())
        except (OSError, RuntimeError) as e:  # no compiler, or a failed build or load
            logger.info('shm ring unavailable (%s); the process pool will use zmq', e)
            _load_failed = True
            return None
        _lib = bind(lib)
        return _lib


def is_available():
    return _load_library() is not None


def _too_big(nbytes, capacity):
    return ValueError('message of {} bytes exceeds ring capacity {}: increase the process '
                      'pool ring_bytes (or shrink row groups)'.format(nbytes, capacity))


class ShmRing(object):
    """One SPSC byte ring in POSIX shared memory. The creator (the consumer)
    unlinks its name on :meth:`close`."""

    def __init__(self, handle, lib):
        self._handle = handle
        self._lib = lib

    @classmethod
    def create(cls, name, capacity=DEFAULT_RING_BYTES):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('shm ring library not available')
        handle = lib.pstpu_ring_create(name.encode(), capacity)
        if not handle:
            raise OSError('ring create failed: {}'.format(lib.pstpu_ring_last_error().decode()))
        return cls(handle, lib)

    @classmethod
    def attach(cls, name):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('shm ring library not available')
        handle = lib.pstpu_ring_attach(name.encode())
        if not handle:
            raise OSError('ring attach failed: {}'.format(lib.pstpu_ring_last_error().decode()))
        return cls(handle, lib)

    @property
    def capacity(self):
        return self._lib.pstpu_ring_capacity(self._handle)

    def try_write(self, data):
        """True = written; False = the ring is full now. Raises ValueError
        when the message can never fit."""
        rc = self._lib.pstpu_ring_write(self._handle, data, len(data))
        if rc < 0:
            raise _too_big(len(data), self.capacity)
        return rc == 1

    def try_write2(self, header, payload):
        """Gather write of header + payload as one message, with no concat."""
        rc = self._lib.pstpu_ring_write2(self._handle, header, len(header), payload,
                                         len(payload))
        if rc < 0:
            raise _too_big(len(header) + len(payload), self.capacity)
        return rc == 1

    def write2(self, header, payload, stop_check=None, poll_s=0.0002):
        """Blocking :meth:`try_write2`; False when ``stop_check()`` said stop."""
        while not self.try_write2(header, payload):
            if stop_check is not None and stop_check():
                return False
            time.sleep(poll_s)
        return True

    @staticmethod
    def _gather(parts):
        """``(ptr_array, len_array, total, keepalive)`` for a list of
        bytes-likes and contiguous numpy arrays. The pointers are raw
        addresses: ``keepalive`` must outlive the write call."""
        n = len(parts)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        keepalive = []
        total = 0
        for i, p in enumerate(parts):
            if not isinstance(p, np.ndarray):
                p = np.frombuffer(p, np.uint8) if len(p) else np.empty(0, np.uint8)
            keepalive.append(p)
            ptrs[i] = p.ctypes.data if p.size else None
            lens[i] = p.nbytes
            total += p.nbytes
        return ptrs, lens, total, keepalive

    def writev(self, parts, stop_check=None, poll_s=0.0002):
        """Gather write of N bytes-like/ndarray segments as one message (the
        publish channel for whole column blocks, with no join), blocking
        while the ring is full; False when ``stop_check()`` said stop."""
        ptrs, lens, total, keepalive = self._gather(parts)
        if total + MESSAGE_OVERHEAD > self.capacity:
            raise _too_big(total, self.capacity)
        while True:
            rc = self._lib.pstpu_ring_writev(self._handle, ptrs, lens, len(parts))
            if rc == 1:
                return True
            if stop_check is not None and stop_check():
                return False
            time.sleep(poll_s)

    def try_reserve(self, max_len):
        """Reserve a contiguous writable region of ``max_len`` payload bytes
        in the ring: the in-place publish channel, where a fused batch decode
        writes its rows straight into the slot the consumer maps and
        :meth:`commit` publishes them with a header write. Returns a writable
        memoryview of ``max_len`` bytes, or None while the ring lacks space;
        raises ValueError when a message of that size can never fit. One
        reservation may be pending; :meth:`commit` or :meth:`abort` resolves
        it before any other write."""
        status = ctypes.c_int32(0)
        ptr = self._lib.pstpu_ring_reserve(self._handle, max_len, ctypes.byref(status))
        if status.value < 0:
            raise ValueError('reservation of {} bytes cannot fit ring capacity {}: increase the '
                             'process pool ring_bytes (or shrink row groups)'.format(
                                 max_len, self.capacity))
        if not ptr:
            return None
        # the view aliases the ring's shared memory, which the producer's
        # handle keeps mapped for the pool's lifetime
        return memoryview((ctypes.c_char * max_len).from_address(ptr)).cast('B')  # noqa: PT500 - producer-side slot, ring outlives it

    def reserve(self, max_len, stop_check=None, poll_s=0.0002):
        """Blocking :meth:`try_reserve`; None when ``stop_check()`` said stop."""
        while True:
            mv = self.try_reserve(max_len)
            if mv is not None:
                return mv
            if stop_check is not None and stop_check():
                return None
            time.sleep(poll_s)

    def commit(self, actual_len):
        """Publish the pending reservation with its actual message length."""
        if self._lib.pstpu_ring_commit(self._handle, actual_len) != 0:
            raise ValueError('ring commit failed: {}'.format(
                self._lib.pstpu_ring_last_error().decode()))

    def abort(self):
        """Drop the pending reservation (nothing became visible)."""
        self._lib.pstpu_ring_abort(self._handle)

    def has_message(self):
        """True when an unread committed message waits. Does not consume it
        (the supervisor probes a dead worker's ring with it), and counts past
        the zero-copy peek cursor, so messages lent out as views are not
        pending. A closed ring reports empty."""
        if not self._handle:
            return False
        return self._lib.pstpu_ring_has_unread(self._handle) == 1

    def try_read_view(self):
        """One message as a memoryview over a fresh writable buffer (the
        message's one copy out of the ring), or None when the ring is
        empty."""
        n = self._lib.pstpu_ring_next_len(self._handle)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.pstpu_ring_read(self._handle, buf, n)
        if got < 0:
            return None  # raced: the caller polls again
        return memoryview(buf)[:got]  # noqa: PT500 - fresh writable buffer per message

    def try_read_zero_copy(self):
        """One message as ``(view, span_bytes, borrowed)`` without retiring
        its ring bytes, or None when the ring is empty.

        :borrows: a ``borrowed`` view points into the ring's data area: the
            producer may not reuse those bytes until the caller retires
            ``span_bytes`` through :meth:`release`, in take order
            (:class:`~petastorm_tpu_torch.native.lifetime.RingBorrowLedger`
            keeps that order). A message that wraps around the ring's end
            (plain writes wrap byte-wise; only reserved messages are
            contiguous) comes back as an owned copy with ``borrowed=False``;
            its span must still be released."""
        out = (ctypes.c_ulonglong * 3)()
        status = self._lib.pstpu_ring_peek(self._handle, out, 3)
        if status <= 0:
            return None
        if status == 1:
            n = int(out[1])
            view = memoryview(  # noqa: PT500 - borrow by design; ledger-released
                (ctypes.c_char * n).from_address(int(out[0]))).cast('B')
            return view, int(out[2]), True
        buf = ctypes.create_string_buffer(int(out[1]))
        span = ctypes.c_ulonglong(0)
        got = self._lib.pstpu_ring_peek_copy(self._handle, buf, int(out[1]), ctypes.byref(span))
        if got < 0:
            return None
        return memoryview(buf)[:got], int(span.value), False  # noqa: PT500 - fresh buffer

    def release(self, span_bytes):
        """Retire ``span_bytes`` of zero-copy taken messages to the producer
        (in take order only)."""
        if not self._handle:
            return
        if self._lib.pstpu_ring_release(self._handle, span_bytes) != 0:
            raise ValueError('ring release failed: {}'.format(
                self._lib.pstpu_ring_last_error().decode()))

    def close(self):
        if self._handle:
            self._lib.pstpu_ring_close(self._handle)
            self._handle = None


#: broadcast consumer-slot states (``kSlot*`` in shm_ring.cpp)
BCAST_ATTACHED = 1
BCAST_EVICTED = 2


class BcastConsumerGone(Exception):
    """A consumer-side read whose slot was evicted or freed. ``evicted``
    tells a producer-side eviction (too slow) from a token a detach
    invalidated."""

    def __init__(self, message, evicted):
        super().__init__(message)
        self.evicted = evicted


def _gone(status):
    """The :class:`BcastConsumerGone` of a read status, or None."""
    if status == -3:
        return BcastConsumerGone('consumer evicted from bcast ring (lagged beyond the '
                                 'producer bound)', evicted=True)
    if status == -4:
        return BcastConsumerGone('bcast consumer token is stale (slot freed or '
                                 're-granted)', evicted=False)
    return None


class BcastRing(object):
    """One single-producer, multi-consumer broadcast ring in POSIX shared
    memory: the serve daemon's fan-out transport.

    A published message is shared by the attached consumers: each
    consumer's read cursor advancing is its release, and the bytes are
    reclaimed when the slowest attached cursor passes them. The producer
    grants consumer slots (:meth:`join` runs daemon-side between writes, so a
    join never races a write); a consumer maps the segment with
    :meth:`attach` and reads with its token. The producer may :meth:`evict`
    a lagging consumer, whose next read raises :class:`BcastConsumerGone`
    instead of stalling the others. The cursor advance is the whole release:
    unlike the SPSC ring's zero-copy views, a broadcast read copies its
    message out, so no borrow ledger is involved.
    """

    def __init__(self, handle, lib):
        self._handle = handle
        self._lib = lib

    @classmethod
    def create(cls, name, capacity=DEFAULT_RING_BYTES):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('shm ring library not available')
        handle = lib.pstpu_bcast_create(name.encode(), capacity)
        if not handle:
            raise OSError('bcast ring create failed: {}'.format(
                lib.pstpu_ring_last_error().decode()))
        return cls(handle, lib)

    @classmethod
    def attach(cls, name):
        lib = _load_library()
        if lib is None:
            raise RuntimeError('shm ring library not available')
        handle = lib.pstpu_bcast_attach(name.encode())
        if not handle:
            raise OSError('bcast ring attach failed: {}'.format(
                lib.pstpu_ring_last_error().decode()))
        return cls(handle, lib)

    @property
    def capacity(self):
        return self._lib.pstpu_bcast_capacity(self._handle)

    # -- producer side -------------------------------------------------------

    def join(self):
        """Grant a consumer slot (producer side, between writes): its token.
        Raises OSError when every slot is taken."""
        token = self._lib.pstpu_bcast_join(self._handle)
        if token < 0:
            raise OSError('bcast ring has no free consumer slots ({} max)'.format(
                BCAST_MAX_CONSUMERS))
        return token

    def leave(self, token):
        """Release a consumer slot (either side; a stale token is a no-op).
        True when the token was still valid."""
        return self._lib.pstpu_bcast_leave(self._handle, token) == 0

    def evict(self, token):
        """Producer side: mark a lagging consumer evicted. Its cursor stops
        bounding the producer; its next read raises BcastConsumerGone."""
        return self._lib.pstpu_bcast_evict(self._handle, token) == 0

    def state(self, token):
        """1 attached, 2 evicted, 0 freed, -1 stale token."""
        return self._lib.pstpu_bcast_state(self._handle, token)

    def lag(self, token):
        """Unconsumed bytes behind the producer for one consumer (-1 stale)."""
        return self._lib.pstpu_bcast_lag(self._handle, token)

    def consumer_count(self):
        """Attached consumers; 0 for a closed ring (teardown probes this
        before writing, so a close racing a publish drops the frame instead
        of calling into a dead handle)."""
        if not self._handle:
            return 0
        return self._lib.pstpu_bcast_consumer_count(self._handle)

    def free_space(self):
        return self._lib.pstpu_bcast_free_space(self._handle)

    def tail(self):
        """The producer's monotonic position (bytes published, framing
        included)."""
        return self._lib.pstpu_bcast_tail(self._handle)

    def min_head(self):
        """The slowest attached cursor (the tail when nobody is attached):
        every consumer read everything below it. The daemon's blob GC keys
        on it. 0 for a closed ring."""
        if not self._handle:
            return 0
        return self._lib.pstpu_bcast_min_head(self._handle)

    def try_write(self, data):
        """True = broadcast to every attached consumer; False = a consumer
        is too far behind (the caller retries or evicts). Raises ValueError
        when the message can never fit."""
        rc = self._lib.pstpu_bcast_write(self._handle, data, len(data))
        if rc < 0:
            raise ValueError('message of {} bytes exceeds bcast ring capacity {}: '
                             'increase serve ring_bytes'.format(len(data), self.capacity))
        return rc == 1

    def try_writev(self, parts):
        """Gather write of bytes-like/ndarray segments as one broadcast
        message (:meth:`ShmRing.writev`'s contract, without blocking)."""
        ptrs, lens, total, keepalive = ShmRing._gather(parts)
        rc = self._lib.pstpu_bcast_writev(self._handle, ptrs, lens, len(parts))
        del keepalive
        if rc < 0:
            raise ValueError('message of {} bytes exceeds bcast ring capacity {}: '
                             'increase serve ring_bytes'.format(total, self.capacity))
        return rc == 1

    def try_reserve(self, max_len):
        """The in-place publish channel on the fan-out ring: a contiguous
        writable region of ``max_len`` payload bytes, or None while a
        consumer is too far behind; raises ValueError when it can never
        fit. :meth:`commit` or :meth:`abort` resolves it."""
        status = ctypes.c_int32(0)
        ptr = self._lib.pstpu_bcast_reserve(self._handle, max_len, ctypes.byref(status))
        if status.value < 0:
            raise ValueError('reservation of {} bytes cannot fit bcast ring capacity {}: '
                             'increase serve ring_bytes'.format(max_len, self.capacity))
        if not ptr:
            return None
        return memoryview((ctypes.c_char * max_len).from_address(ptr)).cast('B')  # noqa: PT500 - producer-side slot, ring outlives it

    def commit(self, actual_len):
        """Publish the pending reservation with its actual length."""
        if self._lib.pstpu_bcast_commit(self._handle, actual_len) != 0:
            raise ValueError('bcast commit failed: {}'.format(
                self._lib.pstpu_ring_last_error().decode()))

    def abort(self):
        """Drop the pending reservation (nothing became visible)."""
        self._lib.pstpu_bcast_abort(self._handle)

    # -- consumer side -------------------------------------------------------

    def next_len(self, token):
        """Length of this consumer's next message; -1 when none waits.
        Raises BcastConsumerGone on eviction or a stale token."""
        n = self._lib.pstpu_bcast_next_len(self._handle, token)
        gone = _gone(n)
        if gone is not None:
            raise gone
        return n

    def try_read_view(self, token):
        """This consumer's next message as a fresh writable memoryview, or
        None when nothing waits. Raises BcastConsumerGone on eviction or a
        stale token; a read torn by a concurrent eviction is discarded by
        the native seqlock check, never delivered."""
        n = self.next_len(token)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.pstpu_bcast_read(self._handle, token, buf, n)
        gone = _gone(got)
        if gone is not None:
            raise gone
        if got < 0:
            return None  # raced: the caller polls again
        return memoryview(buf)[:got]  # noqa: PT500 - fresh writable buffer per message

    def read_view(self, token, stop_check=None, timeout_s=None):
        """Blocking :meth:`try_read_view` with the spin, yield, sleep
        escalation of :class:`IdleWait`. None on stop or timeout."""
        idle = IdleWait()
        deadline = (time.monotonic() + timeout_s) if timeout_s is not None else None
        while True:
            view = self.try_read_view(token)
            if view is not None:
                return view
            if stop_check is not None and stop_check():
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            idle.wait()

    def close(self):
        if self._handle:
            self._lib.pstpu_bcast_close(self._handle)
            self._handle = None
