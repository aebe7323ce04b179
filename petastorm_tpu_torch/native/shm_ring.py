"""ctypes bindings for the shared-memory SPSC ring (``shm_ring.cpp``).

Twin of the ring half of ``petastorm_tpu/native/shm_ring.py``: one ring per
worker process, worker -> main. The C primitives never block; blocking, with
a stop-aware sleep-poll, lives here. The library is built by g++ at first use
into ``.torch_build/native/libpstpu_torch_ring.so`` (``build.build_ring``);
any build or load failure makes :func:`is_available` False and the process
pool then uses its zmq transport. The ring layout is the JAX package's, so a
ring created by either package can be attached by the other. The broadcast
ring of the serve plane is compiled into the library but not bound here.
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


class IdleWait(object):
    """Escalating wait for ring poll loops: spin, then ``sched_yield``, then
    sleeps that double up to ``max_sleep_s``. The first misses stay free of
    latency; an idle peer does not keep a core busy. Call :meth:`wait` per
    empty poll and :meth:`reset` on progress."""

    __slots__ = ('_spins', '_yields', '_sleep_s', '_max_sleep_s', '_misses', '_cur_sleep')

    def __init__(self, spins=64, yields=64, sleep_s=0.0002, max_sleep_s=0.002):
        self._spins = spins
        self._yields = yields
        self._sleep_s = sleep_s
        self._max_sleep_s = max_sleep_s
        self._misses = 0
        self._cur_sleep = sleep_s

    def wait(self):
        """One empty-poll step: spin, yield, or sleep per the escalation."""
        self._misses += 1
        if self._misses <= self._spins:
            return
        if self._misses <= self._spins + self._yields:
            os.sched_yield()
            return
        time.sleep(self._cur_sleep)
        self._cur_sleep = min(self._cur_sleep * 2, self._max_sleep_s)

    def reset(self):
        """Progress was made: restart the escalation at the spin tier."""
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
        return memoryview((ctypes.c_char * max_len).from_address(ptr)).cast('B')

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
        return memoryview(buf)[:got]

    def try_read_zero_copy(self):
        """One message as ``(view, span_bytes, borrowed)`` without retiring
        its ring bytes, or None when the ring is empty.

        A ``borrowed`` view points into the ring's data area: the producer
        may not reuse those bytes until the caller retires ``span_bytes``
        through :meth:`release`, in take order
        (:class:`~petastorm_tpu_torch.native.lifetime.RingBorrowLedger` keeps
        that order). A message that wraps around the ring's end (plain writes
        wrap byte-wise; only reserved messages are contiguous) comes back as
        an owned copy with ``borrowed=False``; its span must still be
        released."""
        out = (ctypes.c_ulonglong * 3)()
        status = self._lib.pstpu_ring_peek(self._handle, out, 3)
        if status <= 0:
            return None
        if status == 1:
            n = int(out[1])
            view = memoryview((ctypes.c_char * n).from_address(int(out[0]))).cast('B')
            return view, int(out[2]), True
        buf = ctypes.create_string_buffer(int(out[1]))
        span = ctypes.c_ulonglong(0)
        got = self._lib.pstpu_ring_peek_copy(self._handle, buf, int(out[1]), ctypes.byref(span))
        if got < 0:
            return None
        return memoryview(buf)[:got], int(span.value), False

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
