"""Slot-lifetime registry: the accounting behind zero-copy views.

Twin of ``petastorm_tpu/native/lifetime.py``. Every consumer-facing view
backed by shared memory (a shm-ring message slot taken by
``ShmRing.try_read_zero_copy``, a copy-on-write mapped blob) is a *borrow*:
the bytes belong to the producer side and are reclaimed on its schedule, not
the view's. This module accounts for every borrow:

* a :class:`Slot` holds the refcount of one reclaimable resource; arrays
  registered with :meth:`Slot.adopt` carry ``weakref.finalize`` callbacks
  that decrement it, so the count is exact with no discipline on the
  consumer's side;
* reclamation asks the slot first: :meth:`Slot.try_reclaim` refuses while
  borrows are live (counted in ``lifetime_blocked_reclaims``);
* :meth:`Slot.force_reclaim` is the escalation: with
  ``PSTPU_LIFETIME_GUARD=1`` the slot's pages are remapped ``PROT_NONE``
  (``pstpu_guard_protect``) so a use after release faults instead of reading
  recycled bytes;
* :class:`RingBorrowLedger` specializes the registry for the SPSC shm ring,
  where releases must retire the shared head in FIFO order whatever order
  the consumer's finalizers run in.

``registry().counters()`` gives the ``lifetime_*`` family every pool's
``diagnostics`` reports.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref

import numpy as np

#: diagnostics keys this module owns (one family, every subsystem)
COUNTER_KEYS = ('lifetime_live_borrows', 'lifetime_blocked_reclaims',
                'lifetime_guard_faults')


def guard_enabled():
    """True when ``PSTPU_LIFETIME_GUARD=1``: force-reclaimed slots are
    remapped ``PROT_NONE`` so use-after-release faults instead of reading
    recycled bytes. Debug/test mode — the fault is a hard SIGSEGV."""
    return os.environ.get('PSTPU_LIFETIME_GUARD', '') == '1'


def _guard_lib():
    from petastorm_tpu_torch.native import shm_ring
    return shm_ring._load_library()


def buffer_region(obj):
    """(address, nbytes) of the memory behind a memoryview/ndarray, for use
    as a :class:`Slot` guard region. Returns None when it cannot be
    resolved (no guard — reclamation still proceeds)."""
    try:
        if isinstance(obj, np.ndarray):
            return int(obj.ctypes.data), int(obj.nbytes)
        mv = memoryview(obj)
        if mv.nbytes == 0:
            return None
        arr = np.frombuffer(mv, dtype=np.uint8)
        return int(arr.ctypes.data), int(arr.nbytes)
    except (TypeError, ValueError, BufferError):
        return None


class Slot(object):
    """Refcount of one reclaimable shared-plane resource.

    Lifecycle: ``open_slot`` -> ``adopt``/``retain`` (borrows attach) ->
    ``seal`` (producer-side: no more borrows will attach) -> the LAST
    borrow's finalizer (or ``seal`` itself, when nothing attached) runs
    ``on_release`` exactly once. ``try_reclaim``/``force_reclaim`` are the
    reclaimer-side entry points and may run before the borrows die.
    """

    __slots__ = ('_registry', '_lock', '_refs', '_sealed', '_released',
                 '_reclaimed', '_on_release', '_guard_region', 'label',
                 '__weakref__')

    def __init__(self, registry, on_release=None, guard_region=None, label=''):
        self._registry = registry
        self._lock = threading.Lock()
        self._refs = 0
        self._sealed = False
        self._released = False
        self._reclaimed = False
        self._on_release = on_release
        self._guard_region = guard_region
        self.label = label

    @property
    def live(self):
        """Number of live borrows attached to this slot."""
        with self._lock:
            return self._refs

    @property
    def released(self):
        with self._lock:
            return self._released

    def retain(self):
        """Manually add one borrow (paired with :meth:`drop`) for holders
        that cannot carry a weakref (e.g. a ledger entry)."""
        with self._lock:
            if self._released:
                raise RuntimeError('retain() on a released slot ({})'.format(self.label))
            self._refs += 1
        return self

    def drop(self):
        """Release one manual borrow."""
        self._dec()

    def adopt(self, obj):
        """Attach a finalizer-borrow to every ndarray reachable in ``obj``
        (dicts/lists/tuples walked, and the ndarray cells of object
        columns). The finalizer sits on each array's root: the last ndarray
        of its ``.base`` chain, which every numpy view derived from it keeps
        alive. (numpy collapses view chains: a slice of a reshaped
        ``np.frombuffer`` array has the frombuffer array as its base, not
        the reshaped one, so a finalizer on the delivered array itself would
        release the slot while a user's slice still reads it.) Returns
        ``obj``. Objects that cannot carry a weakref are skipped."""
        for arr in _iter_arrays(obj):
            try:
                with self._lock:
                    if self._released:
                        break
                    self._refs += 1
                weakref.finalize(arr, self._dec)
            except TypeError:
                self._dec()
        return obj

    def seal(self):
        """Producer side is done attaching borrows. A slot with zero borrows
        releases immediately; otherwise the last finalizer releases it."""
        run = False
        with self._lock:
            self._sealed = True
            if self._refs == 0 and not self._released:
                self._released = True
                run = True
        if run:
            self._fire()

    def release_now(self):
        """Synchronous release regardless of refcount — for payloads the
        caller fully copied out before returning."""
        run = False
        with self._lock:
            if not self._released:
                self._released = True
                self._sealed = True
                run = True
        if run:
            self._fire()

    def try_reclaim(self):
        """Reclaimer-side: release if no borrows are live; otherwise count a
        blocked reclaim and return False (caller escalates or retries)."""
        with self._lock:
            if self._refs > 0:
                self._registry._note_blocked()
                return False
            if not self._released:
                self._released = True
                self._sealed = True
                run = True
            else:
                run = False
        if run:
            self._fire()
        return True

    def force_reclaim(self):
        """Escalation path: reclaim NOW even over live borrows (the existing
        slow-consumer eviction / LRU-pressure semantics). Live borrows are
        counted as guard faults, and under ``PSTPU_LIFETIME_GUARD=1`` the
        slot's pages go ``PROT_NONE`` so the next touch faults loudly."""
        with self._lock:
            had_live = self._refs > 0
            run = not self._released
            self._released = True
            self._sealed = True
            self._reclaimed = True
        if had_live:
            self._registry._note_fault()
            if guard_enabled():
                self.guard_protect()
        if run:
            self._fire()

    def guard_protect(self):
        """Remap this slot's guard region ``PROT_NONE`` (full pages only).
        Returns protected byte count (0 = no region / no native lib)."""
        region = self._guard_region
        lib = _guard_lib()
        if region is None or lib is None:
            return 0
        addr, nbytes = region
        n = lib.pstpu_guard_protect(ctypes.c_void_p(addr), nbytes, 1)
        return max(0, int(n))

    def guard_unprotect(self):
        """Undo :meth:`guard_protect` (the reclaimer reuses the pages)."""
        region = self._guard_region
        lib = _guard_lib()
        if region is None or lib is None:
            return 0
        addr, nbytes = region
        n = lib.pstpu_guard_protect(ctypes.c_void_p(addr), nbytes, 0)
        return max(0, int(n))

    def _dec(self):
        run = False
        with self._lock:
            if self._refs > 0:
                self._refs -= 1
            if self._refs == 0 and self._sealed and not self._released:
                self._released = True
                run = True
        if run:
            self._fire()

    def _fire(self):
        self._registry._forget(self)
        cb = self._on_release
        self._on_release = None
        if cb is not None:
            cb()


class SlotRegistry(object):
    """Process-wide ledger of open slots + the ``lifetime_*`` counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots = set()
        self._blocked_reclaims = 0
        self._guard_faults = 0

    def open_slot(self, on_release=None, guard_region=None, label=''):
        slot = Slot(self, on_release=on_release, guard_region=guard_region,
                    label=label)
        with self._lock:
            self._slots.add(slot)
        return slot

    def live_borrows(self):
        with self._lock:
            slots = list(self._slots)
        return sum(s.live for s in slots)

    def counters(self):
        """The ``lifetime_*`` family every pool's ``diagnostics`` reports."""
        with self._lock:
            blocked, faults = self._blocked_reclaims, self._guard_faults
        return {'lifetime_live_borrows': self.live_borrows(),
                'lifetime_blocked_reclaims': blocked,
                'lifetime_guard_faults': faults}

    def _note_blocked(self):
        with self._lock:
            self._blocked_reclaims += 1

    def _note_fault(self):
        with self._lock:
            self._guard_faults += 1

    def _forget(self, slot):
        with self._lock:
            self._slots.discard(slot)


_registry = SlotRegistry()


def registry():
    """The process-global registry (every pool shares it, so
    ``lifetime_live_borrows`` is one number per process)."""
    return _registry


class RingBorrowLedger(object):
    """FIFO release ledger for one SPSC shm-ring consumer.

    ``try_read_zero_copy`` hands out views straight into the ring's data
    area; the producer may only reuse those bytes once the shared head
    passes them, and the head must advance IN ORDER even though consumer
    finalizers run in whatever order the GC pleases. The ledger queues one
    entry per taken message ``(span_bytes, released?)`` and, whenever the
    front entry is released, retires every released prefix through
    ``ring.release`` in one pass. Holding a borrow therefore applies natural
    backpressure (the producer stalls when the ring fills) instead of
    corrupting the slot.

    ``close_when_drained`` defers the ring's munmap until every borrow died
    — closing under a live view would turn a stale read into a segfault.
    """

    def __init__(self, ring, registry_=None):
        self._ring = ring
        self._registry = registry_ or registry()
        self._lock = threading.Lock()
        self._pending = []  # [span, released] in take order
        self._deferred_close = None

    @property
    def live(self):
        with self._lock:
            return sum(1 for e in self._pending if not e[1])

    def take(self, view, span, borrowed):
        """Account one message taken off the ring. Returns the
        :class:`Slot` whose release retires ``span`` bytes (for borrowed
        views the caller adopts the deserialized arrays into it; for owned
        copies it calls ``release_now()``)."""
        entry = [int(span), False]
        guard = buffer_region(view) if borrowed else None
        slot = self._registry.open_slot(
            on_release=lambda: self._mark(entry), guard_region=guard,
            label='ring-msg')
        with self._lock:
            self._pending.append(entry)
        return slot

    def _mark(self, entry):
        close_fn = None
        with self._lock:
            entry[1] = True
            while self._pending and self._pending[0][1]:
                span, _ = self._pending.pop(0)
                self._ring.release(span)
            if not self._pending and self._deferred_close is not None:
                close_fn, self._deferred_close = self._deferred_close, None
        if close_fn is not None:
            close_fn()

    def close_when_drained(self, close_fn):
        """Run ``close_fn`` (typically ``ring.close``) once every borrow is
        released — immediately when none are live. A blocked close counts as
        a blocked reclaim (the diagnostics tell you a consumer is sitting on
        a dead ring's memory)."""
        with self._lock:
            if self._pending:
                self._deferred_close = close_fn
                blocked = True
            else:
                blocked = False
        if blocked:
            self._registry._note_blocked()
        else:
            close_fn()
        return not blocked


def _iter_arrays(obj, _depth=0):
    if _depth > 4:
        return
    if isinstance(obj, np.ndarray):
        root = obj
        while isinstance(root.base, np.ndarray):
            root = root.base
        yield root
        if obj.dtype == object:
            for cell in obj.ravel():
                if isinstance(cell, np.ndarray):
                    yield from _iter_arrays(cell, _depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_arrays(v, _depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_arrays(v, _depth + 1)


__all__ = ['COUNTER_KEYS', 'RingBorrowLedger', 'Slot', 'SlotRegistry',
           'buffer_region', 'guard_enabled', 'registry']
