"""Content-addressed local mirror of remote column-chunk byte ranges.

Twin of ``petastorm_tpu/chunkstore/store.py``. The page scanner
(``native/pagescan.py``) turns UNCOMPRESSED/PLAIN column chunks into
zero-copy Arrow views, but only over an mmap-able local file, so a remote
store (``s3://``, ``gs://``) would decode through Arrow over the network.
This store closes that gap at the byte level: each qualifying column chunk
of a remote Parquet file is mirrored once into a local content-addressed
file, and every later read maps the mirror and serves views as the local
path does. (The reference caches decoded rows; this caches the raw chunk
bytes, since the zero-copy path's point is that no decoded copy exists.)

Invariants:

* **Atomic single-writer population**: a chunk is written to a temp file in
  its directory and ``os.replace``-d into place, so readers (process-pool
  workers sharing the directory included) never see a partial chunk; racing
  writers in two processes both fetch and the last rename wins with the
  same bytes. Within a process a per-chunk mutex makes the fetch single.
* **Eviction never invalidates a live view.** Arrays built over a mirror
  hold its ``np.memmap`` alive through their buffers; the store keeps a
  *weakref* per mapping, whose memmap is adopted into a lifetime slot
  (``native/lifetime.py``). The evictor skips any chunk whose slot has live
  borrows (``evict_skipped_pinned``), and even an unlinked chunk's mapping
  stays valid on POSIX until the last view drops. Mappings are never
  unmapped explicitly.
* **LRU by mtime**: a demand hit bumps the chunk file's mtime (a prefetch
  does not), so recency follows consumption; eviction walks oldest first
  under the size bound. Bumps are throttled to once a second per chunk.
* **Counters survive process pools**: each process's store flushes its
  cumulative counters to ``<root>/stats/pid-<pid>.json`` (throttled for
  hits, at once for the rare events), and :meth:`ChunkStore.stats_snapshot`
  merges every process's file with this process's live counters. A JAX
  store on the same root in the same process writes the same file: give the
  two packages separate roots (the port's ``'auto'`` root is its own,
  ``chunkstore/__init__.py``).
* **Warm reads cost a dict lookup**: a bounded strong-reference pool keeps
  the 64 most recently used mappings alive across batches. The evictor
  releases a chunk's pool entry before judging it pinned, so only batches
  pin.
* **The chunk fabric** (``fabric/``): with :data:`PEER_SOURCE` installed a
  miss asks a pod peer's mirror first, and :meth:`ChunkStore.pin_for_send`
  keeps a mirror from eviction while it is streamed to a peer.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import tempfile
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry

logger = logging.getLogger(__name__)

DEFAULT_SIZE_LIMIT = 10 * 2 ** 30  # 10 GiB, matching LocalDiskCache
DEFAULT_PREFETCH_BUDGET = 64 * 2 ** 20
DEFAULT_PREFETCH_LOOKAHEAD = 8

#: counter names persisted/aggregated; all cumulative since store creation
_COUNTER_KEYS = ('hits', 'misses', 'bytes_fetched', 'bytes_evicted',
                 'chunks_evicted', 'evict_skipped_pinned',
                 'prefetch_chunks', 'prefetch_bytes')

#: min seconds between stats-file flushes for hit-only traffic (rare events —
#: misses, evictions, prefetches — always flush immediately)
_FLUSH_INTERVAL_S = 0.5

#: min seconds between mtime bumps of the same chunk (LRU recency and the
#: prefetcher's consumed signal both work at whole-second granularity)
_BUMP_INTERVAL_S = 1.0

#: recently-used mappings kept alive by the store itself so repeat reads skip
#: the open+mmap round trip; bounded, and released on demand by the evictor
_STRONG_POOL_SIZE = 64

#: the chunk fabric's hook (``petastorm_tpu_torch.fabric``): when installed,
#: every miss hands ``(key, length, fetch_fn)`` to the fabric client, which
#: tries a pod peer's mirror first and falls back to ``fetch_fn`` (the
#: object-store read) itself; :meth:`ChunkStore.ensure` then writes whichever
#: bytes came back through the same atomic temp-and-rename path, so a mirror
#: filled by a peer is indistinguishable from a fetched one. None (the
#: default) costs one global load per miss, never per hit.
PEER_SOURCE = None


class ChunkCacheConfig(object):
    """Picklable chunk-cache description shipped into worker processes.

    :param root: local cache directory (created on first use)
    :param size_limit_bytes: total on-disk bound; LRU eviction keeps usage under it
    :param prefetch_budget_bytes: max bytes the async prefetcher may hold
        fetched-but-unconsumed at any moment
    :param prefetch_lookahead: how many upcoming ventilator items the
        prefetcher walks ahead
    """

    def __init__(self, root, size_limit_bytes=DEFAULT_SIZE_LIMIT,
                 prefetch_budget_bytes=DEFAULT_PREFETCH_BUDGET,
                 prefetch_lookahead=DEFAULT_PREFETCH_LOOKAHEAD):
        if not root:
            raise ValueError('chunk cache root must be a non-empty path')
        self.root = os.path.abspath(root)
        self.size_limit_bytes = size_limit_bytes
        self.prefetch_budget_bytes = prefetch_budget_bytes
        self.prefetch_lookahead = prefetch_lookahead

    def set_prefetch_budget(self, n):
        """Retarget the prefetcher's in-flight byte budget at runtime — the
        autotuner's chunk-fetch knob (``docs/autotune.md``). The prefetcher
        re-reads ``prefetch_budget_bytes`` on every budget wait, so the new
        bound takes effect on its next fetch decision."""
        n = int(n)
        if n < 1:
            raise ValueError('prefetch budget must be >= 1 byte')
        self.prefetch_budget_bytes = n

    def _key(self):
        return (self.root, self.size_limit_bytes, self.prefetch_budget_bytes,
                self.prefetch_lookahead)

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return 'ChunkCacheConfig(root={!r}, size_limit_bytes={})'.format(
            self.root, self.size_limit_bytes)


#: per-process store registry: every component (workers, prefetcher, Reader
#: diagnostics) sharing a root shares ONE instance, so in-process counters and
#: resident-mmap reuse are coherent
_stores = {}
_stores_lock = threading.Lock()


def open_store(config):
    """The per-process :class:`ChunkStore` for ``config`` (created on first use)."""
    with _stores_lock:
        store = _stores.get(config.root)
        if store is None:
            store = ChunkStore(config.root, size_limit_bytes=config.size_limit_bytes)
            _stores[config.root] = store
        return store


class ChunkStore(object):
    """Size-bounded local chunk mirror. Thread-safe; multi-process safe for
    population/eviction (atomic renames; unlink of a mapped file is harmless
    on POSIX). Obtain through :func:`open_store` so counters aggregate."""

    def __init__(self, root, size_limit_bytes=DEFAULT_SIZE_LIMIT):
        self._root = root
        self._size_limit = size_limit_bytes
        self._lock = threading.Lock()
        self._counters = {k: 0 for k in _COUNTER_KEYS}
        self._last_flush = 0.0
        # digest -> (weakref to np.memmap, chunk size, lifetime Slot). Views
        # over the mapping keep the memmap object alive; the memmap is
        # adopted into the slot (native/lifetime.py), so "pinned" is exactly
        # "the slot has live borrows" and blocked evictions land in the
        # process-wide lifetime_blocked_reclaims counter.
        self._mmaps = {}
        # digest -> np.memmap: bounded LRU of strong refs so hot chunks stay
        # mapped across batches; the evictor pops an entry before judging the
        # weakref, so the pool itself never pins anything against eviction
        self._strong = OrderedDict()
        # digest -> monotonic time of the last mtime bump (throttle)
        self._bumped = {}
        # digest -> [fetch mutex, refcount]: single-flight per chunk. The
        # mutex covers the whole miss path — re-stat, fetch, mirror write —
        # so concurrent demands for the same chunk
        # produce exactly ONE fetch and ONE population per host; followers
        # re-stat under the mutex and account a hit. Entries are refcounted
        # away, so the map stays bounded by in-flight fetches, not history.
        self._fetch_locks = {}
        # digest -> lifetime Slot of an in-flight fabric send of a chunk that
        # has no live mapping (pin_for_send); the evictor asks it first
        self._send_pins = {}
        self._stats_dir = os.path.join(root, 'stats')
        os.makedirs(self._stats_dir, exist_ok=True)
        self._stats_path = os.path.join(self._stats_dir,
                                        'pid-{}.json'.format(os.getpid()))

    @property
    def root(self):
        return self._root

    # -- keying --------------------------------------------------------------

    @staticmethod
    def digest(key):
        return hashlib.sha1(key.encode('utf-8')).hexdigest()

    def _entry_path(self, digest):
        return os.path.join(self._root, digest[:2], digest + '.chunk')

    # -- counters ------------------------------------------------------------

    def _count(self, updates):
        """Apply counter deltas; flush to the per-pid stats file at most every
        ``_FLUSH_INTERVAL_S`` for hit traffic (and always on a miss/evict/
        prefetch, the rare events) — the atomic-replace write must never sit
        in the warm demand-hit path."""
        force = any(k != 'hits' for k in updates)
        now = time.monotonic()
        with self._lock:
            for k, v in updates.items():
                self._counters[k] += v
            if not force and now - self._last_flush < _FLUSH_INTERVAL_S:
                return
            self._last_flush = now
            snapshot = dict(self._counters)
        self._write_stats(snapshot)

    def _maybe_bump(self, digest, path):
        """Bump the mirror's mtime (LRU recency + the prefetcher's consumed
        signal), at most once per ``_BUMP_INTERVAL_S`` per chunk. The FIRST
        demand hit always bumps — that is what tells the prefetcher its
        fetched-ahead bytes were consumed."""
        now = time.monotonic()
        with self._lock:
            last = self._bumped.get(digest)
            if last is not None and now - last < _BUMP_INTERVAL_S:
                return
            self._bumped[digest] = now
        try:
            os.utime(path, None)
        except OSError:
            pass  # evicted-but-mapped: recency is moot, the view is safe

    def _write_stats(self, snapshot):
        try:
            fd, tmp = tempfile.mkstemp(dir=self._stats_dir, suffix='.tmp')
            with os.fdopen(fd, 'w') as f:
                json.dump(snapshot, f)
            os.replace(tmp, self._stats_path)
        except OSError as e:
            logger.debug('chunk-store stats flush failed: %s', e)

    def stats_snapshot(self):
        """Cumulative counters across every process sharing this root: other
        processes' persisted stats files plus this process's live counters.
        Adds ``chunks_pinned``/``bytes_pinned`` (live mappings in THIS process)."""
        agg = {k: 0 for k in _COUNTER_KEYS}
        try:
            names = os.listdir(self._stats_dir)
        except OSError:
            names = []
        own = os.path.basename(self._stats_path)
        for name in names:
            if not name.endswith('.json') or name == own:
                continue
            try:
                with open(os.path.join(self._stats_dir, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            for k in _COUNTER_KEYS:
                v = rec.get(k)
                if isinstance(v, int):
                    agg[k] += v
        pinned_n = pinned_bytes = 0
        with self._lock:
            for k in _COUNTER_KEYS:
                agg[k] += self._counters[k]
            for _ref, size, slot in self._mmaps.values():
                if slot.live:
                    pinned_n += 1
                    pinned_bytes += size
        agg['chunks_pinned'] = pinned_n
        agg['bytes_pinned'] = pinned_bytes
        return agg

    def flush(self):
        """Write this process's counters to its stats file now. Hit traffic
        flushes at most every ``_FLUSH_INTERVAL_S``, so a worker process
        flushes as it closes its files: the counters merged after it exits
        hold its last hits. (The JAX store flushes only on ``close``.)"""
        with self._lock:
            self._last_flush = time.monotonic()
            snapshot = dict(self._counters)
        self._write_stats(snapshot)

    def close(self):
        """Flush counters and release the store's own mapping refs. Mappings
        are never explicitly unmapped (views may be live); each one releases
        with its last referencing array."""
        with self._lock:
            self._strong.clear()
        self.flush()

    # -- population ----------------------------------------------------------

    def ensure(self, key, length, fetch_fn, for_prefetch=False):
        """Guarantee the chunk for ``key`` (exactly ``length`` bytes, produced
        by ``fetch_fn()`` on a miss) exists on disk.

        Returns ``(path, mtime_ns, fetched)``. A demand hit bumps mtime (LRU
        recency + the prefetcher's consumed signal); a prefetch hit does not.
        """
        digest = self.digest(key)
        path = self._entry_path(digest)
        try:
            st = os.stat(path)
        except OSError:
            st = None
        if st is not None and st.st_size == length:
            if not for_prefetch:
                self._maybe_bump(digest, path)
                self._count({'hits': 1})
                obs.instant('chunk_hit', cat='chunkstore', bytes=length)
            return path, st.st_mtime_ns, False
        # single-flight: the whole miss path — re-stat, fetch, mirror write —
        # runs under a per-digest mutex, so a chunk is fetched and populated
        # exactly once per host no matter how many threads demand it at once
        with self._lock:
            entry = self._fetch_locks.get(digest)
            if entry is None:
                entry = [threading.Lock(), 0]
                self._fetch_locks[digest] = entry
            entry[1] += 1
        try:
            with entry[0]:
                return self._fetch_and_install(key, digest, path, length,
                                               fetch_fn, for_prefetch)
        finally:
            with self._lock:
                entry[1] -= 1
                if not entry[1]:
                    self._fetch_locks.pop(digest, None)

    def _fetch_and_install(self, key, digest, path, length, fetch_fn,
                           for_prefetch):
        """The serialized miss path (caller holds the digest's fetch mutex)."""
        try:
            st = os.stat(path)
        except OSError:
            st = None
        if st is not None and st.st_size == length:
            # single-flight follower: the fetch this thread queued behind
            # already populated the mirror
            if not for_prefetch:
                self._maybe_bump(digest, path)
                self._count({'hits': 1})
                obs.instant('chunk_hit', cat='chunkstore', bytes=length)
            return path, st.st_mtime_ns, False
        # separate stage names: demand fetches happen INSIDE the worker read
        # stage (the stall report subtracts them from read IO), prefetches on
        # the prefetcher's own thread (they must not skew that subtraction)
        with obs.stage('chunk_prefetch' if for_prefetch else 'chunk_fetch',
                       cat='chunkstore', bytes=length):
            peer_source = PEER_SOURCE
            data = fetch_fn() if peer_source is None else peer_source(key, length, fetch_fn)
        if data is None:
            # the fabric client's single-flight follower: another caller of
            # the same client populated the mirror, so this is a hit (one
            # population per host)
            try:
                st = os.stat(path)
            except OSError:
                st = None
            if st is None or st.st_size != length:
                raise IOError('peer source reported chunk {!r} populated, but no mirror of '
                              '{} bytes exists'.format(key, length))
            if not for_prefetch:
                self._count({'hits': 1})
                obs.instant('chunk_hit', cat='chunkstore', bytes=length)
            return path, st.st_mtime_ns, False
        if len(data) != length:
            raise IOError('chunk fetch for {!r} returned {} bytes, expected {}'.format(
                key, len(data), length))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(data)
            os.replace(tmp, path)  # atomic: readers never see partial chunks
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        try:
            st = os.stat(path)
            mtime_ns = st.st_mtime_ns
        except OSError:
            mtime_ns = 0
        if for_prefetch:
            self._count({'prefetch_chunks': 1, 'prefetch_bytes': length})
        else:
            self._count({'misses': 1, 'bytes_fetched': length})
        self._evict_if_needed()
        return path, mtime_ns, True

    def contains(self, key, length):
        path = self._entry_path(self.digest(key))
        try:
            return os.stat(path).st_size == length
        except OSError:
            return False

    # -- fabric serving ------------------------------------------------------

    @contextlib.contextmanager
    def pin_for_send(self, key):
        """Pin ``key``'s mirror against eviction while a fabric send streams
        it, yielding its path (None when this host does not mirror it).

        The pin is a borrow on the chunk's lifetime slot: the mapping's slot
        when a mapping is live, else a ``fabric-send`` slot of its own. So
        :meth:`_try_evict_entry` refuses (a counted skip) instead of
        unlinking the file mid-stream and truncating the peer's transfer."""
        digest = self.digest(key)
        path = self._entry_path(digest)
        with self._lock:
            slot = None
            entry = self._mmaps.get(digest)
            if entry is not None:
                try:
                    slot = entry[2].retain()
                except RuntimeError:
                    slot = None  # released between the lookup and the retain
            if slot is None:
                pin = self._send_pins.get(digest)
                if pin is None or pin.released:
                    pin = lifetime_registry().open_slot(label='fabric-send')
                    self._send_pins[digest] = pin
                slot = pin.retain()
        try:
            yield path if os.path.exists(path) else None
        finally:
            with self._lock:
                slot.drop()
                if self._send_pins.get(digest) is slot and not slot.live:
                    del self._send_pins[digest]
                    slot.seal()  # no borrow left: releases at once

    # -- mapping -------------------------------------------------------------

    def mmap_chunk(self, key, length, fetch_fn):
        """A read-only ``np.memmap`` over the chunk's local mirror, fetching
        on miss. The caller's arrays pin the mapping simply by referencing it;
        the store additionally keeps the hottest mappings in a bounded
        strong-ref pool so a warm re-read is a dict lookup, not a syscall.

        :borrows: the returned memmap aliases the on-disk mirror; eviction is
            refused (``lifetime_blocked_reclaims``) while it or any array
            built over it is alive."""
        digest = self.digest(key)
        with self._lock:
            mm = self._strong.get(digest)
            if mm is not None:
                self._strong.move_to_end(digest)
            else:
                entry = self._mmaps.get(digest)
                mm = entry[0]() if entry is not None else None
        if mm is not None:
            self._count({'hits': 1})
            self._maybe_bump(digest, self._entry_path(digest))
            return mm
        path, _, _ = self.ensure(key, length, fetch_fn)
        try:
            mm = np.memmap(path, dtype=np.uint8, mode='r')
        except (OSError, ValueError):
            # evicted between ensure and mmap (another process's evictor):
            # repopulate once — the refetched bytes are identical
            path, _, _ = self.ensure(key, length, fetch_fn)
            mm = np.memmap(path, dtype=np.uint8, mode='r')
        # the memmap (an ndarray) is the one borrow: arrays built over it keep
        # it alive through their buffers, so its finalizer firing means no
        # view can reference the mirror anymore
        slot = lifetime_registry().open_slot(label='chunk-mirror')
        slot.adopt(mm)
        slot.seal()
        with self._lock:
            self._mmaps[digest] = (weakref.ref(mm), length, slot)
            self._strong[digest] = mm
            self._strong.move_to_end(digest)
            while len(self._strong) > _STRONG_POOL_SIZE:
                self._strong.popitem(last=False)
        return mm

    # -- eviction ------------------------------------------------------------

    def _try_evict_entry(self, digest, full):
        """Release the store's own strong-pool ref for ``digest``, then — if
        no live batch pins the mapping — unlink the chunk file, ATOMICALLY
        under the store lock. Holding the lock across pin-check + unlink
        closes the race where a concurrent :meth:`mmap_chunk` re-registers
        the digest between the two steps and its freshly pinned chunk is
        unlinked out from under the recency accounting (the mapping itself
        stays POSIX-valid either way — this is about honest bookkeeping).
        Returns True when the file was evicted. A refused reclaim counts in
        the process-wide ``lifetime_blocked_reclaims``."""
        with self._lock:
            self._strong.pop(digest, None)
            pin = self._send_pins.get(digest)
            if pin is not None:
                if not pin.try_reclaim():
                    return False  # a fabric send is streaming this mirror
                del self._send_pins[digest]
            entry = self._mmaps.get(digest)
            if entry is not None:
                if not entry[2].try_reclaim():
                    return False  # pinned by a live batch's views
                del self._mmaps[digest]
            try:
                os.unlink(full)
            except OSError:
                return False
            self._bumped.pop(digest, None)
            return True

    def _evict_if_needed(self):
        entries = []
        total = 0
        for dirpath, dirnames, filenames in os.walk(self._root):
            if os.path.basename(dirpath) == 'stats':
                dirnames[:] = []
                continue
            for name in filenames:
                if not name.endswith('.chunk'):
                    continue
                full = os.path.join(dirpath, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((st.st_mtime_ns, st.st_size, name[:-len('.chunk')], full))
                total += st.st_size
        if total <= self._size_limit:
            return
        evicted_n = evicted_b = skipped = 0
        entries.sort()  # oldest mtime first
        for _mtime, size, digest, full in entries:
            if total <= self._size_limit:
                break
            if not self._try_evict_entry(digest, full):
                # a live batch still references this mapping (or the file
                # vanished under us): unlinking would not free disk until the
                # views drop anyway, and the size accounting must stay honest
                # — skip, on record
                skipped += 1
                continue
            total -= size
            evicted_n += 1
            evicted_b += size
        if evicted_n or skipped:
            self._count({'chunks_evicted': evicted_n, 'bytes_evicted': evicted_b,
                         'evict_skipped_pinned': skipped})
