"""Async chunk prefetcher: warms the chunk store ahead of the workers.

Twin of ``petastorm_tpu/chunkstore/prefetch.py``. Walks the ventilator's
exact upcoming row-group order (``upcoming_items`` of every ventilator of
the port) and fetches each qualifying column chunk into the chunk store
before a worker asks for it, so the first epoch's demand misses overlap with
compute instead of queuing in front of it.

The fetch-ahead is bounded by an **in-flight byte budget**: bytes fetched
that no reader has consumed yet. Consumption shows on the chunk file itself
(a demand hit bumps the mirror's mtime, ``ChunkStore.ensure``; eviction
removes it), so the signal works across processes with no shared memory.
With the budget full the prefetcher waits; it never blocks a worker (the
workers fetch on demand regardless) and never fails the read path (an error
is logged and skipped). :meth:`ChunkPrefetcher.stop` and
:meth:`ChunkPrefetcher.join` end its thread; the reader calls both.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict, deque

logger = logging.getLogger(__name__)

#: bound on per-prefetcher open remote file handles (footer metadata is cached
#: in the store, so re-opening an evicted handle is cheap on a warm cache)
_MAX_OPEN_FILES = 4

_POLL_S = 0.05


class ChunkPrefetcher(object):
    """Background thread prefetching the ventilator's upcoming chunks.

    :param ventilator: a started-or-starting ventilator with ``upcoming_items``
    :param pieces: the Reader's piece list (items carry ``piece_index``)
    :param column_names: columns the reader will request (non-physical names
        are skipped by qualification)
    :param filesystem_factory: picklable zero-arg filesystem factory
    :param config: :class:`ChunkCacheConfig` (budget + lookahead live here)
    """

    def __init__(self, ventilator, pieces, column_names, filesystem_factory,
                 config):
        self._ventilator = ventilator
        self._pieces = pieces
        self._columns = list(column_names)
        self._fs_factory = filesystem_factory
        self._config = config
        self._stop_event = threading.Event()
        self._thread = None
        # single-threaded state (prefetch thread only): open files, planned
        # row groups, and the fetched-but-unconsumed ledger for the budget
        self._files = OrderedDict()  # path -> ChunkCachedParquetFile | None
        self._done = set()           # (path, row_group) already planned
        self._outstanding = deque()  # (chunk_path, size, populate_mtime_ns)

    def start(self):
        if self._thread is not None:
            raise RuntimeError('ChunkPrefetcher already started')
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='pstpu-torch-chunk-prefetch')
        self._thread.start()

    def stop(self):
        self._stop_event.set()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- internals -----------------------------------------------------------

    def _file(self, path, fs):
        from petastorm_tpu_torch.chunkstore.reader import ChunkCachedParquetFile
        if path in self._files:
            return self._files[path]
        if len(self._files) >= _MAX_OPEN_FILES:
            _, old = self._files.popitem(last=False)
            if old is not None:
                old.close()
        try:
            pf = ChunkCachedParquetFile(path, fs, self._config)
        except Exception as e:  # noqa: BLE001 - prefetch is advisory: never fail the reader
            logger.debug('prefetch open of %s failed: %s', path, e)
            pf = None
        self._files[path] = pf  # None cached too: no per-item retry storm
        return pf

    def _reap_consumed(self):
        """Drop outstanding entries whose mirror was consumed (demand hit
        bumped mtime) or evicted; returns outstanding byte total."""
        import os
        kept = deque()
        total = 0
        while self._outstanding:
            path, size, populate_ns = self._outstanding.popleft()
            try:
                st = os.stat(path)
            except OSError:
                continue  # evicted: no longer in flight
            if st.st_mtime_ns > populate_ns:
                continue  # a reader touched it: consumed
            kept.append((path, size, populate_ns))
            total += size
        self._outstanding = kept
        return total

    def _await_budget(self, next_size):
        """Block (stop-aware) until ``next_size`` more bytes fit the budget.
        A chunk larger than the whole budget is fetched alone."""
        budget = self._config.prefetch_budget_bytes
        while not self._stop_event.is_set():
            total = self._reap_consumed()
            if total == 0 or total + next_size <= budget:
                return True
            self._stop_event.wait(_POLL_S)
        return False

    def _run(self):
        from petastorm_tpu_torch.chunkstore.store import open_store
        try:
            fs = self._fs_factory()
        except Exception as e:  # noqa: BLE001 - advisory thread: log and bow out
            logger.warning('chunk prefetcher could not create filesystem: %s', e)
            return
        store = open_store(self._config)
        while not self._stop_event.is_set():
            try:
                items = self._ventilator.upcoming_items(self._config.prefetch_lookahead)
            except Exception as e:  # noqa: BLE001 - ventilator stopping: bow out
                logger.debug('prefetcher upcoming_items failed: %s', e)
                return
            fetched_any = False
            for item in items:
                if self._stop_event.is_set():
                    return
                piece = self._pieces[item['piece_index']]
                mark = (piece.path, piece.row_group)
                if mark in self._done:
                    continue
                pf = self._file(piece.path, fs)
                if pf is None:
                    self._done.add(mark)
                    continue
                for key, length, fetch_fn in pf.chunk_plan(piece.row_group,
                                                           self._columns):
                    if self._stop_event.is_set():
                        return
                    if store.contains(key, length):
                        continue
                    if not self._await_budget(length):
                        return
                    try:
                        path, mtime_ns, fetched = store.ensure(
                            key, length, fetch_fn, for_prefetch=True)
                    except Exception as e:  # noqa: BLE001 - advisory: workers fetch on demand
                        logger.debug('prefetch of %s failed: %s', key, e)
                        continue
                    if fetched:
                        fetched_any = True
                        self._outstanding.append((path, length, mtime_ns))
                self._done.add(mark)
                if len(self._done) > 100_000:
                    self._done.clear()
            if not fetched_any:
                self._stop_event.wait(_POLL_S)
