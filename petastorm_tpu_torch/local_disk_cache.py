"""Local disk cache with size-bounded LRU eviction.

Twin of ``petastorm_tpu/local_disk_cache.py``: one file per key (pickle),
atomic tmp+rename writes so concurrent workers never observe partial
entries, and least-recently-used eviction driven by file mtimes (reads bump
mtime). The reader caches decoded (and decode-time resized) column blocks,
so every epoch after the first skips the image decode. Also counts hits and
misses (:meth:`LocalDiskCache.stats`).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import shutil
import tempfile
import threading

from petastorm_tpu_torch.cache import CacheBase

logger = logging.getLogger(__name__)

_DEFAULT_SIZE_LIMIT = 10 * 2 ** 30  # 10 GiB


class LocalDiskCache(CacheBase):
    """
    :param path: cache directory (created if absent)
    :param size_limit_bytes: total cache size bound; eviction keeps usage under it
    :param expected_cell_size_bytes: rough per-entry size estimate, used to
        warn when the limit holds too few entries to be worth caching
    :param cleanup: remove the cache directory on ``cleanup()``
    """

    def __init__(self, path, size_limit_bytes=_DEFAULT_SIZE_LIMIT, expected_cell_size_bytes=None,
                 cleanup=False):
        self._path = path
        self._size_limit = size_limit_bytes
        self._cleanup = cleanup
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        if expected_cell_size_bytes and size_limit_bytes < 100 * expected_cell_size_bytes:
            logger.warning('Cache size limit %d holds fewer than 100 expected entries '
                           '(%d bytes each); the cache may thrash.',
                           size_limit_bytes, expected_cell_size_bytes)
        os.makedirs(self._path, exist_ok=True)

    def _entry_path(self, key):
        digest = hashlib.sha1(key.encode('utf-8')).hexdigest()
        return os.path.join(self._path, digest[:2], digest + '.pkl')

    def get(self, key, fill_cache_func):
        entry = self._entry_path(key)
        try:
            with open(entry, 'rb') as f:
                # the entries are pickles this cache wrote itself
                value = pickle.load(f)
            os.utime(entry, None)  # bump mtime: LRU recency
            with self._lock:
                self._hits += 1
            return value
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            pass
        with self._lock:
            self._misses += 1
        value = fill_cache_func()
        self._store(entry, value)
        return value

    def stats(self):
        with self._lock:
            return {'hits': self._hits, 'misses': self._misses}

    def _store(self, entry, value):
        os.makedirs(os.path.dirname(entry), exist_ok=True)
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) > self._size_limit:
            logger.warning('Entry of %d bytes exceeds the cache size limit; not caching', len(blob))
            return
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(entry), suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(blob)
            os.replace(tmp, entry)  # atomic: readers never see partial entries
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._evict_if_needed()

    def _evict_if_needed(self):
        with self._lock:
            entries = []
            total = 0
            for dirpath, _, filenames in os.walk(self._path):
                for name in filenames:
                    if not name.endswith('.pkl'):
                        continue
                    full = os.path.join(dirpath, name)
                    try:
                        st = os.stat(full)
                    except OSError:
                        continue
                    entries.append((st.st_mtime, st.st_size, full))
                    total += st.st_size
            if total <= self._size_limit:
                return
            entries.sort()  # oldest mtime first
            for _, size, full in entries:
                try:
                    os.unlink(full)
                    total -= size
                except OSError:
                    pass
                if total <= self._size_limit:
                    break

    def cleanup(self):
        if self._cleanup:
            shutil.rmtree(self._path, ignore_errors=True)
