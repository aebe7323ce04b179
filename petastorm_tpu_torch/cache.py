"""Row-group cache protocol (twin of ``petastorm_tpu/cache.py``)."""

from __future__ import annotations


class CacheBase(object):
    def get(self, key, fill_cache_func):
        """Return the cached value for ``key``; on miss call ``fill_cache_func()``,
        store its result, and return it."""
        raise NotImplementedError

    def cleanup(self):
        """Remove cache resources (optional)."""

    def stats(self):
        """Counters of the cache's use (``{}`` where it keeps none)."""
        return {}


class NullCache(CacheBase):
    """Never caches: always calls through."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()
