"""Chunk store: zero-copy page scan and fused reads for REMOTE Parquet stores.

Twin of ``petastorm_tpu/chunkstore/__init__.py``. The local read path's
biggest wins (the page scanner serving column chunks as zero-copy mmap
views, the fused native read decoding a row group in one call) need a local
file, so a remote store would always decode through Arrow over the network.
This package mirrors raw column-chunk byte ranges into a local
content-addressed cache and serves the mirrors through the same scanner and
fused call:

* :class:`~petastorm_tpu_torch.chunkstore.store.ChunkStore`: atomic
  single-writer population, size-bounded LRU eviction that skips mappings a
  live batch still references, hit/miss/byte/eviction counters merged across
  worker processes;
* :class:`~petastorm_tpu_torch.chunkstore.reader.ChunkCachedParquetFile`:
  the Parquet-file surface the workers consume, the mirrored columns served
  from the cache and the rest through Arrow over the remote filesystem;
* :class:`~petastorm_tpu_torch.chunkstore.prefetch.ChunkPrefetcher`: walks
  the ventilator's upcoming row-group order and fetches chunks ahead under a
  bounded in-flight byte budget.

Enable it with ``make_reader(..., chunk_cache='auto' | <path>)``; the
counters appear as ``chunk_cache_*`` keys in ``Reader.diagnostics`` and
``TorchDataLoader.diagnostics``. The ``'auto'`` root is the port's own,
``<tmp>/pstpu_torch_chunk_cache/<sha1(url)[:16]>`` (the JAX package's is
``<tmp>/pstpu_chunk_cache/...``): each process's store writes
``<root>/stats/pid-<pid>.json``, so a JAX store and a port store on one
root in one process would overwrite each other's counters.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

from petastorm_tpu_torch.chunkstore.store import (ChunkCacheConfig, ChunkStore,  # noqa: F401
                                                  open_store)


def resolve_chunk_cache(chunk_cache, dataset_url, is_local, size_limit_bytes=None):
    """The ``chunk_cache`` argument of the factories as a
    :class:`ChunkCacheConfig`, or None.

    ``None``/``False`` disables it. A local dataset never engages it (the
    page scanner maps local files directly: a mirror would only double the
    IO). ``'auto'`` derives a directory per dataset under the system temp
    directory; a string is the cache directory; a config passes through.
    """
    if chunk_cache in (None, False):
        return None
    if is_local:
        return None
    if isinstance(chunk_cache, ChunkCacheConfig):
        return chunk_cache
    if chunk_cache == 'auto':
        root = os.path.join(tempfile.gettempdir(), 'pstpu_torch_chunk_cache',
                            hashlib.sha1(dataset_url.encode('utf-8')).hexdigest()[:16])
    elif isinstance(chunk_cache, str):
        root = chunk_cache
    else:
        raise ValueError("chunk_cache must be None, 'auto', a directory path, or a "
                         'ChunkCacheConfig, got {!r}'.format(chunk_cache))
    kwargs = {}
    if size_limit_bytes:
        kwargs['size_limit_bytes'] = size_limit_bytes
    return ChunkCacheConfig(root, **kwargs)


def cache_diagnostics(config):
    """The flat ``chunk_cache_*`` counter dict of ``Reader.diagnostics``."""
    snapshot = open_store(config).stats_snapshot()
    return {'chunk_cache_' + k: v for k, v in snapshot.items()}


__all__ = ['ChunkCacheConfig', 'ChunkStore', 'cache_diagnostics', 'open_store',
           'resolve_chunk_cache']
