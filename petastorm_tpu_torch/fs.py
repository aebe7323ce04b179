"""Filesystem resolution: dataset URL -> (pyarrow filesystem, path).

Twin of ``petastorm_tpu/fs.py``. ``pyarrow.fs`` (Arrow C++ filesystems)
covers local, HDFS, S3 and GCS. Scheme-less URLs are refused, to avoid
ambiguity between local paths and default-filesystem paths.

Object stores and ``mock-remote://`` (local files behind the same retry
wrapper, for tests and the smoke run of the remote paths) are wrapped in the
bounded-backoff retrier of :mod:`petastorm_tpu_torch.retry` unless
``retry_policy=False``; HDFS gets the HA namenode failover of
:mod:`petastorm_tpu_torch.hdfs.namenode` instead. Worker processes receive a
picklable factory (:meth:`FilesystemResolver.filesystem_factory`) and
resolve the filesystem themselves, never a live handle.
"""

from __future__ import annotations

import os
from urllib.parse import urlparse

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import PetastormTpuError


class FilesystemResolver(object):
    """Resolves a dataset URL into a ``pyarrow.fs.FileSystem`` and an
    in-filesystem path.

    Schemes: ``file://``, ``hdfs://``, ``s3://``, ``gs://``/``gcs://`` and
    ``mock-remote://`` (local files treated as a remote store).
    """

    def __init__(self, dataset_url, retry_policy=None):
        """``retry_policy``: a :class:`petastorm_tpu_torch.retry.RetryPolicy`
        for transient errors of object-store IO; ``None`` takes the defaults
        for ``s3://``, ``gs://`` and ``mock-remote://``, ``False`` wraps
        nothing."""
        if not isinstance(dataset_url, str):
            raise PetastormTpuError('dataset_url must be a string, got {}'.format(type(dataset_url)))
        dataset_url = dataset_url.rstrip('/')
        parsed = urlparse(dataset_url)
        if not parsed.scheme:
            raise PetastormTpuError(
                'URL {!r} has no scheme. Use file://<absolute path> for local datasets '
                '(e.g. file:///tmp/my_dataset), or hdfs://, s3://, gs://.'.format(dataset_url))
        self._url = dataset_url
        self._scheme = parsed.scheme
        self._retry_policy = retry_policy
        if parsed.scheme == 'file':
            if parsed.netloc not in ('', 'localhost'):
                raise PetastormTpuError('file:// URL must not have a host: {}'.format(dataset_url))
            self._path = parsed.path
            self._filesystem = pafs.LocalFileSystem()
        elif parsed.scheme in ('gs', 'gcs'):
            self._filesystem = _wrap_object_store(pafs.GcsFileSystem(), retry_policy)
            self._path = parsed.netloc + parsed.path
        elif parsed.scheme == 's3':
            self._filesystem = _wrap_object_store(pafs.S3FileSystem(), retry_policy)
            self._path = parsed.netloc + parsed.path
        elif parsed.scheme == 'mock-remote':
            # the local filesystem behind the retry wrapper the object stores
            # get: every remote-only path (retrying streams, the chunk store,
            # pre_buffer reads) runs with no cloud credential
            if parsed.netloc not in ('', 'localhost'):
                raise PetastormTpuError(
                    'mock-remote:// URL must not have a host: {}'.format(dataset_url))
            self._filesystem = _wrap_object_store(pafs.LocalFileSystem(), retry_policy)
            self._path = parsed.path
        elif parsed.scheme == 'hdfs':
            # HDFS's elasticity is the HA namenode failover, no backoff
            # wrapper on top
            self._filesystem, self._path = _resolve_hdfs(dataset_url)
        else:
            raise PetastormTpuError('Unsupported URL scheme {!r} in {}'.format(
                parsed.scheme, dataset_url))

    @property
    def url(self):
        return self._url

    @property
    def scheme(self):
        return self._scheme

    @property
    def is_local(self):
        """True for plain local files (``file://``): mmap-able directly, so a
        byte-mirroring cache (the chunk store) has nothing to add.
        ``mock-remote://`` reports False: it exists to run the remote
        paths."""
        return self._scheme == 'file'

    def filesystem(self):
        return self._filesystem

    def get_dataset_path(self):
        return self._path

    def filesystem_factory(self):
        """A picklable zero-argument callable that recreates the filesystem,
        retry policy included, in another process. A custom ``classify`` on
        the policy must pickle (a module-level function) to cross into a
        process pool."""
        return _FilesystemFactory(self._url, self._retry_policy)

    def __getstate__(self):
        return {'url': self._url, 'retry_policy': self._retry_policy}

    def __setstate__(self, state):
        self.__init__(state['url'], retry_policy=state.get('retry_policy'))


def _wrap_object_store(fs, retry_policy):
    """Object stores answer transiently (429/503 throttles, resets) in normal
    operation: wrap them in the bounded-backoff retrier unless
    ``retry_policy=False``."""
    if retry_policy is False:
        return fs
    from petastorm_tpu_torch.retry import wrap_retrying
    return wrap_retrying(fs, retry_policy)


def _resolve_hdfs(dataset_url):
    """hdfs:// URL -> (filesystem, path). A configured HA nameservice (or an
    empty netloc, meaning ``fs.defaultFS``) gives an HA failover client
    wrapped as a genuine pyarrow filesystem; without a Hadoop configuration,
    Arrow's own URI handling (libhdfs' default filesystem, direct host
    connects) takes over."""
    from petastorm_tpu_torch.hdfs import namenode as nn

    try:
        return nn.resolve_and_connect(dataset_url, pyarrow_wrap=True)
    except nn.HdfsConnectError:
        # the resolution worked but every namenode refused: that diagnosis
        # (one error per namenode) is the one to show
        raise
    except (RuntimeError, IOError):
        # no or incomplete Hadoop configuration: libhdfs reads CLASSPATH
        # configuration itself and understands hdfs:///
        return pafs.FileSystem.from_uri(dataset_url)


class _FilesystemFactory(object):
    """Picklable zero-argument filesystem factory: a spawned worker resolves
    the URL again instead of receiving a live filesystem handle."""

    def __init__(self, url, retry_policy=None):
        self._url = url
        self._retry_policy = retry_policy

    def __call__(self):
        return FilesystemResolver(self._url, retry_policy=self._retry_policy).filesystem()


def path_to_url(path):
    """An absolute local path -> its ``file://`` URL."""
    return 'file://' + os.path.abspath(path)


def resolve_dataset_url(dataset_url):
    """``(filesystem, path)`` of a URL."""
    resolver = FilesystemResolver(dataset_url)
    return resolver.filesystem(), resolver.get_dataset_path()
