"""Filesystem resolution: dataset URL -> (pyarrow filesystem, path).

Trimmed twin of ``petastorm_tpu/fs.py``: local ``file://`` URLs only. Remote
schemes (hdfs, s3, gs) raise until their retry and HA layers are ported.
"""

from __future__ import annotations

from urllib.parse import urlparse

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import PetastormTpuError


class FilesystemResolver(object):
    """Resolves a ``file://`` dataset URL into a ``pyarrow.fs.LocalFileSystem``
    and an absolute path."""

    def __init__(self, dataset_url):
        if not isinstance(dataset_url, str):
            raise PetastormTpuError('dataset_url must be a string, got {}'.format(type(dataset_url)))
        dataset_url = dataset_url.rstrip('/')
        parsed = urlparse(dataset_url)
        if not parsed.scheme:
            raise PetastormTpuError(
                'URL {!r} has no scheme. Use file://<absolute path> for local datasets '
                '(e.g. file:///tmp/my_dataset).'.format(dataset_url))
        if parsed.scheme != 'file':
            raise PetastormTpuError(
                'URL scheme {!r} is not yet ported to petastorm_tpu_torch (local file:// only; '
                'see ROADMAP.md)'.format(parsed.scheme))
        if parsed.netloc not in ('', 'localhost'):
            raise PetastormTpuError('file:// URL must not have a host: {}'.format(dataset_url))
        self._path = parsed.path

    def filesystem(self):
        return pafs.LocalFileSystem()

    def get_dataset_path(self):
        return self._path
