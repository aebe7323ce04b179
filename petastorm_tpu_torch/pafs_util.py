"""Shared ``pyarrow.fs.FileSystemHandler`` delegation base.

Twin of ``petastorm_tpu/pafs_util.py``. Two wrappers of the port present a
Python object as a genuine pyarrow filesystem (``PyFileSystem``): the HA-HDFS
failover client (``hdfs/namenode.py``) and the transient-retry object-store
wrapper (``retry.py``); tests add fault-injecting ones. The delegation
boilerplate (one method per handler op, plus the compression subtlety on
output opens) lives here once, so a change of pyarrow's handler API is fixed
in one place.
"""

from __future__ import annotations

import pyarrow.fs as pafs


class DelegatingHandler(pafs.FileSystemHandler):
    """Delegates every handler op to ``self.fs`` (a pyarrow filesystem or any
    object exposing the same method surface) through the :meth:`_invoke` hook.

    Subclasses override :meth:`_invoke` for cross-cutting behavior (retries,
    failover, fault injection) and individual methods for op-specific behavior.
    """

    def __init__(self, fs):
        self.fs = fs

    def _invoke(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    # -- identity ----------------------------------------------------------

    def __eq__(self, other):
        if type(other) is type(self):
            return self.fs == other.fs
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        # keep every handler (and the PyFileSystem wrapping it) hashable:
        # __eq__ without __hash__ would set __hash__ = None (PT600). The
        # delegate fs cannot participate — pyarrow FileSystems are unhashable
        return hash(type(self))

    def get_type_name(self):
        return 'delegating+' + self.fs.type_name

    def normalize_path(self, path):
        return self.fs.normalize_path(path)

    # -- metadata ops ------------------------------------------------------

    def get_file_info(self, paths):
        return self._invoke(self.fs.get_file_info, paths)

    def get_file_info_selector(self, selector):
        return self._invoke(self.fs.get_file_info, selector)

    def create_dir(self, path, recursive):
        self._invoke(self.fs.create_dir, path, recursive=recursive)

    def delete_dir(self, path):
        self._invoke(self.fs.delete_dir, path)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self._invoke(self.fs.delete_dir_contents, path, missing_dir_ok=missing_dir_ok)

    def delete_root_dir_contents(self):
        self._invoke(self.fs.delete_dir_contents, '/', accept_root_dir=True)

    def delete_file(self, path):
        self._invoke(self.fs.delete_file, path)

    def move(self, src, dest):
        self._invoke(self.fs.move, src, dest)

    def copy_file(self, src, dest):
        self._invoke(self.fs.copy_file, src, dest)

    # -- streams -----------------------------------------------------------

    def open_input_stream(self, path):
        return self._invoke(self.fs.open_input_stream, path)

    def open_input_file(self, path):
        return self._invoke(self.fs.open_input_file, path)

    def open_output_stream(self, path, metadata):
        # compression=None: the outer PyFileSystem already applies
        # suffix-detected compression; the inner default of 'detect' would
        # stack a second compressor on e.g. *.gz paths
        return self._invoke(self.fs.open_output_stream, path,
                            compression=None, metadata=metadata)

    def open_append_stream(self, path, metadata):
        return self._invoke(self.fs.open_append_stream, path,
                            compression=None, metadata=metadata)
