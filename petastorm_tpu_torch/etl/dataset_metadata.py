"""Dataset materialization and metadata.

Trimmed twin of ``petastorm_tpu/etl/dataset_metadata.py``. The writer and the
metadata keys are the JAX package's, byte for byte: the JSON unischema and the
per-file row-group counts live in ``_common_metadata`` under
``petastorm_tpu.unischema.v1`` / ``petastorm_tpu.num_row_groups_per_file.v1``,
so a store written by either package is read by the other; columns whose
codec stores compressed cells (images, ``compressed_ndarray``) are written
uncompressed, as the JAX writer does. Row-group indexes live under
``petastorm_tpu.rowgroups_index.v1`` (:func:`add_dataset_metadata` rewrites
the footer keeping every other key). A plain Parquet store's schema is
inferred from its first file (:func:`infer_or_load_unischema`). Not ported
yet: hive partitioning (pieces carry an empty ``partition_keys`` mapping),
append/publish, the ``_metadata`` summary-file and legacy petastorm
fallbacks.
"""

from __future__ import annotations

import json
import posixpath
from contextlib import contextmanager

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.unischema import Unischema, encode_row

UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'
ROW_GROUP_INDEX_KEY = b'petastorm_tpu.rowgroups_index.v1'
#: the unischema key of stores written by the original petastorm library
LEGACY_UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'

_COMMON_METADATA = '_common_metadata'

DEFAULT_ROW_GROUP_SIZE_MB = 32


class PetastormMetadataError(PetastormTpuError):
    """Dataset metadata is missing or malformed."""


class RowGroupPiece(object):
    """One row group of one Parquet file: the unit of work ventilated to
    decode workers and the unit of shard assignment. ``partition_keys`` is
    always empty: hive-partitioned stores are not ported yet."""

    __slots__ = ('path', 'row_group', 'num_rows', 'partition_keys')

    def __init__(self, path, row_group, num_rows=None):
        self.path = path
        self.row_group = row_group
        self.num_rows = num_rows
        self.partition_keys = {}

    def __repr__(self):
        return 'RowGroupPiece({!r}, rg={}, rows={})'.format(self.path, self.row_group, self.num_rows)

    def __eq__(self, other):
        return (isinstance(other, RowGroupPiece) and self.path == other.path and
                self.row_group == other.row_group)

    def __hash__(self):
        return hash((self.path, self.row_group))


class DatasetWriter(object):
    """Row-oriented Parquet writer with explicit row-group size control.

    Rows are encoded through the schema's codecs, buffered, and flushed as one
    row group when ``rows_per_row_group`` rows (or ``row_group_size_mb`` of
    encoded bytes) are buffered. A new file starts every ``rows_per_file`` rows.
    ``compression``: a dataset-wide codec name (``'snappy'`` default), a
    ``{column: codec}`` dict, or ``None`` for uncompressed; with the string
    form, columns whose codec prefers another compression (raw tensors:
    ``'none'``) get their preference.
    """

    def __init__(self, dataset_url, schema, row_group_size_mb=None, rows_per_row_group=None,
                 rows_per_file=None, compression='snappy'):
        resolver = FilesystemResolver(dataset_url)
        self._fs = resolver.filesystem()
        self._root = resolver.get_dataset_path()
        self._schema = schema
        self._row_group_bytes = int((row_group_size_mb or DEFAULT_ROW_GROUP_SIZE_MB) * (1 << 20))
        self._rows_per_row_group = rows_per_row_group
        self._rows_per_file = rows_per_file
        fields = list(schema)
        if isinstance(compression, dict):
            self._compression = compression
        else:
            default = compression if compression is not None else 'none'
            overrides = {f.name: f.codec.preferred_column_compression for f in fields
                         if f.codec.preferred_column_compression is not None
                         and f.codec.preferred_column_compression != default}
            self._compression = ({**{f.name: default for f in fields}, **overrides}
                                 if overrides else compression)
        self._arrow_schema = schema.as_arrow_schema()
        self._names = [f.name for f in fields]
        # fixed-size-binary (raw tensor) columns, and their flat non-null
        # numeric siblings, are written dictionary-free with a data page sized
        # to hold a whole row group: the JAX package's layout, which its
        # zero-copy page scanner serves
        fsb = [n for n in self._names
               if pa.types.is_fixed_size_binary(self._arrow_schema.field(n).type)]
        self._pq_kwargs = {}
        if fsb:
            def _plain(name):
                f = self._arrow_schema.field(name)
                return name in fsb or (not f.nullable and (pa.types.is_integer(f.type) or
                                                           pa.types.is_floating(f.type)))
            self._pq_kwargs['use_dictionary'] = [n for n in self._names if not _plain(n)]
            per_group = (self._rows_per_row_group *
                         max(self._arrow_schema.field(n).type.byte_width for n in fsb)
                         if self._rows_per_row_group is not None else self._row_group_bytes)
            self._pq_kwargs['data_page_size'] = max(1 << 20, per_group + (64 << 10))
        self.row_groups_per_file = {}  # relpath -> [rows per row group]
        self._buffer = {name: [] for name in self._names}
        self._buffered_bytes = 0
        self._buffered_rows = 0
        self._rows_in_file = 0
        self._file_seq = 0
        self._pq_writer = None
        self._cur_relpath = None
        self._closed = False
        self._fs.create_dir(self._root, recursive=True)

    def write(self, row_dict):
        """Encode and buffer one row (a dict of in-memory field values)."""
        if self._closed:
            raise PetastormTpuError('Writer is closed')
        for name, value in encode_row(self._schema, row_dict).items():
            self._buffer[name].append(value)
            self._buffered_bytes += len(value) if isinstance(value, (bytes, str)) else 8
        self._buffered_rows += 1
        if self._rows_per_row_group is not None:
            if self._buffered_rows >= self._rows_per_row_group:
                self._flush_row_group()
        elif self._buffered_bytes >= self._row_group_bytes:
            self._flush_row_group()

    def _open_file(self):
        relpath = 'part-{:05d}.parquet'.format(self._file_seq)
        self._file_seq += 1
        sink = self._fs.open_output_stream(posixpath.join(self._root, relpath))
        self._pq_writer = pq.ParquetWriter(sink, self._arrow_schema, compression=self._compression,
                                           **self._pq_kwargs)
        self._cur_relpath = relpath
        self._rows_in_file = 0
        self.row_groups_per_file[relpath] = []

    def _flush_row_group(self):
        if self._buffered_rows == 0:
            return
        if self._pq_writer is None:
            self._open_file()
        arrays = [pa.array(self._buffer[name], type=self._arrow_schema.field(name).type)
                  for name in self._names]
        self._pq_writer.write_table(pa.Table.from_arrays(arrays, schema=self._arrow_schema))
        self.row_groups_per_file[self._cur_relpath].append(self._buffered_rows)
        self._rows_in_file += self._buffered_rows
        self._buffer = {name: [] for name in self._names}
        self._buffered_bytes = 0
        self._buffered_rows = 0
        if self._rows_per_file is not None and self._rows_in_file >= self._rows_per_file:
            self._close_file()

    def _close_file(self):
        if self._pq_writer is not None:
            self._pq_writer.close()
            self._pq_writer = None
            self._cur_relpath = None

    def close(self):
        if self._closed:
            return
        self._flush_row_group()
        self._close_file()
        self._closed = True


@contextmanager
def materialize_dataset(dataset_url, schema, row_group_size_mb=None, rows_per_row_group=None,
                        rows_per_file=None, compression='snappy'):
    """Context manager bracketing a dataset write. Yields a
    :class:`DatasetWriter`; on exit closes it, writes ``_common_metadata``
    (JSON unischema + per-file row-group counts) and checks the store lists
    at least one row group."""
    writer = DatasetWriter(dataset_url, schema, row_group_size_mb=row_group_size_mb,
                           rows_per_row_group=rows_per_row_group, rows_per_file=rows_per_file,
                           compression=compression)
    try:
        yield writer
    finally:
        writer.close()
    _write_dataset_metadata(dataset_url, schema, writer.row_groups_per_file)
    if not load_row_groups(dataset_url):
        raise PetastormMetadataError('Dataset at {} has no row groups after write'.format(dataset_url))


def write_petastorm_dataset(dataset_url, schema, rows, **writer_kwargs):
    """Write an iterable of row dicts as a dataset in one call
    (:func:`materialize_dataset` with ``writer_kwargs``)."""
    with materialize_dataset(dataset_url, schema, **writer_kwargs) as writer:
        for row in rows:
            writer.write(row)


def _write_dataset_metadata(dataset_url, schema, row_groups_per_file):
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    metadata = {
        UNISCHEMA_KEY: json.dumps(schema.to_json()).encode('utf-8'),
        ROW_GROUPS_PER_FILE_KEY: json.dumps(row_groups_per_file).encode('utf-8'),
    }
    with fs.open_output_stream(posixpath.join(root, _COMMON_METADATA)) as sink:
        pq.write_metadata(schema.as_arrow_schema().with_metadata(metadata), sink)


def _read_common_schema(fs, root):
    """The Arrow schema (with its KV metadata) stored in ``_common_metadata``,
    or None."""
    meta_path = posixpath.join(root, _COMMON_METADATA)
    if fs.get_file_info([meta_path])[0].type == pafs.FileType.NotFound:
        return None
    with fs.open_input_file(meta_path) as f:
        return pq.read_schema(f)


def _read_common_metadata(fs, root):
    """The KV metadata stored in ``_common_metadata``, or ``{}``."""
    arrow_schema = _read_common_schema(fs, root)
    return dict(arrow_schema.metadata or {}) if arrow_schema is not None else {}


def add_dataset_metadata(dataset_url, key, value_bytes):
    """Rewrite ``_common_metadata`` with ``key`` set to ``value_bytes``,
    keeping its schema and every other key."""
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    existing = _read_common_schema(fs, root)
    arrow_schema = existing if existing is not None else pa.schema([])
    metadata = dict(arrow_schema.metadata or {})
    metadata[key] = value_bytes
    with fs.open_output_stream(posixpath.join(root, _COMMON_METADATA)) as sink:
        pq.write_metadata(arrow_schema.with_metadata(metadata), sink)


def read_metadata_dict(dataset_url):
    """All KV metadata of ``_common_metadata`` as a dict (one footer read)."""
    resolver = FilesystemResolver(dataset_url)
    return _read_common_metadata(resolver.filesystem(), resolver.get_dataset_path())


def _list_parquet_files(fs, root):
    """Data files in path order, skipping ``_``/``.`` prefixed entries."""
    files = []
    for info in fs.get_file_info(pafs.FileSelector(root, recursive=True)):
        base = posixpath.basename(info.path)
        if info.type == pafs.FileType.File and not base.startswith(('_', '.')) \
                and not base.endswith('.crc'):
            files.append(info.path)
    return sorted(files)


def _check_unpartitioned(relpath):
    if any('=' in part for part in relpath.split('/')[:-1]):
        raise NotImplementedError('hive-partitioned stores are not yet ported to '
                                  'petastorm_tpu_torch (see ROADMAP.md): {}'.format(relpath))


def load_row_groups(dataset_url):
    """All row-group pieces of the dataset, in the JAX package's order: from
    the stored per-file counts when present (no footer reads), else from
    every data file's footer."""
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    meta = _read_common_metadata(fs, root)
    pieces = []
    if ROW_GROUPS_PER_FILE_KEY in meta:
        counts = json.loads(meta[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
        for relpath in sorted(counts):
            _check_unpartitioned(relpath)
            entry = counts[relpath]
            row_counts = entry if isinstance(entry, list) else [None] * entry
            for rg, num_rows in enumerate(row_counts):
                pieces.append(RowGroupPiece(posixpath.join(root, relpath), rg, num_rows))
        return pieces
    for path in _list_parquet_files(fs, root):
        _check_unpartitioned(posixpath.relpath(path, root))
        with fs.open_input_file(path) as f:
            md = pq.ParquetFile(f).metadata
        pieces.extend(RowGroupPiece(path, i, md.row_group(i).num_rows)
                      for i in range(md.num_row_groups))
    return pieces


def get_schema(dataset_url):
    """Load the stored Unischema; raise if the dataset has none."""
    resolver = FilesystemResolver(dataset_url)
    meta = _read_common_metadata(resolver.filesystem(), resolver.get_dataset_path())
    if UNISCHEMA_KEY not in meta:
        raise PetastormMetadataError(
            'Could not find unischema metadata in dataset at {}: it was not written by '
            'petastorm_tpu / petastorm_tpu_torch, or its _common_metadata file was lost.'.format(
                dataset_url))
    return Unischema.from_json(json.loads(meta[UNISCHEMA_KEY].decode('utf-8')))


def infer_or_load_unischema(dataset_url):
    """The stored Unischema, else one inferred from the first data file's
    Arrow schema (:meth:`Unischema.from_arrow_schema`: columns of types it
    cannot map are left out). Hive-partitioned stores and stores written by
    the original petastorm library are refused: neither is ported yet."""
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    meta = _read_common_metadata(fs, root)
    if UNISCHEMA_KEY in meta:
        return Unischema.from_json(json.loads(meta[UNISCHEMA_KEY].decode('utf-8')))
    if LEGACY_UNISCHEMA_KEY in meta:
        raise NotImplementedError('stores written by the original petastorm library are not yet '
                                  'ported to petastorm_tpu_torch (ROADMAP.md, "remote '
                                  'filesystems"): {}'.format(dataset_url))
    files = _list_parquet_files(fs, root)
    if not files:
        raise PetastormMetadataError('No parquet files found at {}'.format(dataset_url))
    _check_unpartitioned(posixpath.relpath(files[0], root))
    with fs.open_input_file(files[0]) as f:
        return Unischema.from_arrow_schema(pq.ParquetFile(f).schema_arrow)
