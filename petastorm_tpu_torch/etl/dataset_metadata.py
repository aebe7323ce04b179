"""Dataset materialization and metadata.

Twin of ``petastorm_tpu/etl/dataset_metadata.py``. The writer and the
metadata keys are the JAX package's, byte for byte: the JSON unischema and the
per-file row-group counts live in ``_common_metadata`` under
``petastorm_tpu.unischema.v1`` / ``petastorm_tpu.num_row_groups_per_file.v1``,
so a store written by either package is read by the other; columns whose
codec stores compressed cells (images, ``compressed_ndarray``) are written
uncompressed, as the JAX writer does. Row-group indexes live under
``petastorm_tpu.rowgroups_index.v1`` (:func:`add_dataset_metadata` rewrites
the footer keeping every other key).

Hive partitioning: ``partition_by=['field', ...]`` routes rows to
``field=value/`` directories (values percent-quoted), the partition columns
left out of the files; the pieces carry the typed values of their path
(:attr:`RowGroupPiece.partition_keys`), which the workers turn back into
columns. ``append=True`` grows an existing store: new part names, and the
counts written on close merged with the stored ones; ``DatasetWriter.publish``
stamps a snapshot of the rows written so far for tail followers.

:func:`load_row_groups` lists the pieces from the stored counts (also the
original petastorm library's), else from a ``_metadata`` summary file, else
from every data file's footer, read in parallel. A store written by the
original petastorm library has its schema and indexes pickled: they are
decoded by :mod:`~petastorm_tpu_torch.etl.legacy`. A plain Parquet store's
schema is inferred from its first file, partition columns included
(:func:`infer_or_load_unischema`). The readers take a ``retry_policy`` for
the resolver of a remote store (``s3``, ``gs``, ``mock-remote``; ``False``
wraps nothing).
"""

from __future__ import annotations

import json
import os
import posixpath
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from urllib.parse import quote, unquote

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import legacy
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.unischema import Unischema, UnischemaField, encode_row

UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'
ROW_GROUP_INDEX_KEY = b'petastorm_tpu.rowgroups_index.v1'

_COMMON_METADATA = '_common_metadata'
_SUMMARY_METADATA = '_metadata'

DEFAULT_ROW_GROUP_SIZE_MB = 32


class PetastormMetadataError(PetastormTpuError):
    """Dataset metadata is missing or malformed."""


class RowGroupPiece(object):
    """One row group of one Parquet file: the unit of work ventilated to
    decode workers and the unit of shard assignment. ``partition_keys`` maps
    each hive partition column of the file's path to its typed value."""

    __slots__ = ('path', 'row_group', 'num_rows', 'partition_keys')

    def __init__(self, path, row_group, num_rows=None, partition_keys=None):
        self.path = path
        self.row_group = row_group
        self.num_rows = num_rows
        self.partition_keys = partition_keys or {}

    def __repr__(self):
        return 'RowGroupPiece({!r}, rg={}, rows={}, partitions={})'.format(
            self.path, self.row_group, self.num_rows, self.partition_keys)

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

    ``partition_by=['field', ...]`` writes hive-style ``field=value/``
    directories, one open writer per directory; the partition columns live
    in the paths only. ``append=True`` grows an existing store: part names
    skip the files its ``_common_metadata`` lists, and
    :attr:`row_groups_per_file` merges them with the files written here.
    :meth:`publish` makes the rows written so far visible to a
    :class:`~petastorm_tpu_torch.sequence.TailFollowingReader`.
    One writer at a time: two appenders would race the metadata rewrite.
    """

    def __init__(self, dataset_url, schema, row_group_size_mb=None, rows_per_row_group=None,
                 rows_per_file=None, partition_by=None, compression='snappy', append=False):
        resolver = FilesystemResolver(dataset_url)
        self._dataset_url = dataset_url
        self._fs = resolver.filesystem()
        self._root = resolver.get_dataset_path()
        self._schema = schema
        self._row_group_bytes = int((row_group_size_mb or DEFAULT_ROW_GROUP_SIZE_MB) * (1 << 20))
        self._rows_per_row_group = rows_per_row_group
        self._rows_per_file = rows_per_file
        self._partition_by = list(partition_by or [])
        for name in self._partition_by:
            if name not in schema.fields:
                raise PetastormTpuError('partition_by field {!r} not in schema'.format(name))
        fields = [f for f in schema if f.name not in self._partition_by]
        if isinstance(compression, dict):
            self._compression = compression
        else:
            default = compression if compression is not None else 'none'
            overrides = {f.name: f.codec.preferred_column_compression for f in fields
                         if f.codec.preferred_column_compression is not None
                         and f.codec.preferred_column_compression != default}
            self._compression = ({**{f.name: default for f in fields}, **overrides}
                                 if overrides else compression)
        # the files' schema leaves the partition columns out
        self._arrow_schema = pa.schema([pa.field(f.name, f.codec.arrow_type(f), f.nullable)
                                        for f in fields])
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
        self._writers = {}  # partition directory ('' unpartitioned) -> _PartitionWriter
        self._written = {}  # relpath -> [rows per row group], this writer's files
        self._closed = False
        self._fs.create_dir(self._root, recursive=True)
        # append: the stored inventory seeds the merged counts and names the
        # part files that are taken
        self._existing = {}
        if append:
            meta = _read_common_metadata(self._fs, self._root)
            if ROW_GROUPS_PER_FILE_KEY in meta:
                self._existing = json.loads(meta[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))

    @property
    def row_groups_per_file(self):
        """``{relpath: [rows per row group]}`` of the whole store: the files
        it held before an append and the files written here."""
        return {**self._existing, **self._written}

    def write(self, row_dict):
        """Encode and buffer one row (a dict of in-memory field values)."""
        if self._closed:
            raise PetastormTpuError('Writer is closed')
        encoded = encode_row(self._schema, row_dict)
        rel_dir = self._partition_dir(encoded)
        writer = self._writers.get(rel_dir)
        if writer is None:
            writer = self._writers[rel_dir] = _PartitionWriter(self, rel_dir)
        writer.append({name: encoded[name] for name in self._names})

    def write_batch(self, rows):
        for row in rows:
            self.write(row)

    def _partition_dir(self, encoded_row):
        # percent-quoted as hive does, so a '/' in a value stays in one component
        return '/'.join('{}={}'.format(name, quote(str(encoded_row[name]), safe=''))
                        for name in self._partition_by)

    def publish(self, final=False):
        """Make every row written so far visible to readers and stamp a
        snapshot marker (the tail-following contract,
        :mod:`petastorm_tpu_torch.sequence.tail`).

        Flushes and closes every open part file (a Parquet footer exists
        only on a closed file), rewrites ``_common_metadata`` with the merged
        row-group counts, then publishes ``_snapshots/snap-NNNNNN.json``
        through :func:`~petastorm_tpu_torch.sequence.tail.publish_snapshot`.
        The writer stays usable: the next :meth:`write` opens a fresh part
        file under a name the store does not own yet, so a published file is
        never written again.

        :param final: marks the snapshot terminal, so followers stop polling
        :returns: the published snapshot id (int)
        """
        if self._closed:
            raise PetastormTpuError('Writer is closed')
        for writer in self._writers.values():
            writer.close()
        _write_dataset_metadata(self._dataset_url, self._schema, self.row_groups_per_file)
        from petastorm_tpu_torch.sequence.tail import publish_snapshot
        return publish_snapshot(self._dataset_url, final=final)

    def close(self):
        if self._closed:
            return
        for writer in self._writers.values():
            writer.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.close()


class _PartitionWriter(object):
    """Buffers the encoded rows of one output directory and writes its files
    and row groups."""

    def __init__(self, parent, rel_dir):
        self._parent = parent
        self._rel_dir = rel_dir
        self._buffer = {name: [] for name in parent._names}
        self._buffered_bytes = 0
        self._buffered_rows = 0
        self._rows_in_file = 0
        self._file_seq = 0
        self._pq_writer = None
        self._relpath = None

    def append(self, encoded_row):
        for name, value in encoded_row.items():
            self._buffer[name].append(value)
            self._buffered_bytes += len(value) if isinstance(value, (bytes, str)) else 8
        self._buffered_rows += 1
        p = self._parent
        if p._rows_per_row_group is not None:
            if self._buffered_rows >= p._rows_per_row_group:
                self._flush_row_group()
        elif self._buffered_bytes >= p._row_group_bytes:
            self._flush_row_group()

    def _open_file(self):
        p = self._parent
        while True:
            basename = 'part-{:05d}.parquet'.format(self._file_seq)
            self._file_seq += 1
            relpath = posixpath.join(self._rel_dir, basename) if self._rel_dir else basename
            # an append's sequence restarts at 0: skip the names the store owns
            if relpath not in p._existing and relpath not in p._written:
                break
        if self._rel_dir:
            p._fs.create_dir(posixpath.join(p._root, self._rel_dir), recursive=True)
        sink = p._fs.open_output_stream(posixpath.join(p._root, relpath))
        self._pq_writer = pq.ParquetWriter(sink, p._arrow_schema, compression=p._compression,
                                           **p._pq_kwargs)
        self._relpath = relpath
        self._rows_in_file = 0
        p._written[relpath] = []

    def _flush_row_group(self):
        if self._buffered_rows == 0:
            return
        p = self._parent
        if self._pq_writer is None:
            self._open_file()
        arrays = [pa.array(self._buffer[name], type=p._arrow_schema.field(name).type)
                  for name in p._names]
        self._pq_writer.write_table(pa.Table.from_arrays(arrays, schema=p._arrow_schema))
        p._written[self._relpath].append(self._buffered_rows)
        self._rows_in_file += self._buffered_rows
        self._buffer = {name: [] for name in p._names}
        self._buffered_bytes = 0
        self._buffered_rows = 0
        if p._rows_per_file is not None and self._rows_in_file >= p._rows_per_file:
            self._close_file()

    def _close_file(self):
        if self._pq_writer is not None:
            self._pq_writer.close()
            self._pq_writer = None
            self._relpath = None

    def close(self):
        self._flush_row_group()
        self._close_file()


@contextmanager
def materialize_dataset(dataset_url, schema, row_group_size_mb=None, rows_per_row_group=None,
                        rows_per_file=None, partition_by=None, compression='snappy',
                        append=False):
    """Context manager bracketing a dataset write. Yields a
    :class:`DatasetWriter`; on exit closes it, writes ``_common_metadata``
    (JSON unischema + per-file row-group counts, merged with the stored ones
    under ``append``) and checks the store lists at least one row group."""
    writer = DatasetWriter(dataset_url, schema, row_group_size_mb=row_group_size_mb,
                           rows_per_row_group=rows_per_row_group, rows_per_file=rows_per_file,
                           partition_by=partition_by, compression=compression, append=append)
    try:
        yield writer
    finally:
        writer.close()
    _write_dataset_metadata(dataset_url, schema, writer.row_groups_per_file)
    if not load_row_groups(dataset_url):
        raise PetastormMetadataError(
            'Dataset at {} has no row groups after write'.format(dataset_url))


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
    # written aside and renamed into place: a tail follower opening a delta
    # while the writer publishes the next one never reads a torn footer
    # (a rename is atomic on a local filesystem)
    path = posixpath.join(root, _COMMON_METADATA)
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    with fs.open_output_stream(tmp) as sink:
        pq.write_metadata(schema.as_arrow_schema().with_metadata(metadata), sink)
    fs.move(tmp, path)


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


def read_metadata_dict(dataset_url, retry_policy=None):
    """All KV metadata of ``_common_metadata`` as a dict (one footer read)."""
    resolver = FilesystemResolver(dataset_url, retry_policy=retry_policy)
    return _read_common_metadata(resolver.filesystem(), resolver.get_dataset_path())


def read_metadata_value(dataset_url, key):
    """One KV metadata value of ``_common_metadata`` (bytes), or None."""
    return read_metadata_dict(dataset_url).get(key)


def list_parquet_files(fs, root):
    """Data files in path order, skipping ``_``/``.`` prefixed entries."""
    files = []
    for info in fs.get_file_info(pafs.FileSelector(root, recursive=True)):
        base = posixpath.basename(info.path)
        if info.type == pafs.FileType.File and not base.startswith(('_', '.')) \
                and not base.endswith('.crc'):
            files.append(info.path)
    return sorted(files)


def _parse_partition_value(value, dtype):
    if dtype is np.str_:
        return value
    if dtype is np.bool_:
        # np.bool_('False') is True: parse the text
        return value.strip().lower() in ('true', '1')
    return np.dtype(dtype).type(value).item()


def _partition_keys_from_relpath(relpath, schema=None):
    """The hive ``key=value`` components of a file's relative path as typed
    partition keys: through the schema's field type when the schema has the
    field, else an int when the text is one, else the text."""
    keys = {}
    for component in relpath.split('/')[:-1]:
        if '=' not in component:
            continue
        key, value = component.split('=', 1)
        value = unquote(value)
        if schema is not None and key in schema.fields:
            try:
                keys[key] = _parse_partition_value(value, schema.fields[key].numpy_dtype)
            except (ValueError, TypeError):
                keys[key] = value
        else:
            try:
                keys[key] = int(value)
            except ValueError:
                keys[key] = value
    return keys


def _pieces(files, schema):
    """``[(path, relpath, [rows or None per row group])]`` -> the pieces."""
    pieces = []
    for path, relpath, row_counts in files:
        keys = _partition_keys_from_relpath(relpath, schema)
        for rg, num_rows in enumerate(row_counts):
            pieces.append(RowGroupPiece(path, rg, num_rows=num_rows, partition_keys=keys))
    return pieces


def _stored_pieces(root, row_counts_per_file, schema):
    """``{relpath: [rows or None per row group]}`` -> pieces in path order."""
    return _pieces([(posixpath.join(root, relpath), relpath, row_counts_per_file[relpath])
                    for relpath in sorted(row_counts_per_file)], schema)


def _summary_row_counts(fs, root):
    """``{relpath: [rows per row group]}`` from the ``_metadata`` summary
    file, or None when it is missing or a row group names no file."""
    summary_path = posixpath.join(root, _SUMMARY_METADATA)
    if fs.get_file_info([summary_path])[0].type != pafs.FileType.File:
        return None
    with fs.open_input_file(summary_path) as f:
        file_meta = pq.read_metadata(f)
    per_file = {}
    for i in range(file_meta.num_row_groups):
        rg = file_meta.row_group(i)
        file_path = rg.column(0).file_path
        if not file_path:
            return None  # a malformed summary: the footers decide
        per_file.setdefault(file_path, []).append(rg.num_rows)
    return per_file


def load_row_groups(dataset_url, schema=None, max_footer_read_threads=10,
                    use_cached_metadata=True, retry_policy=None):
    """All row-group pieces of the dataset, in the JAX package's order, by
    the first route that has them:

    1. the stored per-file counts (this package's key, else the original
       petastorm library's): no footer read;
    2. a ``_metadata`` summary file;
    3. every data file's footer, ``max_footer_read_threads`` at a time.

    ``use_cached_metadata=False`` skips routes 1 and 2: the footers are the
    ground truth when stored metadata may be stale. The partition keys are
    typed through ``schema`` (default: the stored one). ``retry_policy`` is
    the resolver's (:class:`~petastorm_tpu_torch.fs.FilesystemResolver`)."""
    resolver = FilesystemResolver(dataset_url, retry_policy=retry_policy)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    meta = _read_common_metadata(fs, root)
    if schema is None and UNISCHEMA_KEY in meta:
        schema = Unischema.from_json(json.loads(meta[UNISCHEMA_KEY].decode('utf-8')))

    if use_cached_metadata:
        counts = None
        if ROW_GROUPS_PER_FILE_KEY in meta:
            counts = json.loads(meta[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
        elif legacy.REF_ROW_GROUPS_PER_FILE_KEY in meta:
            counts = legacy.load_legacy_row_group_counts(meta[legacy.REF_ROW_GROUPS_PER_FILE_KEY])
        if counts is not None:
            # a list of rows per row group; an int is a count of row groups
            # whose rows were not recorded
            return _stored_pieces(root, {relpath: entry if isinstance(entry, list)
                                         else [None] * entry
                                         for relpath, entry in counts.items()}, schema)
        per_file = _summary_row_counts(fs, root)
        if per_file is not None:
            return _stored_pieces(root, per_file, schema)

    files = list_parquet_files(fs, root)

    def footer(path):
        with fs.open_input_file(path) as f:
            md = pq.ParquetFile(f).metadata
        return [md.row_group(i).num_rows for i in range(md.num_row_groups)]

    with ThreadPoolExecutor(max_workers=max_footer_read_threads) as executor:
        footers = list(executor.map(footer, files))
    return _pieces([(path, posixpath.relpath(path, root), rows)
                    for path, rows in zip(files, footers)], schema)


def _try_get_schema(fs, root):
    """The stored Unischema (this package's JSON, else the original petastorm
    library's pickle), or None."""
    meta = _read_common_metadata(fs, root)
    if UNISCHEMA_KEY in meta:
        return Unischema.from_json(json.loads(meta[UNISCHEMA_KEY].decode('utf-8')))
    if legacy.REF_UNISCHEMA_KEY in meta:
        return legacy.load_legacy_unischema(meta[legacy.REF_UNISCHEMA_KEY])
    return None


def get_schema(dataset_url, retry_policy=None):
    """Load the stored Unischema; raise if the dataset has none."""
    resolver = FilesystemResolver(dataset_url, retry_policy=retry_policy)
    schema = _try_get_schema(resolver.filesystem(), resolver.get_dataset_path())
    if schema is None:
        raise PetastormMetadataError(
            'Could not find unischema metadata in dataset at {}: it was not written by '
            'petastorm_tpu / petastorm_tpu_torch (use make_batch_reader for a plain Parquet '
            'store, or the generate_metadata tool), or its _common_metadata file was '
            'lost.'.format(dataset_url))
    return schema


def get_schema_from_dataset_url(dataset_url, storage_retry_policy=None):
    """The reference's name for :func:`get_schema`; ``storage_retry_policy``
    is threaded through as ``make_reader(storage_retry_policy=)`` does."""
    return get_schema(dataset_url, retry_policy=storage_retry_policy)


def infer_or_load_unischema(dataset_url, retry_policy=None):
    """The stored Unischema, else one inferred from the first data file's
    Arrow schema (:meth:`Unischema.from_arrow_schema`: columns of types it
    cannot map are left out), with a scalar field for each hive partition
    column of the file's path (int64 when its value is an int, else str)."""
    resolver = FilesystemResolver(dataset_url, retry_policy=retry_policy)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    schema = _try_get_schema(fs, root)
    if schema is not None:
        return schema
    files = list_parquet_files(fs, root)
    if not files:
        raise PetastormMetadataError('No parquet files found at {}'.format(dataset_url))
    with fs.open_input_file(files[0]) as f:
        schema = Unischema.from_arrow_schema(pq.ParquetFile(f).schema_arrow)
    keys = _partition_keys_from_relpath(posixpath.relpath(files[0], root))
    if not keys:
        return schema
    from petastorm_tpu_torch.codecs import ScalarCodec
    extra = [UnischemaField(k, np.int64 if isinstance(v, int) else np.str_, (), ScalarCodec(),
                            False) for k, v in keys.items()]
    return Unischema(schema.name, list(schema.fields.values()) + extra)
