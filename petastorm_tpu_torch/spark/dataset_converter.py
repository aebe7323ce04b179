"""DataFrame-to-store converter: materialize a dataframe once as Parquet,
then make torch and TF loaders over the cached copy.

Twin of ``petastorm_tpu/spark/dataset_converter.py``: the cache directory
with dedup (converting the same frame again reuses one copy), float precision
normalization, atexit deletion of the cache directories, a pluggable delete
handler, and loaders over ``make_batch_reader``.

* pandas DataFrames and pyarrow Tables are taken natively (a local Arrow
  write, no Spark); pyspark DataFrames when pyspark is importable. pandas
  is imported for every frame that is not a Spark one, as in the JAX
  package.
* The dedup key is the JAX package's: a Spark frame's logical plan, or the
  content hash of a local frame's Arrow IPC stream, with the options, so
  the same frame gives the same key in either package.
* The flagship loader is :meth:`DatasetConverter.make_torch_loader` (a
  :class:`~petastorm_tpu_torch.torch.TorchDataLoader` staging onto the card,
  the JAX package's ``make_jax_loader``); ``make_torch_dataloader`` and
  ``make_tf_dataset`` keep the reference's surface.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import threading
import uuid
import warnings
from urllib.parse import urlparse

from petastorm_tpu_torch.fs import FilesystemResolver

logger = logging.getLogger(__name__)

DEFAULT_ROW_GROUP_SIZE_BYTES = 32 * 1024 * 1024

#: environment variable naming the parent cache directory URL (the reference
#: uses the spark conf key ``petastorm.spark.converter.parentCacheDirUrl``)
CACHE_DIR_ENV_VAR = 'PETASTORM_TPU_CONVERTER_CACHE_DIR'

_cache_lock = threading.Lock()
_cache_entries = []  # list of _CachedFrameMeta


class _CachedFrameMeta(object):
    def __init__(self, fingerprint, cache_dir_url, dataset_size):
        self.fingerprint = fingerprint
        self.cache_dir_url = cache_dir_url
        self.dataset_size = dataset_size


def _default_delete_dir_handler(dataset_url):
    import shutil
    resolver = FilesystemResolver(dataset_url)
    parsed = urlparse(dataset_url)
    if parsed.scheme == 'file':
        shutil.rmtree(parsed.path, ignore_errors=False)
    else:
        resolver.filesystem().delete_dir(resolver.get_dataset_path())


_delete_dir_handler = _default_delete_dir_handler


def register_delete_dir_handler(handler):
    """Override how cache directories are deleted; ``None`` restores the
    default."""
    global _delete_dir_handler
    _delete_dir_handler = handler if handler is not None else _default_delete_dir_handler


def _delete_cache_data_atexit(dataset_url):
    try:
        _delete_dir_handler(dataset_url)
    except FileNotFoundError:
        pass  # already deleted through converter.delete()
    except Exception:  # noqa: BLE001 - the interpreter is exiting: warn, do not die
        warnings.warn('delete cache data {} failed.'.format(dataset_url))


# -- input normalization -------------------------------------------------------

def _is_spark_df(df):
    return type(df).__module__.startswith('pyspark.')


def _to_arrow_table(df, precision):
    """A pyarrow.Table cast to the float precision. pandas frames are
    converted to Tables once, up front, in :func:`make_converter`."""
    import pyarrow as pa

    if not isinstance(df, pa.Table):
        raise TypeError('Unsupported dataframe type: {} (expected pyarrow.Table '
                        'or pyspark DataFrame)'.format(type(df)))
    source, target = (pa.float64(), pa.float32()) if precision == 'float32' \
        else (pa.float32(), pa.float64())
    fields = [pa.field(f.name, target) if f.type == source else f for f in df.schema]
    return df.cast(pa.schema(fields))


class _HashSink(object):
    """File-like sink feeding an Arrow IPC stream straight into a hash."""

    def __init__(self, digest):
        self._digest = digest

    def write(self, data):
        self._digest.update(data)
        return len(data)

    def flush(self):
        pass

    def close(self):
        pass

    @property
    def closed(self):
        return False


def _fingerprint(df, parent_cache_dir_url, row_group_size, compression, precision):
    """The cache key. Spark: the logical plan; local frames: a hash of the
    Arrow IPC stream (exact, list and tensor columns included, and stable
    across re-created frames). The parent cache directory is part of the
    key, so a new directory materializes again."""
    suffix = '|dir={}|rg={}|cc={}|p={}'.format(parent_cache_dir_url, row_group_size,
                                               compression, precision)
    if _is_spark_df(df):
        plan = df._jdf.queryExecution().analyzed().toString()
        return 'spark:' + hashlib.sha1(plan.encode()).hexdigest() + suffix
    import pyarrow as pa
    if not isinstance(df, pa.Table):
        # make_converter converts pandas frames up front; direct callers must too
        raise TypeError('Unsupported dataframe type: {} (expected pyarrow.Table '
                        'or pyspark DataFrame)'.format(type(df)))
    digest = hashlib.sha1()
    digest.update(str(df.schema).encode())
    with pa.ipc.new_stream(_HashSink(digest), df.schema) as writer:
        writer.write_table(df)
    return 'local:' + digest.hexdigest() + suffix


# -- materialization -----------------------------------------------------------

def rows_per_row_group_for_bytes(table, row_group_size_bytes):
    """Bytes target -> rows (Arrow writers take rows)."""
    row_bytes = max(1, table.nbytes // max(1, table.num_rows))
    return max(1, row_group_size_bytes // row_bytes)


def _gen_cache_dir_name():
    # {datetime}-{uuid}: greppable for a manual clean-up if atexit never ran
    import datetime
    return '{}-{}'.format(datetime.datetime.now().strftime('%Y%m%d%H%M%S'), uuid.uuid4())


def _materialize(df, parent_cache_dir_url, row_group_size_bytes, compression, precision):
    """Write the frame as Parquet under a fresh subdirectory; returns
    ``(url, n_rows)``."""
    import pyarrow.parquet as pq

    cache_dir_url = parent_cache_dir_url.rstrip('/') + '/' + _gen_cache_dir_name()
    if _is_spark_df(df):
        from pyspark.sql.functions import col
        from pyspark.sql.types import ArrayType, DoubleType, FloatType
        source, target = (DoubleType, FloatType) if precision == 'float32' \
            else (FloatType, DoubleType)
        for field in df.schema:
            if isinstance(field.dataType, source):
                df = df.withColumn(field.name, col(field.name).cast(target()))
            elif isinstance(field.dataType, ArrayType) and \
                    isinstance(field.dataType.elementType, source):
                df = df.withColumn(field.name, col(field.name).cast(ArrayType(target())))
        df.write.option('compression', compression or 'snappy') \
            .option('parquet.block.size', row_group_size_bytes).parquet(cache_dir_url)
        n_rows = df.count()
    else:
        table = _to_arrow_table(df, precision)
        resolver = FilesystemResolver(cache_dir_url)
        fs, path = resolver.filesystem(), resolver.get_dataset_path()
        fs.create_dir(path, recursive=True)
        with fs.open_output_stream(path + '/part-00000.parquet') as f:
            pq.write_table(table, f,
                           row_group_size=rows_per_row_group_for_bytes(table, row_group_size_bytes),
                           compression=compression or 'snappy')
        n_rows = table.num_rows
    atexit.register(_delete_cache_data_atexit, cache_dir_url)
    logger.info('Materialized dataframe to %s (%d rows)', cache_dir_url, n_rows)
    return cache_dir_url, n_rows


# -- converter -----------------------------------------------------------------

class DatasetConverter(object):
    """One materialized dataframe, and loaders over it. Picklable: another
    process opens the cache URL again."""

    def __init__(self, cache_dir_url, dataset_size):
        self.cache_dir_url = cache_dir_url
        self.dataset_size = dataset_size

    def __len__(self):
        return self.dataset_size

    def make_torch_loader(self, batch_size=32, num_epochs=None, workers_count=10,
                          device=None, to_device=None, shuffling_queue_capacity=0, seed=None,
                          drop_last=True, cur_shard=None, shard_count=None, **reader_kwargs):
        """A :class:`~petastorm_tpu_torch.torch.TorchDataLoader` over the
        cache, its batches staged onto ``device`` (``None``: the card; pass
        ``'cpu'`` for host tensors) or onto ``to_device`` (a device or a
        :class:`~petastorm_tpu_torch.parallel.DataSharding`). Use it as a
        context manager, so that the reader is closed on exit."""
        from petastorm_tpu_torch import make_batch_reader
        from petastorm_tpu_torch.device import resolve_device
        from petastorm_tpu_torch.torch import TorchDataLoader
        if to_device is not None and device is not None:
            raise ValueError('pass device or to_device, not both')
        target = to_device if to_device is not None else resolve_device(device)
        reader = make_batch_reader(self.cache_dir_url, num_epochs=num_epochs,
                                   workers_count=workers_count, seed=seed,
                                   cur_shard=cur_shard, shard_count=shard_count,
                                   **reader_kwargs)
        return TorchDataLoader(reader, batch_size=batch_size, to_device=target,
                               shuffling_queue_capacity=shuffling_queue_capacity,
                               seed=seed, drop_last=drop_last)

    def make_torch_dataloader(self, batch_size=32, num_epochs=None, workers_count=10,
                              cur_shard=None, shard_count=None, **reader_kwargs):
        """The reference-API :class:`petastorm_tpu_torch.torch_utils.DataLoader`
        (host tensors) over the cache, as a context manager."""
        from petastorm_tpu_torch import make_batch_reader
        from petastorm_tpu_torch.torch_utils import DataLoader
        reader = make_batch_reader(self.cache_dir_url, num_epochs=num_epochs,
                                   workers_count=workers_count, cur_shard=cur_shard,
                                   shard_count=shard_count, **reader_kwargs)
        return DataLoader(reader, batch_size=batch_size)

    def make_tf_dataset(self, batch_size=32, num_epochs=None, workers_count=10,
                        **reader_kwargs):
        """A ``tf.data.Dataset`` context manager over the cache. Requires
        tensorflow."""
        from petastorm_tpu_torch import make_batch_reader
        from petastorm_tpu_torch.tf_utils import make_tf_dataset_context
        reader = make_batch_reader(self.cache_dir_url, num_epochs=num_epochs,
                                   workers_count=workers_count, **reader_kwargs)
        return make_tf_dataset_context(reader, batch_size=batch_size)

    def delete(self):
        """Delete the cache files now instead of at interpreter exit."""
        with _cache_lock:
            global _cache_entries
            _cache_entries = [m for m in _cache_entries
                              if m.cache_dir_url != self.cache_dir_url]
        _delete_dir_handler(self.cache_dir_url)


#: the reference's name
SparkDatasetConverter = DatasetConverter


def _resolve_parent_cache_dir(parent_cache_dir_url):
    url = parent_cache_dir_url or os.environ.get(CACHE_DIR_ENV_VAR)
    if not url:
        raise ValueError(
            'No converter cache dir configured. Pass parent_cache_dir_url= or set '
            'the {} environment variable (the reference uses the spark conf key '
            'petastorm.spark.converter.parentCacheDirUrl).'.format(CACHE_DIR_ENV_VAR))
    FilesystemResolver(url)  # refuses an unknown scheme early
    return url


def make_converter(df, parent_cache_dir_url=None,
                   parquet_row_group_size_bytes=DEFAULT_ROW_GROUP_SIZE_BYTES,
                   compression_codec=None, precision='float32'):
    """Materialize ``df`` (pandas, pyarrow or pyspark) into a Parquet cache and
    return a :class:`DatasetConverter`. Converting the same frame again (same
    row-group size, codec and precision) reuses the cached copy."""
    if precision not in ('float32', 'float64'):
        raise ValueError("precision {} is not supported. Use 'float32' or "
                         "'float64'".format(precision))
    parent = _resolve_parent_cache_dir(parent_cache_dir_url)
    if not _is_spark_df(df):
        import pandas as pd
        if isinstance(df, pd.DataFrame):
            # once, up front: the fingerprint and the write both need the
            # Arrow table, and a second from_pandas doubles peak memory
            import pyarrow as pa
            df = pa.Table.from_pandas(df, preserve_index=False)
    key = _fingerprint(df, parent, parquet_row_group_size_bytes, compression_codec, precision)
    with _cache_lock:
        for meta in _cache_entries:
            if meta.fingerprint == key:
                return DatasetConverter(meta.cache_dir_url, meta.dataset_size)
        url, n_rows = _materialize(df, parent, parquet_row_group_size_bytes,
                                   compression_codec, precision)
        _cache_entries.append(_CachedFrameMeta(key, url, n_rows))
        return DatasetConverter(url, n_rows)


#: the reference's name
make_spark_converter = make_converter
