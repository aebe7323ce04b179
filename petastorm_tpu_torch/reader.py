"""Reader factory and orchestrator: the framework's main read path.

Trimmed twin of ``make_reader`` / ``Reader`` in ``petastorm_tpu/reader.py``:
list the row groups, select columns, shard round-robin, ventilate
(piece index) items in the seeded per-epoch order into a thread or dummy
pool, and deliver rows or per-row-group column blocks. For a given seed the
row-group order is the JAX package's. The arguments of the JAX
``make_reader`` that are not ported yet raise :class:`NotImplementedError`
naming their ROADMAP item when given a non-default value.
"""

from __future__ import annotations

from petastorm_tpu_torch.columnar import BatchResultsQueueReader
from petastorm_tpu_torch.errors import EmptyResultError, NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.row_worker import RowGroupDecoderWorker, RowResultsQueueReader
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers import ConcurrentVentilator, DummyPool, ThreadPool

# extra row groups ventilated beyond the worker count: bounds decoded-data
# memory while keeping workers busy
_VENTILATE_EXTRA_ROWGROUPS = 2

#: make_reader arguments of the JAX package not ported yet:
#: name -> (JAX default, ROADMAP item that ports it)
_NOT_YET_PORTED = {
    'shuffle_row_drop_partitions': (1, 'predicates/selectors/ngram'),
    'predicate': (None, 'predicates/selectors/ngram'),
    'rowgroup_selector': (None, 'predicates/selectors/ngram'),
    'ngram': (None, 'predicates/selectors/ngram'),
    'cache_type': ('null', 'local_disk_cache'),
    'cache_location': (None, 'local_disk_cache'),
    'cache_size_limit': (None, 'local_disk_cache'),
    'cache_row_size_estimate': (None, 'local_disk_cache'),
    'batch_size': (None, 'loader state_dict/resume'),
    'drop_last': (False, 'loader state_dict/resume'),
    'resume_state': (None, 'loader state_dict/resume'),
    'storage_retry_policy': (None, 'remote filesystems'),
    'chunk_cache': (None, 'remote filesystems'),
    'chunk_cache_size_limit': (None, 'remote filesystems'),
    'telemetry': (None, 'observability'),
    'autotune': (None, 'observability'),
    'on_error': ('raise', 'process pool + serializers'),
    'max_item_retries': (None, 'process pool + serializers'),
    'protocol_monitor': (None, 'process pool + serializers'),
    'zero_copy': (False, 'process pool + serializers'),
    'serve': (None, 'DDP/mesh'),
    'serve_weight': (1, 'DDP/mesh'),
    'elastic': (None, 'DDP/mesh'),
    'piece_filter': (None, 'DDP/mesh'),
}


def make_reader(dataset_url,
                schema_fields=None,
                reader_pool_type='thread', workers_count=10, results_queue_size=50,
                seed=None,
                shuffle_row_groups=True,
                num_epochs=1,
                cur_shard=None, shard_count=None,
                transform_spec=None,
                output='rows',
                **not_yet_ported):
    """Reader for datasets written by :func:`materialize_dataset`.

    :param schema_fields: field names / regex patterns / UnischemaFields to
        read (``None`` = all)
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (consumer thread)
    :param seed: seeds the per-epoch row-group shuffle; ``None`` = nondeterministic
    :param num_epochs: passes over the dataset; ``None`` = infinite
    :param cur_shard/shard_count: keep row groups where
        ``index % shard_count == cur_shard``
    :param transform_spec: :class:`TransformSpec` run on the workers
    :param output: ``'rows'`` yields one schema namedtuple per row;
        ``'columnar'`` yields one namedtuple of column arrays per row group
        (the hot path :class:`TorchDataLoader` slices batches from)
    """
    for name, value in not_yet_ported.items():
        if name not in _NOT_YET_PORTED:
            raise TypeError('make_reader() got an unexpected keyword argument {!r}'.format(name))
        default, item = _NOT_YET_PORTED[name]
        if value != default:
            raise NotImplementedError(
                'make_reader({}=...) is not yet ported to petastorm_tpu_torch '
                '(ROADMAP.md, "{}")'.format(name, item))
    if output not in ('rows', 'columnar'):
        raise ValueError("output must be 'rows' or 'columnar', got {!r}".format(output))
    try:
        schema = dataset_metadata.get_schema(dataset_url)
    except dataset_metadata.PetastormMetadataError:
        raise PetastormTpuError('Dataset at {} is missing unischema metadata.'.format(dataset_url))
    if reader_pool_type == 'thread':
        pool = ThreadPool(workers_count, results_queue_size)
    elif reader_pool_type == 'dummy':
        pool = DummyPool()
    elif reader_pool_type == 'process':
        raise NotImplementedError("reader_pool_type='process' is not yet ported to "
                                  'petastorm_tpu_torch (ROADMAP.md, "process pool + serializers")')
    else:
        raise ValueError('Unknown reader_pool_type {!r} (expected thread/dummy)'.format(
            reader_pool_type))
    results_reader = BatchResultsQueueReader if output == 'columnar' else RowResultsQueueReader
    return Reader(dataset_url, schema, pool, results_reader, schema_fields=schema_fields,
                  seed=seed, shuffle_row_groups=shuffle_row_groups, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, transform_spec=transform_spec)


class Reader(object):
    """Orchestrates piece listing, sharding, the ventilator and the pool."""

    #: NGram windows are not ported; the loader reads this attribute
    ngram = None

    def __init__(self, dataset_url, schema, pool, results_reader_factory, schema_fields=None,
                 seed=None, shuffle_row_groups=True, num_epochs=1, cur_shard=None,
                 shard_count=None, transform_spec=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range for shard_count {}'.format(
                cur_shard, shard_count))
        self.schema = schema
        resolver = FilesystemResolver(dataset_url)
        output_schema = (schema.create_schema_view(schema_fields)
                         if schema_fields is not None else schema)
        self.output_schema = output_schema
        self.transform_spec = transform_spec
        self.transformed_schema = (transform_schema(output_schema, transform_spec)
                                   if transform_spec is not None else output_schema)

        pieces = dataset_metadata.load_row_groups(dataset_url)
        if cur_shard is not None:
            pieces = [p for i, p in enumerate(pieces) if i % shard_count == cur_shard]
        if not pieces:
            raise NoDataAvailableError(
                'No row groups selected for reading (dataset={}, shard {}/{}). Reduce '
                'shard_count.'.format(dataset_url, cur_shard, shard_count))
        self._pieces = pieces
        self._ventilator = ConcurrentVentilator(
            pool.ventilate, [{'piece_index': i} for i in range(len(pieces))],
            iterations=num_epochs,
            max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS,
            randomize_item_order=shuffle_row_groups, random_seed=seed)
        self._results_reader = results_reader_factory(self.transformed_schema)
        self._pool = pool
        self._stopped = False
        pool.start(RowGroupDecoderWorker,
                   {'filesystem': resolver.filesystem(),
                    'pieces': pieces,
                    'schema': schema,
                    'output_schema': output_schema,
                    'transform_spec': transform_spec,
                    'transformed_schema': self.transformed_schema},
                   ventilator=self._ventilator)

    @property
    def batched_output(self):
        return self._results_reader.batched_output

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self._results_reader.read_next(self._pool)
        except EmptyResultError:
            raise StopIteration

    def stop(self):
        self._pool.stop()
        self._stopped = True

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if not self._stopped:
            self.stop()
            self.join()
