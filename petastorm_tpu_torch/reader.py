"""Reader factory and orchestrator: the framework's main read path.

Trimmed twin of ``make_reader`` / ``Reader`` in ``petastorm_tpu/reader.py``:
list the row groups, select columns, filter the row groups through a
row-group selector's stored indexes, then a predicate (row groups of a
partition key; never, while hive stores are not ported), shard round-robin,
ventilate one item per (row group, shuffle-row-drop partition) in the seeded
per-epoch order into a thread, process or dummy pool, and deliver rows or
column blocks, optionally through a local-disk cache of decoded blocks. The
workers filter rows by the predicate. For a given seed the item order is the
JAX package's. The arguments of the JAX ``make_reader`` that are not ported
yet raise :class:`NotImplementedError` naming their ROADMAP item when given a
non-default value.
"""

from __future__ import annotations

import pickle

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.columnar import BatchResultsQueueReader
from petastorm_tpu_torch.errors import EmptyResultError, NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
from petastorm_tpu_torch.row_worker import RowGroupDecoderWorker, RowResultsQueueReader
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.workers import (ConcurrentVentilator, DummyPool, ErrorPolicy,
                                         ProcessPool, ThreadPool)

# extra row groups ventilated beyond the worker count: bounds decoded-data
# memory while keeping workers busy
_VENTILATE_EXTRA_ROWGROUPS = 2

#: make_reader arguments of the JAX package not ported yet:
#: name -> (JAX default, ROADMAP item that ports it)
_NOT_YET_PORTED = {
    'ngram': (None, 'long context'),
    'batch_size': (None, 'loader state_dict/resume'),
    'drop_last': (False, 'loader state_dict/resume'),
    'resume_state': (None, 'loader state_dict/resume'),
    'storage_retry_policy': (None, 'remote filesystems'),
    'chunk_cache': (None, 'remote filesystems'),
    'chunk_cache_size_limit': (None, 'remote filesystems'),
    'telemetry': (None, 'observability'),
    'autotune': (None, 'observability'),
    'protocol_monitor': (None, 'observability'),
    'serve': (None, 'DDP/mesh'),
    'serve_weight': (1, 'DDP/mesh'),
    'elastic': (None, 'DDP/mesh'),
    'piece_filter': (None, 'DDP/mesh'),
}


def _make_pool(reader_pool_type, workers_count, results_queue_size, serializer=None,
               on_error='raise', max_item_retries=None, zero_copy=False, pool_kwargs=None):
    """The pool of ``reader_pool_type``. Every worker publishes column
    blocks, so the process pool's serializer defaults to the raw-buffer
    :class:`NumpyBlockSerializer`; blocks arrive as writable numpy views over
    the IPC message. ``zero_copy`` (process pool, shm transport) delivers
    them as lifetime-tracked views straight into the ring slot; the thread
    and dummy pools hand over in-process arrays already, so for them it is a
    no-op. ``on_error``/``max_item_retries`` behave alike on every pool.
    ``pool_kwargs`` are further :class:`ProcessPool` arguments."""
    policy = ErrorPolicy.resolve(on_error, max_item_retries)
    if pool_kwargs and reader_pool_type != 'process':
        raise ValueError("pool_kwargs apply to reader_pool_type='process' only")
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size, on_error=policy)
    if reader_pool_type == 'process':
        return ProcessPool(workers_count, results_queue_size,
                           serializer=serializer or NumpyBlockSerializer(),
                           on_error=policy, zero_copy=zero_copy, **(pool_kwargs or {}))
    if reader_pool_type == 'dummy':
        return DummyPool(on_error=policy)
    raise ValueError('Unknown reader_pool_type {!r} (expected thread/process/dummy)'.format(
        reader_pool_type))


def build_work_items(num_pieces, shuffle_row_drop_partitions, worker_predicate):
    """The ventilation item list of a filtered piece set, the JAX package's
    (``petastorm_tpu/serve/plan.py``): one kwargs dict per (piece, row-drop
    partition), carrying the worker predicate when one is left after the
    piece-level pushdown."""
    items = []
    for piece_index in range(num_pieces):
        for drop_part in range(shuffle_row_drop_partitions):
            item = {'piece_index': piece_index}
            if worker_predicate is not None:
                item['worker_predicate'] = worker_predicate
            if shuffle_row_drop_partitions > 1:
                item['shuffle_row_drop_partition'] = (drop_part, shuffle_row_drop_partitions)
            items.append(item)
    return items


def _check_picklable(predicate):
    """A process pool's items reach its spawned workers pickled: refuse a
    predicate that cannot be (a lambda, a local function) before any item is
    sent, where the ventilator's thread would otherwise fail unseen."""
    try:
        pickle.dumps(predicate)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise pickle.PicklingError(
            'predicate {!r} cannot be pickled for the process pool\'s spawned workers ({}); '
            'define its functions at module level, or read with '
            "reader_pool_type='thread'".format(predicate, e)) from e


def _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate):
    if cache_type in (None, 'null'):
        return NullCache()
    if cache_type == 'local-disk':
        if not cache_location:
            raise ValueError("cache_type='local-disk' requires cache_location")
        kwargs = {}
        if cache_size_limit:
            kwargs['size_limit_bytes'] = cache_size_limit
        if cache_row_size_estimate:
            kwargs['expected_cell_size_bytes'] = cache_row_size_estimate
        return LocalDiskCache(cache_location, **kwargs)
    raise ValueError('Unknown cache_type {!r} (expected null/local-disk)'.format(cache_type))


def make_reader(dataset_url,
                schema_fields=None,
                reader_pool_type='thread', workers_count=10, results_queue_size=50,
                seed=None,
                shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                predicate=None,
                rowgroup_selector=None,
                num_epochs=1,
                cur_shard=None, shard_count=None,
                cache_type='null', cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None,
                transform_spec=None,
                output='rows',
                on_error='raise', max_item_retries=None, zero_copy=False, pool_kwargs=None,
                **not_yet_ported):
    """Reader for datasets written by :func:`materialize_dataset`.

    :param schema_fields: field names / regex patterns / UnischemaFields to
        read (``None`` = all)
    :param reader_pool_type: ``'thread'``, ``'process'`` (spawned worker
        processes, results over shared-memory rings; see
        :class:`~petastorm_tpu_torch.workers.ProcessPool`) or ``'dummy'``
        (the consumer thread)
    :param seed: seeds the per-epoch row-group shuffle; ``None`` = nondeterministic
    :param shuffle_row_drop_partitions: split each row group into this many
        contiguous row slices, each its own work item (more items shuffled
        per epoch, fewer rows of one row group in a row); every row is still
        read once per epoch
    :param predicate: a :class:`~petastorm_tpu_torch.predicates.PredicateBase`
        row filter, evaluated by the workers (natively, with page-stat
        skipping, where its ``native_clauses`` allow)
    :param rowgroup_selector: a
        :class:`~petastorm_tpu_torch.selectors.RowGroupSelectorBase` that
        keeps the row groups its stored indexes name
        (:func:`~petastorm_tpu_torch.etl.build_rowgroup_index`)
    :param num_epochs: passes over the dataset; ``None`` = infinite
    :param cur_shard/shard_count: keep row groups where
        ``index % shard_count == cur_shard``
    :param cache_type: ``'null'`` or ``'local-disk'``: a cache of decoded
        (and decode-time resized) row-group blocks in ``cache_location``,
        bounded by ``cache_size_limit`` bytes; ``cache_row_size_estimate``
        only warns when the bound holds few entries
    :param transform_spec: :class:`TransformSpec` run on the workers
    :param output: ``'rows'`` yields one schema namedtuple per row;
        ``'columnar'`` yields one namedtuple of column arrays per row group
        (the hot path :class:`TorchDataLoader` slices batches from)
    :param on_error: item-failure policy, the same on every pool type:
        ``'raise'`` surfaces the first worker error on the iterating thread
        with the worker-side traceback attached; ``'retry'`` re-runs a failed
        row group up to ``max_item_retries`` times before raising; ``'skip'``
        retries, then quarantines it (:attr:`Reader.quarantined_items`,
        ``diagnostics['items_quarantined']``) and the epoch completes without
        it. A process pool survives the death of a worker process whatever
        the policy (respawn and requeue); the policy decides what happens
        when one item exhausts its budget.
    :param max_item_retries: consecutive failures (errors or worker-killing
        crashes) one item may cause before the policy's final action
        (default 2: an item runs at most 3 times)
    :param zero_copy: process pool on the shm transport: deliver blocks as
        numpy views straight into the ring slot instead of a copy each;
        the slot's bytes are reused only after the block's arrays die, so
        holding a block applies backpressure. With no transform and no cache
        the workers then decode fused row groups straight into the slot. A
        no-op for the thread and dummy pools.
    :param pool_kwargs: further arguments of the process pool
        (:class:`~petastorm_tpu_torch.workers.ProcessPool`: ``transport``,
        ``ring_bytes``, ``results_timeout_s``, ``blob_threshold_bytes``,
        ...); the JAX ``make_reader`` has no such argument and always takes
        the pool's defaults
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
    # the pool is built, not started, before any IO: a bad policy or pool
    # type fails first
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, on_error=on_error,
                      max_item_retries=max_item_retries, zero_copy=zero_copy,
                      pool_kwargs=pool_kwargs)
    try:
        schema = dataset_metadata.get_schema(dataset_url)
    except dataset_metadata.PetastormMetadataError:
        raise PetastormTpuError('Dataset at {} is missing unischema metadata.'.format(dataset_url))
    results_reader = BatchResultsQueueReader if output == 'columnar' else RowResultsQueueReader
    cache = _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate)
    return Reader(dataset_url, schema, pool, results_reader, schema_fields=schema_fields,
                  seed=seed, shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, cache=cache,
                  transform_spec=transform_spec)


class Reader(object):
    """Orchestrates piece listing, sharding, the ventilator and the pool."""

    #: NGram windows are not ported (the long-context item); the loader
    #: reads this attribute
    ngram = None

    def __init__(self, dataset_url, schema, pool, results_reader_factory, schema_fields=None,
                 seed=None, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                 predicate=None, rowgroup_selector=None, num_epochs=1, cur_shard=None,
                 shard_count=None, cache=NullCache(), transform_spec=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range for shard_count {}'.format(
                cur_shard, shard_count))
        if shuffle_row_drop_partitions < 1:
            raise ValueError('shuffle_row_drop_partitions must be >= 1')
        self.schema = schema
        #: the decoded-block cache (``stats()`` counts its hits and misses)
        self.cache = cache
        resolver = FilesystemResolver(dataset_url)
        output_schema = (schema.create_schema_view(schema_fields)
                         if schema_fields is not None else schema)
        self.output_schema = output_schema
        self.transform_spec = transform_spec
        self.transformed_schema = (transform_schema(output_schema, transform_spec)
                                   if transform_spec is not None else output_schema)

        # selector (its index sets refer to the unfiltered enumeration, so it
        # runs first) -> predicate -> shard
        pieces = dataset_metadata.load_row_groups(dataset_url)
        if rowgroup_selector is not None:
            pieces = self._apply_rowgroup_selector(dataset_url, pieces, rowgroup_selector)
        pieces, worker_predicate = self._apply_predicate_to_pieces(pieces, predicate)
        if cur_shard is not None:
            pieces = [p for i, p in enumerate(pieces) if i % shard_count == cur_shard]
        if not pieces:
            raise NoDataAvailableError(
                'No row groups selected for reading (dataset={}, shard {}/{}). Check predicate/'
                'selector, or reduce shard_count.'.format(dataset_url, cur_shard, shard_count))
        if worker_predicate is not None and isinstance(pool, ProcessPool):
            _check_picklable(worker_predicate)
        self._pieces = pieces
        self._ventilator = ConcurrentVentilator(
            pool.ventilate, build_work_items(len(pieces), shuffle_row_drop_partitions,
                                             worker_predicate),
            iterations=num_epochs,
            max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS,
            randomize_item_order=shuffle_row_groups, random_seed=seed)
        self._results_reader = results_reader_factory(self.transformed_schema)
        self._pool = pool
        self._stopped = False
        pool.start(RowGroupDecoderWorker,
                   {'filesystem': resolver.filesystem(),
                    'dataset_path': resolver.get_dataset_path(),
                    'cache': self.cache,
                    'pieces': pieces,
                    'schema': schema,
                    'output_schema': output_schema,
                    'transform_spec': transform_spec,
                    'transformed_schema': self.transformed_schema},
                   ventilator=self._ventilator)

    @staticmethod
    def _apply_predicate_to_pieces(pieces, predicate):
        """Piece-level pushdown: when every predicate field is a partition
        key, whole pieces are dropped with no I/O and no worker predicate is
        left. Pieces carry no partition keys while hive stores are not
        ported, so the workers always filter."""
        if predicate is None:
            return pieces, None
        predicate_fields = set(predicate.get_fields())
        if pieces and predicate_fields and all(
                predicate_fields <= set(p.partition_keys) for p in pieces):
            kept = [p for p in pieces
                    if predicate.do_include({f: p.partition_keys[f] for f in predicate_fields})]
            return kept, None
        return pieces, predicate

    @staticmethod
    def _apply_rowgroup_selector(dataset_url, pieces, selector):
        """Filter pieces through the stored row-group indexes. Their index
        sets refer to the unfiltered piece enumeration, so this runs before
        any other filter."""
        indexes = get_row_group_indexes(dataset_url)
        for name in selector.get_index_names():
            if name not in indexes:
                raise PetastormTpuError('Index {!r} does not exist in the dataset'.format(name))
        selected = selector.select_row_groups(indexes)
        return [p for i, p in enumerate(pieces) if i in selected]

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

    @property
    def diagnostics(self):
        """The pool's diagnostics: items ventilated, completed and in
        flight, the recovery counters (``worker_restarts``,
        ``items_requeued``, ``items_quarantined``), the ``lifetime_*``
        borrow counters and, for a process pool, its transport and
        publishes per channel."""
        return self._pool.diagnostics

    @property
    def quarantined_items(self):
        """Records of the row groups quarantined under ``on_error='skip'``."""
        return self._pool.quarantined_items

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
