"""Reader factories and orchestrator: the framework's main read path.

Trimmed twin of ``make_reader`` / ``make_batch_reader`` / ``Reader`` /
``merge_resume_states`` in ``petastorm_tpu/reader.py``: list the row groups,
keep those a ``piece_filter`` keeps, select columns, filter the row groups
through a row-group selector's stored indexes, then a predicate (whole row
groups by their hive partition keys, with no I/O, when every predicate field
is one), shard round-robin, ventilate one item per (row group,
shuffle-row-drop partition) in the seeded per-epoch order into a thread,
process or dummy pool, and deliver rows, column blocks or fixed-size batches,
optionally through a local-disk cache of decoded blocks. The workers filter
rows by the predicate. ``make_reader`` decodes a petastorm store through its
Unischema's codecs, and with ``ngram=`` delivers windows of consecutive rows
(:class:`~petastorm_tpu_torch.ngram.NGram`); ``make_batch_reader`` reads any
Parquet store as raw columns, its schema inferred when the store has none.

For a given seed the item order is the JAX package's, and so is the read
position a reader checkpoints (:meth:`Reader.state_dict`, ``resume_state=``):
a plain dict of ints, lists and a numpy bit-generator state, which either
package resumes. Both factories take the JAX factories' arguments, in their
order and with their defaults; ``reader_pool_type`` may also be a
:class:`~petastorm_tpu_torch.workers.ProcessPoolOptions`, the process pool
with further arguments (``transport``, ``ring_bytes``, ...).

``protocol_monitor=`` (or ``PSTPU_PROTOCOL_MONITOR=1``) attaches the runtime
conformance monitor of the supervision protocol
(:mod:`petastorm_tpu_torch.analysis.protocol.monitor`) to the pool: an event
sequence the spec rejects raises
:class:`~petastorm_tpu_torch.errors.ProtocolViolation` on the iterating
thread.

Telemetry (``telemetry=``, the process's level, ``'counters'`` by default)
and the autotuner (``autotune=``) are the JAX package's: the level is applied
process-wide and shipped to process-pool workers, :attr:`Reader.diagnostics`
merges the metrics registry, the workers' snapshots and the pool's counters,
and :attr:`Reader.last_trace` links the loader's spans to the item a block
came from.

With ``serve=`` ('auto' or a service directory) both factories read through
the per-host shared reader daemon instead (:mod:`petastorm_tpu_torch.serve`)
and return a :class:`~petastorm_tpu_torch.serve.ServedReader`: the same
results readers assemble rows, blocks or batches on the consumer's side of
the broadcast ring (:func:`_make_served`).

A remote store (``s3://``, ``gs://``, ``hdfs://``, ``mock-remote://``) is
read through the filesystem of :mod:`petastorm_tpu_torch.fs`, retry-wrapped
under ``storage_retry_policy``; the workers get a picklable filesystem
factory and resolve it in their own process. With ``chunk_cache=`` its
qualifying column chunks are mirrored to local disk
(:mod:`petastorm_tpu_torch.chunkstore`) and served by the page scan and the
fused read, and a prefetcher thread fetches the ventilator's upcoming
chunks ahead of the workers.

With ``elastic=`` the hosts of a pod share the row groups through a
coordination directory instead of static shard arithmetic
(:mod:`petastorm_tpu_torch.elastic`): the reader's ventilator is an
:class:`~petastorm_tpu_torch.elastic.coordinator.ElasticVentilator`, which
ventilates the row groups this host owns under the pod's current shard map
and commits each delivered one exactly once pod-wide.
"""

from __future__ import annotations

import pickle
import warnings

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.batch_worker import ArrowBatchWorker
from petastorm_tpu_torch.chunkstore import resolve_chunk_cache
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.columnar import BatchResultsQueueReader
from petastorm_tpu_torch.errors import EmptyResultError, NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
from petastorm_tpu_torch.rebatch import RebatchingResultsQueueReader
from petastorm_tpu_torch.row_worker import (NgramBlockResultsQueueReader, RowGroupDecoderWorker,
                                            RowResultsQueueReader)
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.workers import (ConcurrentVentilator, DummyPool, ErrorPolicy,
                                         ProcessPool, ProcessPoolOptions, ThreadPool)

# extra row groups ventilated beyond the worker count: bounds decoded-data
# memory while keeping workers busy
_VENTILATE_EXTRA_ROWGROUPS = 2

def _columnar_results_reader_factory(output, batch_size, drop_last, rows_factory):
    """The results reader of the output mode: rows, one block per row group,
    or blocks rebatched to ``batch_size`` rows."""
    if output == 'rows':
        if drop_last:
            raise ValueError('drop_last requires batch_size (without rebatching there is '
                             'no "last short batch" to drop)')
        return rows_factory
    if batch_size is not None:
        return lambda schema: RebatchingResultsQueueReader(schema, batch_size,
                                                           drop_last=drop_last)
    if drop_last:
        raise ValueError('drop_last requires batch_size (without rebatching, batches are '
                         'row-group-sized and there is no "last short batch" to drop)')
    return BatchResultsQueueReader


def _make_pool(reader_pool_type, workers_count, results_queue_size, serializer=None,
               on_error='raise', max_item_retries=None, protocol_monitor=None,
               zero_copy=False):
    """The pool of ``reader_pool_type`` (``'thread'``, ``'process'``,
    ``'dummy'`` or a :class:`ProcessPoolOptions`, the process pool with
    further arguments). Every worker publishes column blocks, so the process
    pool's serializer defaults to the raw-buffer
    :class:`NumpyBlockSerializer`; blocks arrive as writable numpy views over
    the IPC message. ``zero_copy`` (process pool, shm transport) delivers
    them as lifetime-tracked views straight into the ring slot; the thread
    and dummy pools hand over in-process arrays already, so for them it is a
    no-op. ``on_error``/``max_item_retries`` and ``protocol_monitor`` behave
    alike on every pool."""
    policy = {'on_error': ErrorPolicy.resolve(on_error, max_item_retries),
              'protocol_monitor': protocol_monitor}
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size, **policy)
    if reader_pool_type == 'process' or isinstance(reader_pool_type, ProcessPoolOptions):
        options = (reader_pool_type.kwargs if isinstance(reader_pool_type, ProcessPoolOptions)
                   else {})
        return ProcessPool(workers_count, results_queue_size,
                           serializer=serializer or NumpyBlockSerializer(),
                           zero_copy=zero_copy, **dict(options, **policy))
    if reader_pool_type == 'dummy':
        return DummyPool(**policy)
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
                transform_spec=None, ngram=None,
                output='rows', batch_size=None, drop_last=False,
                resume_state=None,
                storage_retry_policy=None, chunk_cache=None, chunk_cache_size_limit=None,
                telemetry=None, autotune=None,
                on_error='raise', max_item_retries=None, protocol_monitor=None,
                serve=None, serve_weight=1, zero_copy=False, elastic=None,
                piece_filter=None):
    """Reader for datasets written by :func:`materialize_dataset`.

    :param schema_fields: field names / regex patterns / UnischemaFields to
        read (``None`` = all)
    :param reader_pool_type: ``'thread'``, ``'process'`` (spawned worker
        processes, results over shared-memory rings; see
        :class:`~petastorm_tpu_torch.workers.ProcessPool`), ``'dummy'``
        (the consumer thread), or a
        :class:`~petastorm_tpu_torch.workers.ProcessPoolOptions`: the
        process pool with further arguments (``transport``, ``ring_bytes``,
        ``results_timeout_s``, ``blob_threshold_bytes``, ...; the JAX
        factory always takes the pool's defaults)
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
    :param ngram: an :class:`~petastorm_tpu_torch.ngram.NGram`: deliver
        windows of consecutive rows (by its timestamp field, within a row
        group) instead of rows. It replaces ``schema_fields``: the reader
        reads the fields its timesteps name. Row output yields one dict
        ``offset -> namedtuple`` per window; columnar output one nested
        block ``offset -> {field: [W, ...]}`` per row group, its windows
        assembled with no Python per row. Not with ``batch_size``, nor with
        ``timestamp_overlap=False`` and ``shuffle_row_drop_partitions > 1``
    :param output: ``'rows'`` yields one schema namedtuple per row;
        ``'columnar'`` yields one namedtuple of column arrays per row group
        (the hot path :class:`TorchDataLoader` slices batches from)
    :param batch_size: (columnar only) rebatch the blocks to exactly this
        many rows; the last batch of a pass is shorter unless ``drop_last``
    :param drop_last: (columnar with ``batch_size`` only) drop that batch;
        its rows are not delivered, so a checkpoint re-reads them
    :param resume_state: a dict from :meth:`Reader.state_dict` (of either
        package): continue from that read position. Construct the reader
        with otherwise the same arguments; ``cur_shard``/``shard_count`` may
        differ for version-2 states (see :func:`merge_resume_states`)
    :param storage_retry_policy: a
        :class:`~petastorm_tpu_torch.retry.RetryPolicy` for transient errors
        of object-store IO (``s3``, ``gs``, ``mock-remote``); ``None`` takes
        its defaults, ``False`` wraps nothing. It reaches the metadata reads,
        the workers (through a picklable filesystem factory) and the chunk
        fetches
    :param chunk_cache: REMOTE stores only: ``'auto'`` (a directory per
        dataset under the system temp directory,
        ``pstpu_torch_chunk_cache/<hash>``), a cache directory, or a
        :class:`~petastorm_tpu_torch.chunkstore.ChunkCacheConfig`. Qualifying
        column chunks are mirrored to local disk once and served by the page
        scan and the fused read as local files are, and a prefetcher thread
        fetches the ventilator's upcoming chunks ahead; later epochs read at
        local speed. The counters appear as ``chunk_cache_*`` keys in
        :attr:`Reader.diagnostics`. A local ``file://`` store ignores it.
        ``None`` disables it
    :param chunk_cache_size_limit: on-disk byte bound of the chunk cache
        (default 10 GiB); LRU eviction keeps usage under it and never
        invalidates a chunk a live batch still references
    :param telemetry: ``'off'``, ``'counters'`` (the process default: stage
        timers and counters, read by :attr:`Reader.diagnostics` and
        :func:`~petastorm_tpu_torch.observability.stall_report`), ``'spans'``
        (also one Chrome-trace event per stage execution,
        :func:`~petastorm_tpu_torch.observability.export_chrome_trace`), or a
        :class:`~petastorm_tpu_torch.observability.TelemetryConfig`; ``None``
        keeps the process's level. Applied process-wide and shipped to the
        process pool's workers
    :param autotune: ``True`` or an
        :class:`~petastorm_tpu_torch.autotune.AutotuneConfig` starts the
        feedback controller (:attr:`Reader.autotuner`): it grows and retires
        worker slots and, once a loader attaches, shrinks its shuffle buffer,
        within the config's bounds, each move a recorded decision. Off by
        default
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
    :param protocol_monitor: opt-in runtime conformance checking of the
        worker-pool supervision protocol (``docs/protocol.md``): truthy
        attaches a fresh monitor to the pool, a
        :class:`~petastorm_tpu_torch.analysis.protocol.monitor.ProtocolMonitor`
        instance is used as is, None honours the ``PSTPU_PROTOCOL_MONITOR``
        environment variable. An event sequence the protocol spec rejects
        raises :class:`~petastorm_tpu_torch.errors.ProtocolViolation` on the
        iterating thread
    :param piece_filter: ``callable(RowGroupPiece) -> bool`` applied to the
        piece list straight after it is listed, before the selector, the
        predicate and the shard: it scopes the reader to a subset of row
        groups identified by ``(path, row_group)``. Selector index sets and
        version-2 resume cursors are then expressed in the filtered
        enumeration. Not with ``serve``
    :param serve: ``'auto'`` or a service directory: read through the
        per-host shared reader daemon, spawning it when none runs
        (``python -m petastorm_tpu_torch.serve``), and return a
        :class:`~petastorm_tpu_torch.serve.ServedReader`. Consumers of the
        same dataset and decode arguments share one decode. ``'auto'`` is
        ``$PSTPU_TORCH_SERVE_DIR``, else ``$TMPDIR/pstpu-torch-serve-<uid>``;
        ``reader_pool_type`` and ``workers_count`` size a daemon this call
        spawns. Not with ``resume_state``, ``autotune`` or ``piece_filter``
    :param serve_weight: this consumer's weight in the daemon's fair share
    :param elastic: elastic pod sharding (``docs/parallelism.md``, "Elastic
        pod sharding"): ``True`` or an
        :class:`~petastorm_tpu_torch.elastic.ElasticConfig` replaces the
        static ``cur_shard``/``shard_count`` arithmetic with a lease-based
        membership registry and a generation-numbered shard map coordinated
        through a shared directory (default ``<dataset>/_elastic``). Hosts
        may join or leave mid-epoch: survivors adopt a departed host's
        unfinished row groups after its lease expires, ``O_EXCL`` commit
        markers make the commit exactly-once pod-wide (delivery is
        at-least-once only in the false-expiry window, which ``lease_s``
        bounds), and the seeded global order depends only on
        ``(seed, epoch)``. The directory is the JAX package's, so hosts of
        both packages can share it. Not with ``cur_shard``/``shard_count``,
        ``resume_state`` (the pod's commit scoreboard is the read position)
        or ``serve``
    """
    _refuse_served_elastic(serve, elastic)
    remote = {'storage_retry_policy': storage_retry_policy, 'chunk_cache': chunk_cache,
              'chunk_cache_size_limit': chunk_cache_size_limit}
    if serve:
        return _make_served(dataset_url, batch_reader=False, schema_fields=schema_fields,
                            seed=seed, shuffle_row_groups=shuffle_row_groups,
                            shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                            predicate=predicate, rowgroup_selector=rowgroup_selector,
                            num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                            cache_type=cache_type, cache_location=cache_location,
                            cache_size_limit=cache_size_limit,
                            cache_row_size_estimate=cache_row_size_estimate,
                            transform_spec=transform_spec, ngram=ngram, output=output,
                            batch_size=batch_size, drop_last=drop_last,
                            resume_state=resume_state, telemetry=telemetry, autotune=autotune,
                            piece_filter=piece_filter, serve=serve, serve_weight=serve_weight,
                            reader_pool_type=reader_pool_type, workers_count=workers_count,
                            **remote)
    if output not in ('rows', 'columnar'):
        raise ValueError("output must be 'rows' or 'columnar', got {!r}".format(output))
    if output == 'rows' and batch_size is not None:
        raise ValueError("batch_size requires output='columnar' (row output is one row "
                         'per iteration; batch with TorchDataLoader instead)')
    columnar_ngram = output == 'columnar' and ngram is not None
    if columnar_ngram:
        if batch_size is not None:
            raise ValueError('batch_size rebatching is not supported with ngram (window '
                             'blocks are nested); batch with TorchDataLoader instead')
        if drop_last:
            raise ValueError('drop_last requires batch_size (without rebatching there is '
                             'no "last short batch" to drop)')
        def results_reader(out_schema):
            return NgramBlockResultsQueueReader(out_schema, ngram)
    else:
        def rows_reader(out_schema):
            return RowResultsQueueReader(out_schema, ngram)

        results_reader = _columnar_results_reader_factory(output, batch_size, drop_last,
                                                          rows_reader)
    # the pool is built, not started, before any IO: a bad policy or pool
    # type fails first
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, on_error=on_error,
                      max_item_retries=max_item_retries, protocol_monitor=protocol_monitor,
                      zero_copy=zero_copy)
    try:
        schema = dataset_metadata.get_schema(dataset_url, retry_policy=storage_retry_policy)
    except dataset_metadata.PetastormMetadataError:
        raise PetastormTpuError(
            'Dataset at {} is missing unischema metadata. If it is a plain Parquet store, '
            'use make_batch_reader instead.'.format(dataset_url))
    cache = _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate)
    return Reader(dataset_url, schema, pool, results_reader, schema_fields=schema_fields,
                  seed=seed, shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, cache=cache,
                  transform_spec=transform_spec, resume_state=resume_state,
                  telemetry=telemetry, autotune=autotune, piece_filter=piece_filter,
                  ngram=ngram, columnar_ngram=columnar_ngram, elastic=elastic, **remote)


def make_batch_reader(dataset_url,
                      schema_fields=None,
                      reader_pool_type='thread', workers_count=10, results_queue_size=50,
                      seed=None,
                      shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                      predicate=None,
                      num_epochs=1,
                      cur_shard=None, shard_count=None,
                      cache_type='null', cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None,
                      transform_spec=None,
                      batch_size=None, drop_last=False,
                      resume_state=None,
                      storage_retry_policy=None, chunk_cache=None, chunk_cache_size_limit=None,
                      telemetry=None, autotune=None,
                      on_error='raise', max_item_retries=None, protocol_monitor=None,
                      serve=None, serve_weight=1, zero_copy=False, elastic=None,
                      piece_filter=None):
    """Columnar reader for ANY Parquet store: one namedtuple of numpy column
    arrays per row group, or per ``batch_size`` rows with ``batch_size``
    (the last batch of a pass shorter unless ``drop_last``). The columns are
    raw, with no codec decode: a binary column (an encoded image) comes out
    as an object array of bytes, for a batched ``TransformSpec`` to decode.
    The schema is the stored Unischema when the store has one, else it is
    inferred from the Arrow schema (:func:`~petastorm_tpu_torch.etl.
    dataset_metadata.infer_or_load_unischema`). The other arguments are
    :func:`make_reader`'s, ``protocol_monitor``, ``serve``, ``serve_weight``,
    ``elastic`` and the remote-store ones (``storage_retry_policy``,
    ``chunk_cache``, ``chunk_cache_size_limit``) included;
    ``TransformSpec.func`` gets the column dict."""
    _refuse_served_elastic(serve, elastic)
    remote = {'storage_retry_policy': storage_retry_policy, 'chunk_cache': chunk_cache,
              'chunk_cache_size_limit': chunk_cache_size_limit}
    if serve:
        return _make_served(dataset_url, batch_reader=True, schema_fields=schema_fields,
                            seed=seed, shuffle_row_groups=shuffle_row_groups,
                            shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                            predicate=predicate, rowgroup_selector=None, num_epochs=num_epochs,
                            cur_shard=cur_shard, shard_count=shard_count, cache_type=cache_type,
                            cache_location=cache_location, cache_size_limit=cache_size_limit,
                            cache_row_size_estimate=cache_row_size_estimate,
                            transform_spec=transform_spec, ngram=None, output='columnar',
                            batch_size=batch_size, drop_last=drop_last,
                            resume_state=resume_state, telemetry=telemetry, autotune=autotune,
                            piece_filter=piece_filter, serve=serve, serve_weight=serve_weight,
                            reader_pool_type=reader_pool_type, workers_count=workers_count,
                            **remote)
    results_reader = _columnar_results_reader_factory('columnar', batch_size, drop_last, None)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, on_error=on_error,
                      max_item_retries=max_item_retries, protocol_monitor=protocol_monitor,
                      zero_copy=zero_copy)
    schema = dataset_metadata.infer_or_load_unischema(dataset_url,
                                                      retry_policy=storage_retry_policy)
    cache = _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate)
    return Reader(dataset_url, schema, pool, results_reader, schema_fields=schema_fields,
                  seed=seed, shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache, transform_spec=transform_spec, resume_state=resume_state,
                  worker_class=ArrowBatchWorker, telemetry=telemetry, autotune=autotune,
                  piece_filter=piece_filter, elastic=elastic, **remote)


def _refuse_served_elastic(serve, elastic):
    if serve and elastic:
        raise ValueError('elastic is not supported with serve=: the shared daemon owns one '
                         'static stream plan (docs/serve.md)')


def _make_served(dataset_url, batch_reader, schema_fields, seed, shuffle_row_groups,
                 shuffle_row_drop_partitions, predicate, rowgroup_selector, num_epochs,
                 cur_shard, shard_count, cache_type, cache_location, cache_size_limit,
                 cache_row_size_estimate, transform_spec, ngram, output, batch_size, drop_last,
                 resume_state, telemetry, autotune, piece_filter, serve, serve_weight,
                 reader_pool_type, workers_count, storage_retry_policy, chunk_cache,
                 chunk_cache_size_limit):
    """The ``serve=`` path of the factories: check the combination, build
    the canonical stream spec (the JAX package's keys) and attach through
    the shared daemon. The consumer's results readers are the private
    path's, which is what makes the served reader a drop-in."""
    if piece_filter is not None:
        raise ValueError('piece_filter is not supported with serve=: the shared daemon owns '
                         'one static stream plan')
    if isinstance(reader_pool_type, ProcessPoolOptions):
        raise ValueError('ProcessPoolOptions is not supported with serve=: the daemon sizes '
                         "its own pool; pass reader_pool_type='process'")
    if resume_state is not None:
        raise ValueError('resume_state is not supported with serve=: the read position '
                         'belongs to the shared stream')
    if autotune:
        raise ValueError('autotune is not supported with serve=: the daemon owns the shared '
                         'worker fleet')
    obs.configure(telemetry)
    if output not in ('rows', 'columnar'):
        raise ValueError("output must be 'rows' or 'columnar', got {!r}".format(output))
    if output == 'rows' and batch_size is not None:
        raise ValueError("batch_size requires output='columnar'")
    columnar_ngram = output == 'columnar' and ngram is not None
    if columnar_ngram:
        if batch_size is not None:
            raise ValueError('batch_size rebatching is not supported with ngram')

        def results_reader(out_schema):
            return NgramBlockResultsQueueReader(out_schema, ngram)
    elif batch_reader:
        results_reader = _columnar_results_reader_factory('columnar', batch_size, drop_last,
                                                          None)
    else:
        def rows_reader(out_schema):
            return RowResultsQueueReader(out_schema, ngram)

        results_reader = _columnar_results_reader_factory(output, batch_size, drop_last,
                                                          rows_reader)
    cache = _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate)
    spec = {
        'dataset_url': dataset_url,
        'batch_reader': batch_reader,
        'schema_fields': schema_fields,
        'seed': seed,
        'shuffle_row_groups': shuffle_row_groups,
        'shuffle_row_drop_partitions': shuffle_row_drop_partitions,
        'predicate': predicate,
        'rowgroup_selector': rowgroup_selector,
        'num_epochs': num_epochs,
        'cur_shard': cur_shard,
        'shard_count': shard_count,
        'transform_spec': transform_spec,
        'ngram': ngram,
        'columnar_ngram': columnar_ngram,
        'storage_retry_policy': storage_retry_policy,
        'chunk_cache': chunk_cache,
        'chunk_cache_size_limit': chunk_cache_size_limit,
        'cache': cache,
    }
    from petastorm_tpu_torch.serve.client import make_served_reader
    return make_served_reader(spec, serve, results_reader, weight=serve_weight,
                              spawn_args={'pool_type': reader_pool_type,
                                          'workers_count': workers_count})


class Reader(object):
    """Orchestrates piece listing, sharding, the ventilator and the pool."""

    #: the feedback controller when ``autotune`` is on
    autotuner = None

    def __init__(self, dataset_url, schema, pool, results_reader_factory, schema_fields=None,
                 seed=None, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                 predicate=None, rowgroup_selector=None, num_epochs=1, cur_shard=None,
                 shard_count=None, cache=NullCache(), transform_spec=None, resume_state=None,
                 worker_class=RowGroupDecoderWorker, telemetry=None, autotune=None,
                 piece_filter=None, ngram=None, columnar_ngram=False, elastic=None,
                 storage_retry_policy=None, chunk_cache=None, chunk_cache_size_limit=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range for shard_count {}'.format(
                cur_shard, shard_count))
        if shuffle_row_drop_partitions < 1:
            raise ValueError('shuffle_row_drop_partitions must be >= 1')
        if elastic:
            if cur_shard is not None or shard_count is not None:
                raise ValueError(
                    'elastic replaces static sharding: every host opens the FULL piece list '
                    'and the generation shard map partitions it — pass neither cur_shard nor '
                    'shard_count (docs/parallelism.md)')
            if resume_state is not None:
                raise ValueError(
                    'resume_state is not supported with elastic=: the pod-wide commit '
                    'scoreboard in the coordination directory IS the read position — '
                    'restarted hosts rejoin and skip committed groups')
        if ngram is not None and not ngram.timestamp_overlap and shuffle_row_drop_partitions > 1:
            raise NotImplementedError(
                'shuffle_row_drop_partitions > 1 with timestamp_overlap=False would duplicate '
                'rows across partition-boundary windows (reference reader.py:372 refuses too)')
        # the requested level, process-wide (None keeps it); the effective
        # config rides the workers' setup args into spawned processes
        self._telemetry_config = obs.configure(telemetry)
        self._dataset_url = dataset_url
        #: the full stored (or inferred) schema
        self.schema = schema
        #: the decoded-block cache (``stats()`` counts its hits and misses)
        self.cache = cache
        resolver = FilesystemResolver(dataset_url, retry_policy=storage_retry_policy)
        #: the :class:`~petastorm_tpu_torch.chunkstore.ChunkCacheConfig` of a
        #: remote store read with ``chunk_cache``, else None
        self.chunk_cache_config = resolve_chunk_cache(chunk_cache, dataset_url,
                                                      resolver.is_local,
                                                      size_limit_bytes=chunk_cache_size_limit)
        if ngram is not None:
            # the NGram names the fields it reads: schema_fields is not used
            ngram.resolve_regex_field_names(schema)
            needed = [n for n in ngram.get_field_names_at_all_timesteps() if n in schema.fields]
            output_schema = schema.create_schema_view([schema.fields[n] for n in needed])
        elif schema_fields is not None:
            output_schema = schema.create_schema_view(schema_fields)
        else:
            output_schema = schema
        self.output_schema = output_schema
        #: the :class:`~petastorm_tpu_torch.ngram.NGram` of a windowed read
        #: (the loader reads it), else None
        self.ngram = ngram
        self.transform_spec = transform_spec
        self.transformed_schema = (transform_schema(output_schema, transform_spec)
                                   if transform_spec is not None else output_schema)

        # piece filter -> selector (its index sets refer to the enumeration
        # before the predicate, so it runs next) -> predicate -> shard
        pieces = dataset_metadata.load_row_groups(dataset_url, schema=schema,
                                                  retry_policy=storage_retry_policy)
        if piece_filter is not None:
            pieces = [p for p in pieces if piece_filter(p)]
        if rowgroup_selector is not None:
            pieces = self._apply_rowgroup_selector(dataset_url, pieces, rowgroup_selector,
                                                   storage_retry_policy)
        pieces, worker_predicate = self._apply_predicate_to_pieces(pieces, predicate)
        # the enumeration before sharding is the same on every host, so a
        # version-2 state's cursor in these global piece indices resumes on
        # any shard count (state_dict, merge_resume_states)
        self._num_global_pieces = len(pieces)
        self._global_piece_indices = (list(range(len(pieces))) if cur_shard is None else
                                      list(range(cur_shard, len(pieces), shard_count)))
        pieces = [pieces[i] for i in self._global_piece_indices]
        if not pieces:
            raise NoDataAvailableError(
                'No row groups selected for reading (dataset={}, shard {}/{}). Check predicate/'
                'selector, or reduce shard_count.'.format(dataset_url, cur_shard, shard_count))
        if worker_predicate is not None and isinstance(pool, ProcessPool):
            _check_picklable(worker_predicate)
        self._pieces = pieces
        self._cur_shard = cur_shard
        self._shard_count = shard_count
        self._shuffle_row_drop_partitions = shuffle_row_drop_partitions
        items = build_work_items(len(pieces), shuffle_row_drop_partitions, worker_predicate)
        self._num_items = len(items)
        ventilator_resume = (None if resume_state is None else
                             self._resolve_resume_state(resume_state, dataset_url))
        self._elastic_coordinator = None
        if elastic:
            # imports stay inside the branch: a plain reader does not load
            # the elastic package
            from petastorm_tpu_torch.elastic import resolve_elastic
            from petastorm_tpu_torch.elastic.coordinator import (ElasticCoordinator,
                                                                 ElasticVentilator)
            self._elastic_coordinator = ElasticCoordinator(
                resolve_elastic(elastic, dataset_path=resolver.get_dataset_path()),
                num_items=len(items), seed=seed, shuffle=shuffle_row_groups)
            self._ventilator = ElasticVentilator(
                pool.ventilate, items, self._elastic_coordinator, iterations=num_epochs,
                max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS)
        else:
            self._ventilator = ConcurrentVentilator(
                pool.ventilate, items, iterations=num_epochs,
                max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS,
                randomize_item_order=shuffle_row_groups, random_seed=seed, tag_items=True,
                resume_state=ventilator_resume)
        self._results_reader = results_reader_factory(self.transformed_schema)
        # checkpoint wiring, before the pool starts (items may flow at once):
        # the results reader marks an item delivered when its last row is
        # yielded; the pool's completions cover items that published nothing
        self._results_reader.delivered_callback = self._ventilator.mark_delivered
        pool.done_callback = self._results_reader.on_item_done
        # the items a resumed reader's first pass replays (a loader resume
        # skips the rows it already holds of one of them)
        self._replayed_items = set(ventilator_resume['replay_indices']
                                   if ventilator_resume is not None else ())
        if hasattr(self._results_reader, 'partly_yielded'):
            self._results_reader.item_of_seq = getattr(self._ventilator, 'item_of_seq', None)
        self._pool = pool
        self.last_row_consumed = False
        self._stopped = False
        # the chunk prefetcher walks the ventilator's exact upcoming order
        # and mirrors remote chunks before the workers ask for them: the
        # output columns, and the predicate's, which a filtered read reads
        # first
        self._chunk_prefetcher = None
        if self.chunk_cache_config is not None:
            from petastorm_tpu_torch.chunkstore.prefetch import ChunkPrefetcher
            prefetch_cols = list(output_schema.fields)
            if worker_predicate is not None:
                prefetch_cols += [f for f in sorted(worker_predicate.get_fields())
                                  if f not in prefetch_cols]
            self._chunk_prefetcher = ChunkPrefetcher(
                self._ventilator, pieces, prefetch_cols, resolver.filesystem_factory(),
                self.chunk_cache_config)
            self._chunk_prefetcher.start()
        try:
            pool.start(worker_class,
                       {'filesystem_factory': resolver.filesystem_factory(),
                        'dataset_path': resolver.get_dataset_path(),
                        'cache': self.cache,
                        'chunk_cache': self.chunk_cache_config,
                        'pieces': pieces,
                        'schema': schema,
                        'output_schema': output_schema,
                        'transform_spec': transform_spec,
                        'transformed_schema': self.transformed_schema,
                        'ngram': ngram,
                        'columnar_ngram': columnar_ngram,
                        'telemetry': self._telemetry_config},
                       ventilator=self._ventilator)
        except BaseException:
            if self._chunk_prefetcher is not None:
                self._chunk_prefetcher.stop()
                self._chunk_prefetcher.join()
            raise
        # the autotuner starts after the pool, so its first window sees a
        # running pipeline; with a chunk cache it also steers the
        # prefetcher's in-flight byte budget
        self.autotuner = None
        from petastorm_tpu_torch.autotune import Autotuner, resolve_autotune
        autotune_config = resolve_autotune(autotune)
        if autotune_config is not None:
            self.autotuner = Autotuner(autotune_config, pool=pool,
                                       chunk_cache=self.chunk_cache_config,
                                       ventilator=self._ventilator,
                                       diagnostics_fn=lambda: self.diagnostics)
            self.autotuner.start()

    @staticmethod
    def _apply_predicate_to_pieces(pieces, predicate):
        """Piece-level pushdown: when every predicate field is a partition
        key, whole pieces are dropped with no I/O and no worker predicate is
        left; otherwise the workers filter the rows."""
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
    def _apply_rowgroup_selector(dataset_url, pieces, selector, retry_policy=None):
        """Filter pieces through the stored row-group indexes. Their index
        sets refer to the unfiltered piece enumeration, so this runs before
        any other filter."""
        indexes = get_row_group_indexes(dataset_url, retry_policy=retry_policy)
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
            self.last_row_consumed = True
            raise StopIteration

    # -- checkpoint / resume ------------------------------------------------

    def _resolve_resume_state(self, state, dataset_url):
        """Validate ``resume_state`` and return the ventilator's part of it.

        A state taken over the same pieces and items on the same shard (v2
        states record it; v1 states predate the field and are trusted)
        resumes exactly: replay order and RNG state. A v2 state over the
        same global pieces with other shard arithmetic resumes portably: its
        global cursor is mapped onto this shard's items, and the remaining
        epochs reshuffle from this reader's seed. Anything else is refused."""
        if not isinstance(state, dict) or state.get('version') not in (1, 2):
            raise ValueError('Unrecognized resume_state (expected a dict produced by '
                             'Reader.state_dict())')
        if state.get('dataset_url') not in (None, dataset_url):
            warnings.warn('resume_state was taken from {} but this reader opens {}; resuming '
                          'anyway since piece counts match (dataset may have moved)'.format(
                              state.get('dataset_url'), dataset_url))
        ckpt_shard = state.get('shard')
        shard_matches = (ckpt_shard is None
                         or list(ckpt_shard) == [self._cur_shard, self._shard_count])
        if (state.get('num_pieces') == len(self._pieces)
                and state.get('num_items') == self._num_items and shard_matches):
            return state['ventilator']
        sdp = self._shuffle_row_drop_partitions
        if (state.get('version') == 2
                and state.get('num_global_pieces') == self._num_global_pieces
                and state.get('shuffle_row_drop_partitions') == sdp):
            local_of = {g: lp for lp, g in enumerate(self._global_piece_indices)}
            replay = sorted(local_of[g] * sdp + part
                            for g, part in state.get('remaining_global_parts', ())
                            if g in local_of)
            return {'replay_indices': replay,
                    'iterations_remaining': state.get('iterations_remaining'),
                    'rng_state': None}
        if not shard_matches:
            raise ValueError(
                'resume_state was taken on shard {}/{} but this reader is shard {}/{}, and '
                'the state carries no matching portable cursor to remap — an exact resume '
                'would replay the other shard\'s positions. Restore each state onto its own '
                'shard, or merge all hosts\' states with merge_resume_states.'.format(
                    ckpt_shard[0], ckpt_shard[1], self._cur_shard, self._shard_count))
        raise ValueError(
            'resume_state does not match this reader: it was taken over {} pieces / {} work '
            'items ({} dataset-wide), but this reader selected {} / {} ({} dataset-wide). '
            'Construct the resumed reader with the same arguments (dataset, predicate, '
            'selector, shuffle_row_drop_partitions) as the checkpointed one; only the '
            'cur_shard/shard_count split may differ for v2 states.'.format(
                state.get('num_pieces'), state.get('num_items'),
                state.get('num_global_pieces'), len(self._pieces), self._num_items,
                self._num_global_pieces))

    def state_dict(self):
        """The read position as a picklable dict (version 2, the JAX
        package's layout): pass it as ``resume_state=`` to a reader built
        with otherwise the same arguments to continue from here.

        Row groups whose rows were all yielded are never read again; row
        groups in flight, a partly yielded one included, are read again
        whole. At an epoch boundary the resume is exact, and the remaining
        epochs reshuffle from the saved RNG state. The cursor is also kept in
        global piece indices (``remaining_global_parts``), so the states of
        N shards, merged with :func:`merge_resume_states`, resume on M."""
        vent = self._ventilator.state_dict()
        sdp = self._shuffle_row_drop_partitions
        remaining = sorted({(int(self._global_piece_indices[i // sdp]), int(i % sdp))
                            for i in vent['replay_indices']})
        return {
            'version': 2,
            'dataset_url': self._dataset_url,
            'num_pieces': len(self._pieces),
            'num_items': self._num_items,
            'ventilator': vent,
            'num_global_pieces': self._num_global_pieces,
            'shard': [self._cur_shard, self._shard_count],
            'shuffle_row_drop_partitions': sdp,
            'remaining_global_parts': [list(cell) for cell in remaining],
            'iterations_remaining': vent['iterations_remaining'],
        }

    def yielded_rows(self):
        """``[[global piece, part, rows]]`` for the row group a row reader
        has partly yielded (its block is being sliced), else ``[]``. A
        reader resumed from :meth:`state_dict` reads that row group again
        whole; a loader that already holds those rows saves this beside the
        state and hands it to :meth:`skip_yielded_rows`."""
        partly = getattr(self._results_reader, 'partly_yielded', lambda: None)()
        item_of_seq = getattr(self._ventilator, 'item_of_seq', None)
        index = None if partly is None or item_of_seq is None else item_of_seq(partly[0])
        if index is None:
            return []
        sdp = self._shuffle_row_drop_partitions
        return [[int(self._global_piece_indices[index // sdp]), int(index % sdp), int(partly[1])]]

    def skip_yielded_rows(self, cells):
        """Start the replayed row groups ``cells`` (:meth:`yielded_rows`
        of the checkpointed reader) past the rows yielded before the
        checkpoint, so a loader resume delivers each row once. Only row
        groups this resumed reader replays count; call it before reading."""
        if not hasattr(self._results_reader, 'skip_rows'):
            return
        sdp = self._shuffle_row_drop_partitions
        local_of = {g: lp for lp, g in enumerate(self._global_piece_indices)}
        skips = {}
        for piece, part, rows in cells:
            if piece in local_of and local_of[piece] * sdp + part in self._replayed_items:
                skips[local_of[piece] * sdp + part] = rows
        self._results_reader.skip_rows(skips)

    def reset(self):
        """Read the dataset again for another ``num_epochs``. Only valid
        after the previous pass was read to its end."""
        if not self.last_row_consumed:
            raise PetastormTpuError(
                'reset() called mid-epoch. Consume all rows (or use num_epochs=None) '
                'before resetting.')
        self._ventilator.reset()
        self.last_row_consumed = False

    @property
    def last_trace(self):
        """The virtual-root :class:`~petastorm_tpu_torch.observability.TraceContext`
        of the item the last returned block came from; None below the
        ``'spans'`` level or before the first read. The loader's collate and
        the infeed link their spans to it."""
        return getattr(self._pool, 'last_result_trace', None)

    @property
    def diagnostics(self):
        """The metrics registry of this process merged with the process
        pool's workers' snapshots (stage timers ``stage_*_s``/``_count``,
        counters, gauges), then the pool's diagnostics: items ventilated,
        completed and in flight, the recovery counters (``worker_restarts``,
        ``items_requeued``, ``items_quarantined``), the ``lifetime_*``
        borrow counters and, for a process pool, its transport and
        publishes per channel; with a chunk cache, its ``chunk_cache_*``
        counters, merged over every process that shares its root."""
        snapshots = [obs.snapshot()] + list(self._pool.telemetry_snapshots())
        diag = obs.flatten_snapshot(obs.merge_snapshots(snapshots))
        diag.update(self._pool.diagnostics)
        if self.chunk_cache_config is not None:
            from petastorm_tpu_torch.chunkstore import cache_diagnostics
            diag.update(cache_diagnostics(self.chunk_cache_config))
        return diag

    @property
    def elastic_coordinator(self):
        """The :class:`~petastorm_tpu_torch.elastic.coordinator.ElasticCoordinator`
        when this reader runs elastically, else None. Its ``status()`` dict
        gives the host, generation, members and the alive set."""
        return self._elastic_coordinator

    @property
    def quarantined_items(self):
        """Records of the row groups quarantined under ``on_error='skip'``."""
        return self._pool.quarantined_items

    def stop(self):
        if self.autotuner is not None:
            self.autotuner.stop()
        if self._chunk_prefetcher is not None:
            self._chunk_prefetcher.stop()
        self._pool.stop()
        self._stopped = True

    def join(self):
        if self._chunk_prefetcher is not None:
            self._chunk_prefetcher.join()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if not self._stopped:
            self.stop()
            self.join()


def merge_resume_states(states):
    """One portable ``resume_state`` from the states of every shard of a run.

    Take :meth:`Reader.state_dict` on every host, merge them here, and pass
    the result as ``resume_state=`` to readers of ANY shard count (1
    included): it holds the run's unfinished row groups in global piece
    indices, and each restoring shard replays exactly the ones that land on
    it. The states must come from readers over the same dataset-wide
    selection (dataset, predicate, selector, ``shuffle_row_drop_partitions``),
    and every host's must be given: a missing host's unfinished row groups
    count as read. The shuffle RNG does not carry over to another item list,
    so the remaining epochs reshuffle from the restoring readers' seed."""
    states = list(states)
    if not states:
        raise ValueError('merge_resume_states needs at least one state')
    base = None
    cells = set()
    iterations = ()
    for state in states:
        if not isinstance(state, dict) or state.get('version') != 2:
            raise ValueError('merge_resume_states needs version-2 dicts from '
                             'Reader.state_dict(); got {!r}'.format(
                                 state.get('version') if isinstance(state, dict)
                                 else type(state).__name__))
        if base is None:
            base = state
        if (state.get('num_global_pieces') != base.get('num_global_pieces')
                or state.get('shuffle_row_drop_partitions')
                != base.get('shuffle_row_drop_partitions')):
            raise ValueError(
                'resume states disagree on the dataset-wide selection '
                '({} pieces x {} drop parts vs {} x {}): they were not taken '
                'over the same dataset/predicate/selector'.format(
                    base.get('num_global_pieces'), base.get('shuffle_row_drop_partitions'),
                    state.get('num_global_pieces'), state.get('shuffle_row_drop_partitions')))
        cells.update((int(g), int(part)) for g, part in state.get('remaining_global_parts', ()))
        iterations += (state.get('iterations_remaining'),)
    finite = [it for it in iterations if it is not None]
    return {
        'version': 2,
        'dataset_url': base.get('dataset_url'),
        # None: a merged state never takes the exact path, it always maps
        # through the global cursor
        'num_pieces': None,
        'num_items': None,
        'ventilator': None,
        'num_global_pieces': base.get('num_global_pieces'),
        'shard': None,
        'shuffle_row_drop_partitions': base.get('shuffle_row_drop_partitions'),
        'remaining_global_parts': [list(cell) for cell in sorted(cells)],
        'iterations_remaining': None if len(finite) < len(iterations) else min(finite),
    }
