"""Read plans: what a reader pipeline needs that does not depend on the
process that runs it.

Twin of ``petastorm_tpu/serve/plan.py``. A plan holds the resolved schemas,
the filtered piece list, the ventilation items and the worker setup
arguments of one *stream* (a dataset and a decode configuration). The serve
daemon builds one per stream and runs many of them over one worker fleet,
so the construction is a function of data, not of a reader object. The
filters and :func:`build_work_items` are the reader's own
(:mod:`petastorm_tpu_torch.reader`).

Not ported yet: the chunk cache of remote stores (``chunk_cache``) and the
storage retry policy; both are refused here as they are by the reader
factories.
"""

from __future__ import annotations

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.reader import Reader, build_work_items
from petastorm_tpu_torch.transform import transform_schema


class ReadPlan(object):
    """One stream's decode configuration, resolved and ready to run.

    ``worker_args`` is the picklable setup dict of
    :class:`~petastorm_tpu_torch.row_worker.RowGroupDecoderWorker` or
    :class:`~petastorm_tpu_torch.batch_worker.ArrowBatchWorker`; ``items`` the
    ventilation list (kwargs dicts). :meth:`client_plan` is the part a
    consumer needs to assemble results on its side of the fan-out ring."""

    __slots__ = ('worker_class', 'worker_args', 'items', 'pieces', 'schema',
                 'output_schema', 'transformed_schema', 'ngram',
                 'columnar_ngram', 'num_epochs', 'shuffle_row_groups', 'seed')

    def client_plan(self):
        """The picklable consumer-side slice of this plan (schemas and
        readout shape), shipped in the daemon's attach reply."""
        return {
            'schema': self.schema,
            'output_schema': self.output_schema,
            'transformed_schema': self.transformed_schema,
            'ngram': self.ngram,
            'columnar_ngram': self.columnar_ngram,
            'num_epochs': self.num_epochs,
        }


def build_read_plan(dataset_url,
                    batch_reader=False,
                    schema_fields=None,
                    seed=None,
                    shuffle_row_groups=True,
                    shuffle_row_drop_partitions=1,
                    predicate=None,
                    rowgroup_selector=None,
                    num_epochs=1,
                    cur_shard=None, shard_count=None,
                    transform_spec=None,
                    ngram=None,
                    columnar_ngram=False,
                    storage_retry_policy=None,
                    chunk_cache=None, chunk_cache_size_limit=None,
                    cache=None):
    """Resolve the schemas, list and filter the pieces and assemble the
    worker arguments of one stream. Raises what
    :func:`~petastorm_tpu_torch.make_reader` raises for the same arguments
    (missing metadata, an empty selection, a bad shard)."""
    for name, value in (('storage_retry_policy', storage_retry_policy),
                        ('chunk_cache', chunk_cache),
                        ('chunk_cache_size_limit', chunk_cache_size_limit)):
        if value is not None:
            raise NotImplementedError(
                'serve stream with {}=... is not yet ported to petastorm_tpu_torch '
                '(ROADMAP.md, "remote filesystems")'.format(name))
    if (cur_shard is None) != (shard_count is None):
        raise ValueError('cur_shard and shard_count must be specified together')
    if cur_shard is not None and not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard {} out of range for shard_count {}'.format(
            cur_shard, shard_count))
    if shuffle_row_drop_partitions < 1:
        raise ValueError('shuffle_row_drop_partitions must be >= 1')

    if batch_reader:
        from petastorm_tpu_torch.batch_worker import ArrowBatchWorker as worker_class
        schema = dataset_metadata.infer_or_load_unischema(dataset_url)
    else:
        from petastorm_tpu_torch.row_worker import RowGroupDecoderWorker as worker_class
        try:
            schema = dataset_metadata.get_schema(dataset_url)
        except dataset_metadata.PetastormMetadataError:
            raise PetastormTpuError(
                'Dataset at {} is missing unischema metadata. If it is a plain Parquet '
                'store, use make_batch_reader instead.'.format(dataset_url))
    resolver = FilesystemResolver(dataset_url)

    if ngram is not None:
        ngram.resolve_regex_field_names(schema)
        needed = [n for n in ngram.get_field_names_at_all_timesteps() if n in schema.fields]
        output_schema = schema.create_schema_view([schema.fields[n] for n in needed])
    elif schema_fields is not None:
        output_schema = schema.create_schema_view(schema_fields)
    else:
        output_schema = schema
    transformed_schema = (transform_schema(output_schema, transform_spec)
                          if transform_spec is not None else output_schema)
    if ngram is not None and not ngram.timestamp_overlap and shuffle_row_drop_partitions > 1:
        raise NotImplementedError(
            'shuffle_row_drop_partitions > 1 with timestamp_overlap=False would duplicate '
            'rows across partition-boundary windows')

    pieces = dataset_metadata.load_row_groups(dataset_url)
    if rowgroup_selector is not None:
        pieces = Reader._apply_rowgroup_selector(dataset_url, pieces, rowgroup_selector)
    pieces, worker_predicate = Reader._apply_predicate_to_pieces(pieces, predicate)
    if cur_shard is not None:
        pieces = pieces[cur_shard::shard_count]
    if not pieces:
        raise NoDataAvailableError(
            'No row groups selected for reading (dataset={}, shard {}/{}). Check predicate/'
            'selector, or reduce shard_count.'.format(dataset_url, cur_shard, shard_count))

    plan = ReadPlan()
    plan.worker_class = worker_class
    plan.items = build_work_items(len(pieces), shuffle_row_drop_partitions, worker_predicate)
    plan.pieces = pieces
    plan.schema = schema
    plan.output_schema = output_schema
    plan.transformed_schema = transformed_schema
    plan.ngram = ngram
    plan.columnar_ngram = columnar_ngram
    plan.num_epochs = num_epochs
    plan.shuffle_row_groups = shuffle_row_groups
    plan.seed = seed
    plan.worker_args = {
        'filesystem': resolver.filesystem(),
        'dataset_path': resolver.get_dataset_path(),
        'pieces': pieces,
        'schema': schema,
        'output_schema': output_schema,
        'transform_spec': transform_spec,
        'transformed_schema': transformed_schema,
        'ngram': ngram,
        'columnar_ngram': columnar_ngram,
        'cache': cache or NullCache(),
    }
    return plan


__all__ = ['ReadPlan', 'build_read_plan', 'build_work_items']
