"""PySpark ingestion helpers: twin of ``petastorm_tpu/spark_utils.py``.

pyspark is optional: :func:`dataset_as_rdd` never imports it. It uses the
session it is handed through ``sparkContext.defaultParallelism`` and
``parallelize`` only (so a stand-in session works, and the shard arithmetic
is testable without pyspark), and raises TypeError for anything without a
``sparkContext``. :func:`dataset_as_dataframe` reads a store into a pandas
DataFrame, with no Spark.
"""

from __future__ import annotations


def dataset_as_rdd(dataset_url, spark_session, schema_fields=None):
    """Store -> RDD of decoded row namedtuples.

    Each Spark partition opens its own reader over one shard of the store
    (the reader's ``cur_shard`` arithmetic); a partition beyond the store's
    row groups comes back empty.
    """
    sc = getattr(spark_session, 'sparkContext', None)
    if sc is None:
        raise TypeError(
            'dataset_as_rdd needs a SparkSession-like object with a sparkContext '
            '(got {!r}). If pyspark is not installed, use dataset_as_dataframe '
            '(pandas) or make_reader directly.'.format(type(spark_session).__name__))

    from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url

    schema = get_schema_from_dataset_url(dataset_url)
    fields = schema_fields if schema_fields is not None else list(schema.fields)
    num_partitions = sc.defaultParallelism

    def _read_shard(shard_index):
        from petastorm_tpu_torch import make_reader
        from petastorm_tpu_torch.errors import NoDataAvailableError
        try:
            with make_reader(dataset_url, schema_fields=fields, reader_pool_type='dummy',
                             cur_shard=shard_index, shard_count=num_partitions,
                             num_epochs=1) as reader:
                return list(reader)
        except NoDataAvailableError as e:
            # more Spark partitions than row groups: an empty partition is
            # normal here; the reader's own no-data error stays for direct
            # users
            import logging
            logging.getLogger(__name__).warning(
                'Empty shard %d/%d for %s: %s', shard_index, num_partitions, dataset_url, e)
            return []

    return sc.parallelize(range(num_partitions), num_partitions).flatMap(_read_shard)


def dataset_as_dataframe(dataset_url, schema_fields=None):
    """Store -> pandas DataFrame of decoded rows: the Spark-free analog of
    :func:`dataset_as_rdd`."""
    import pandas as pd

    from petastorm_tpu_torch import make_reader

    with make_reader(dataset_url, schema_fields=schema_fields, num_epochs=1) as reader:
        rows = [row._asdict() for row in reader]
    return pd.DataFrame(rows)
