"""Copy a dataset, optionally a subset of its columns and of its rows.

Twin of ``petastorm_tpu/tools/copy_dataset.py`` (the reference's
``petastorm-copy-dataset``, without Spark): the rows stream through a
thread-pool reader, in the store's order, into a new store's writer. The
copy of a store written by the original petastorm library is a native store
(JSON schema): the migration path off it.

Run as ``python -m petastorm_tpu_torch.tools.copy_dataset SOURCE_URL
TARGET_URL [--field-regex RE ...] [--not-null-fields F ...]
[--rows-per-row-group N] [--row-group-size-mb MB] [--rows-per-file N]
[-w WORKERS]``.
"""

from __future__ import annotations

import argparse
import sys

from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema


def copy_dataset(source_url, target_url, field_regex=None, not_null_fields=None,
                 rows_per_row_group=None, row_group_size_mb=None, rows_per_file=None,
                 workers_count=5):
    """Copy ``source_url`` to ``target_url``; returns the rows copied.

    :param field_regex: regexes selecting the columns to copy (None: all)
    :param not_null_fields: a row where any of these fields is null is
        left out
    :param rows_per_row_group, row_group_size_mb, rows_per_file: the copy's
        layout (:class:`~petastorm_tpu_torch.etl.DatasetWriter`)
    """
    predicate = None
    if not_null_fields:
        predicate = in_lambda(list(not_null_fields),
                              lambda v: all(v[f] is not None for f in not_null_fields))
    with make_reader(source_url, schema_fields=field_regex, predicate=predicate,
                     reader_pool_type='thread', workers_count=workers_count,
                     shuffle_row_groups=False) as reader:
        out_schema = Unischema('CopiedSchema', list(reader.transformed_schema.fields.values()))
        count = 0
        with materialize_dataset(target_url, out_schema, rows_per_row_group=rows_per_row_group,
                                 row_group_size_mb=row_group_size_mb,
                                 rows_per_file=rows_per_file) as writer:
            for row in reader:
                writer.write(row._asdict())
                count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description='Copy a petastorm_tpu / petastorm_tpu_torch '
                                     'dataset, or a subset of it.')
    parser.add_argument('source_url')
    parser.add_argument('target_url')
    parser.add_argument('--field-regex', nargs='+', default=None)
    parser.add_argument('--not-null-fields', nargs='+', default=None)
    parser.add_argument('--rows-per-row-group', type=int, default=None)
    parser.add_argument('--row-group-size-mb', type=int, default=None)
    parser.add_argument('--rows-per-file', type=int, default=None)
    parser.add_argument('-w', '--workers-count', type=int, default=5)
    args = parser.parse_args(argv)
    count = copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                         not_null_fields=args.not_null_fields,
                         rows_per_row_group=args.rows_per_row_group,
                         row_group_size_mb=args.row_group_size_mb,
                         rows_per_file=args.rows_per_file, workers_count=args.workers_count)
    print('Copied {} rows'.format(count))
    return 0


if __name__ == '__main__':
    sys.exit(main())
