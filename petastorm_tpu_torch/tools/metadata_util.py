"""Print a store's metadata: its schema, its row-group indexes, its pieces.

Twin of ``petastorm_tpu/tools/metadata_util.py`` (the reference's
``etl/metadata_util.py``); the text it prints is the JAX tool's.

Run as ``python -m petastorm_tpu_torch.tools.metadata_util DATASET_URL
[--schema] [--index [--skip-index-values]] [--pieces]``.
"""

from __future__ import annotations

import argparse
import sys

from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes


def main(argv=None):
    parser = argparse.ArgumentParser(description='Inspect the metadata of a petastorm_tpu / '
                                     'petastorm_tpu_torch store.')
    parser.add_argument('dataset_url')
    parser.add_argument('--schema', action='store_true', help='print the unischema')
    parser.add_argument('--index', action='store_true', help='print row-group index summaries')
    parser.add_argument('--skip-index-values', action='store_true',
                        help='with --index: omit the indexed values listing')
    parser.add_argument('--pieces', action='store_true', help='print row-group pieces')
    args = parser.parse_args(argv)

    if args.schema:
        print(repr(dataset_metadata.get_schema(args.dataset_url)))
    if args.index:
        for name, indexer in sorted(get_row_group_indexes(args.dataset_url).items()):
            print('index {!r} on columns {}:'.format(name, indexer.column_names))
            values = indexer.indexed_values
            print('  {} indexed values'.format(len(values)))
            if not args.skip_index_values:
                for value in values:
                    print('   {!r} -> {}'.format(
                        value, sorted(indexer.get_row_group_indexes(value))))
    if args.pieces:
        for i, piece in enumerate(dataset_metadata.load_row_groups(args.dataset_url)):
            print('{:4d}: {}'.format(i, piece))
    return 0


if __name__ == '__main__':
    sys.exit(main())
