"""Write a store's ``_common_metadata`` anew: its schema and row-group counts.

Twin of ``petastorm_tpu/tools/generate_metadata.py`` (the reference's
``petastorm-generate-metadata``): for a store whose metadata was lost, or
one another tool wrote or rewrote. The counts come from the data files'
footers, never from stale stored metadata.

Run as ``python -m petastorm_tpu_torch.tools.generate_metadata DATASET_URL
[--unischema-class pkg.module.SCHEMA]``.
"""

from __future__ import annotations

import argparse
import importlib
import posixpath
import sys

from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.unischema import Unischema


def _load_schema_object(dotted):
    """``'pkg.module.SCHEMA_ATTR'`` -> the Unischema object it names."""
    module_name, _, attr = dotted.rpartition('.')
    if not module_name:
        raise ValueError('--unischema-class must be a dotted path like mypkg.schema.MySchema')
    schema = getattr(importlib.import_module(module_name), attr)
    if not isinstance(schema, Unischema):
        raise TypeError('{} is not a Unischema (got {})'.format(dotted, type(schema)))
    return schema


def generate_metadata(dataset_url, unischema_class=None):
    """Write (or overwrite) the store's ``_common_metadata``, its counts read
    from the files' footers. Returns ``(schema, row groups)``.

    :param unischema_class: the dotted path of a Unischema object; without
        it the stored schema is kept, else one is inferred from the Arrow
        schema (inference cannot recover codecs: pass the class for a
        petastorm store whose metadata was lost)
    """
    if unischema_class is not None:
        schema = _load_schema_object(unischema_class)
    else:
        schema = dataset_metadata.infer_or_load_unischema(dataset_url)
    pieces = dataset_metadata.load_row_groups(dataset_url, schema=schema,
                                              use_cached_metadata=False)
    root = FilesystemResolver(dataset_url).get_dataset_path()
    counts = {}
    for piece in pieces:
        counts.setdefault(posixpath.relpath(piece.path, root), []).append(piece.num_rows)
    dataset_metadata._write_dataset_metadata(dataset_url, schema, counts)
    return schema, sum(len(v) for v in counts.values())


def main(argv=None):
    parser = argparse.ArgumentParser(description='(Re)generate the metadata of a '
                                     'petastorm_tpu / petastorm_tpu_torch store.')
    parser.add_argument('dataset_url')
    parser.add_argument('--unischema-class', default=None,
                        help='the dotted path of the Unischema object, e.g. '
                             'mypkg.schema.MySchema')
    args = parser.parse_args(argv)
    schema, n_row_groups = generate_metadata(args.dataset_url, args.unischema_class)
    print('Wrote metadata: schema={} fields, {} row groups'.format(len(schema), n_row_groups))
    return 0


if __name__ == '__main__':
    sys.exit(main())
