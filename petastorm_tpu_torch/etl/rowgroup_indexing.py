"""Build and load row-group indexes.

Twin of ``petastorm_tpu/etl/rowgroup_indexing.py``. The indexing map runs on
a local thread pool over the row-group pieces (the read and decode are
I/O and C-level work, so threads suffice); the reduced inverted indexes are
stored as JSON in ``_common_metadata`` under
:data:`~petastorm_tpu_torch.etl.dataset_metadata.ROW_GROUP_INDEX_KEY`, the
JAX package's key, so an index built by either package is read by the
other. Not ported yet: the legacy petastorm index fallback (the "remote
filesystems" item, with the other legacy-store fallbacks).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import ThreadPoolExecutor

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexers import indexer_from_json
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.unischema import decode_row

logger = logging.getLogger(__name__)

#: the key under which legacy petastorm stores keep their (pickled) indexes
LEGACY_ROW_GROUP_INDEX_KEY = b'dataset-toolkit.rowgroups_index.v1'


def build_rowgroup_index(dataset_url, indexers, max_workers=10):
    """Map each row-group piece through every indexer, reduce by ``__add__``,
    and store the combined index in the dataset's metadata. Returns the
    combined indexers."""
    if not indexers:
        raise PetastormTpuError('indexers list must not be empty')
    schema = dataset_metadata.get_schema(dataset_url)
    pieces = dataset_metadata.load_row_groups(dataset_url)
    fs = FilesystemResolver(dataset_url).filesystem()

    column_names = sorted({c for indexer in indexers for c in indexer.column_names})
    data_columns = [c for c in column_names if c in schema.fields]

    def index_piece(piece_and_index):
        piece, piece_index = piece_and_index
        with fs.open_input_file(piece.path) as f:
            cols = [c for c in data_columns if c not in piece.partition_keys]
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=cols)
        rows = table.to_pylist()
        for row in rows:
            row.update(piece.partition_keys)
        decoded = [decode_row(row, schema) for row in rows]
        # fresh indexer instances per piece (the map step)
        piece_indexers = [indexer_from_json(ix.to_json()) for ix in indexers]
        for ix in piece_indexers:
            ix.build_index(decoded, piece_index)
        return piece_indexers

    with ThreadPoolExecutor(max_workers=max_workers) as executor:
        per_piece = list(executor.map(index_piece, [(p, i) for i, p in enumerate(pieces)]))

    combined = list(per_piece[0])
    for piece_indexers in per_piece[1:]:
        combined = [a + b for a, b in zip(combined, piece_indexers)]

    payload = json.dumps({ix.index_name: ix.to_json() for ix in combined}).encode('utf-8')
    dataset_metadata.add_dataset_metadata(dataset_url, dataset_metadata.ROW_GROUP_INDEX_KEY,
                                          payload)
    logger.info('Built %d row-group indexes over %d pieces', len(combined), len(pieces))
    return combined


def get_row_group_indexes(dataset_url, retry_policy=None):
    """The stored indexes: dict index_name -> indexer."""
    meta = dataset_metadata.read_metadata_dict(dataset_url, retry_policy=retry_policy)
    raw = meta.get(dataset_metadata.ROW_GROUP_INDEX_KEY)
    if raw is None:
        if meta.get(LEGACY_ROW_GROUP_INDEX_KEY) is not None:
            raise NotImplementedError(
                'legacy petastorm row-group indexes are not yet ported to petastorm_tpu_torch '
                '(ROADMAP.md, "remote filesystems"): {}'.format(dataset_url))
        raise PetastormTpuError(
            'Dataset at {} has no row-group index. Run build_rowgroup_index first.'.format(
                dataset_url))
    spec = json.loads(raw.decode('utf-8'))
    return {name: indexer_from_json(s) for name, s in spec.items()}
