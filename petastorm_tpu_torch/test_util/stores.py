"""Store layouts that other writers leave, made from a store of the port.

:func:`write_summary_metadata` gives a store the ``_metadata`` summary file
that Spark and ``pyarrow.parquet.write_metadata`` write: every data file's
row groups, each naming its file by its path relative to the store.
``load_row_groups`` lists pieces from it when no counts are stored. Used by
the port's CPU tests and by ``chip_smoke.py``.
"""

import os

import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.etl import dataset_metadata


def data_files(root):
    """The store's data files as paths relative to ``root``, in path order."""
    return [os.path.relpath(path, root)
            for path in dataset_metadata.list_parquet_files(pafs.LocalFileSystem(), root)]


def write_summary_metadata(root):
    """Write ``<root>/_metadata`` from the footers of the store's data files
    and rewrite ``_common_metadata`` without its per-file row-group counts,
    so the summary is the route that lists the pieces."""
    summary = None
    for relpath in data_files(root):
        md = pq.ParquetFile(os.path.join(root, relpath)).metadata
        md.set_file_path(relpath)
        if summary is None:
            summary = md
        else:
            summary.append_row_groups(md)
    summary.write_metadata_file(os.path.join(root, dataset_metadata._SUMMARY_METADATA))
    common = os.path.join(root, dataset_metadata._COMMON_METADATA)
    if os.path.exists(common):
        arrow_schema = pq.read_schema(common)
        metadata = {k: v for k, v in (arrow_schema.metadata or {}).items()
                    if k != dataset_metadata.ROW_GROUPS_PER_FILE_KEY}
        pq.write_metadata(arrow_schema.with_metadata(metadata), common)
