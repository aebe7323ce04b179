"""Row-group indexer protocol (twin of ``petastorm_tpu/etl/indexer_base.py``)."""

from __future__ import annotations


class RowGroupIndexerBase(object):
    """Base class for row-group indexers: map decoded rows of each row group to
    a value -> {piece indexes} inverted index used by row-group selectors."""

    @property
    def index_name(self):
        """Unique name of this index."""
        raise NotImplementedError

    @property
    def column_names(self):
        """Columns the indexer needs read+decoded to build the index."""
        raise NotImplementedError

    @property
    def indexed_values(self):
        """All values present in the index."""
        raise NotImplementedError

    def get_row_group_indexes(self, value_key):
        """Set of row-group (piece) indexes containing ``value_key``."""
        raise NotImplementedError

    def build_index(self, decoded_rows, piece_index):
        """Consume decoded rows of one row group, record them under ``piece_index``."""
        raise NotImplementedError

    def __add__(self, other):
        """Merge two indexers of the same type/name (reduce step)."""
        raise NotImplementedError

    def to_json(self):
        raise NotImplementedError
