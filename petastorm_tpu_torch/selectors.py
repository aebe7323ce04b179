"""Row-group selectors: query precomputed row-group indexes.

Twin of ``petastorm_tpu/selectors.py``, whole. A selector names the indexes
it needs (stored by ``etl.rowgroup_indexing.build_rowgroup_index``) and
returns the set of row-group indexes, in the store's unfiltered piece
enumeration, that the reader keeps.
"""

from __future__ import annotations

from petastorm_tpu_torch.errors import PetastormTpuError


class RowGroupSelectorBase(object):
    def get_index_names(self):
        """Names of the indexes this selector needs loaded."""
        raise NotImplementedError

    def select_row_groups(self, index_dict):
        """index_dict: index_name -> indexer. Return a set of piece indexes."""
        raise NotImplementedError


class SingleIndexSelector(RowGroupSelectorBase):
    """Union of pieces containing any of ``values`` in the named index."""

    def __init__(self, index_name, values):
        self._index_name = index_name
        self._values = list(values)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        if self._index_name not in index_dict:
            raise PetastormTpuError('Index {!r} not found in dataset'.format(self._index_name))
        indexer = index_dict[self._index_name]
        selected = set()
        for value in self._values:
            selected |= indexer.get_row_group_indexes(value)
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """Pieces selected by ALL of the given single-index selectors."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()


class UnionIndexSelector(RowGroupSelectorBase):
    """Pieces selected by ANY of the given single-index selectors."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        selected = set()
        for s in self._selectors:
            selected |= s.select_row_groups(index_dict)
        return selected
