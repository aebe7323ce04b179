"""NGram: windowed sequence readout over timestamp-ordered rows.

Twin of ``petastorm_tpu/ngram.py``: the fields each timestep needs,
``delta_threshold``, ``timestamp_overlap``, regex field resolution and the
per-timestep schema views. Windows never cross a row group: a sequence longer
than a row group needs larger row groups.

The row path (:meth:`NGram.form_ngram`) assembles windows from row dicts;
the columnar path (:meth:`NGram.form_ngram_columnar`) from one decoded column
block with no Python per row. The loader collates the windows offset by
offset, and ``stack_ngram_time_axis`` turns them into ``[B, T, ...]``
time-major arrays for the sequence model.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.unischema import UnischemaField, match_unischema_fields


class NGram(object):
    """
    :param fields: dict mapping integer timestep offset -> list of
        :class:`UnischemaField` or regex pattern strings. Offsets must be
        consecutive integers (any base), e.g. ``{-1: [...], 0: [...], 1: [...]}``.
    :param delta_threshold: maximum allowed timestamp delta between two
        consecutive timesteps in a window; windows violating it are dropped.
    :param timestamp_field: the :class:`UnischemaField` (or name) ordering rows.
    :param timestamp_overlap: if False, consecutive windows never share rows.
    """

    def __init__(self, fields, delta_threshold, timestamp_field, timestamp_overlap=True):
        if not isinstance(fields, dict) or not fields:
            raise PetastormTpuError('fields must be a non-empty dict of offset -> field list')
        offsets = sorted(fields.keys())
        if offsets != list(range(offsets[0], offsets[-1] + 1)):
            raise PetastormTpuError(
                'NGram offsets must be consecutive integers, got {}'.format(offsets))
        self._fields = {k: list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field_name = (timestamp_field.name
                                      if isinstance(timestamp_field, UnischemaField)
                                      else timestamp_field)
        self._timestamp_overlap = timestamp_overlap
        self._min_offset = offsets[0]
        self._max_offset = offsets[-1]

    @property
    def length(self):
        """Window length in timesteps."""
        return self._max_offset - self._min_offset + 1

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field_name(self):
        return self._timestamp_field_name

    @property
    def timestamp_overlap(self):
        return self._timestamp_overlap

    def resolve_regex_field_names(self, schema):
        """Replace regex pattern strings in the per-timestep field lists with
        the schema fields they match."""
        for offset, field_list in self._fields.items():
            resolved = []
            for item in field_list:
                if isinstance(item, UnischemaField):
                    resolved.append(item)
                else:
                    matched = match_unischema_fields(schema, [item])
                    if not matched:
                        raise PetastormTpuError('NGram pattern {!r} matched no fields in '
                                                'schema {}'.format(item, schema.name))
                    resolved.extend(matched)
            self._fields[offset] = resolved

    def get_field_names_at_timestep(self, offset):
        return [f.name if isinstance(f, UnischemaField) else f
                for f in self._fields.get(offset, [])]

    def get_field_names_at_all_timesteps(self):
        names = set()
        for offset in self._fields:
            names.update(self.get_field_names_at_timestep(offset))
        names.add(self._timestamp_field_name)
        return sorted(names)

    def get_schema_at_timestep(self, schema, offset):
        """Schema view containing only this timestep's fields."""
        names = [n for n in self.get_field_names_at_timestep(offset) if n in schema.fields]
        return schema.create_schema_view([schema.fields[n] for n in names])

    def form_ngram(self, data, schema):
        """Assemble windows from decoded rows of ONE row group.

        :param data: list of row dicts (will be sorted by the timestamp field)
        :param schema: the (possibly transformed) row schema
        :return: list of dicts offset -> per-timestep row dict (only that
            timestep's fields)
        """
        rows = sorted(data, key=lambda r: r[self._timestamp_field_name])
        length = self.length
        ngrams = []
        start = 0
        while start + length <= len(rows):
            window = rows[start:start + length]
            if self._window_within_threshold(window):
                ngram = {}
                for offset in range(self._min_offset, self._max_offset + 1):
                    row = window[offset - self._min_offset]
                    wanted = self.get_field_names_at_timestep(offset)
                    ngram[offset] = {k: row[k] for k in wanted if k in row}
                ngrams.append(ngram)
                start += length if not self._timestamp_overlap else 1
            else:
                start += 1
        return ngrams

    def form_ngram_columnar(self, block):
        """Assemble windows from ONE row group's decoded column block: the
        window semantics of :meth:`form_ngram` (stable timestamp sort,
        ``delta_threshold`` filtering, greedy non-overlapping selection) with
        no Python per row. Window membership is a cumulative sum over the
        sorted timestamp deltas, and each timestep's fields one numpy gather.

        :param block: dict ``field -> [N, ...]`` column (must include the
            timestamp field)
        :return: dict ``offset -> {field: [W, ...]}`` for W windows, or ``None``
            when no window qualifies
        """
        ts = block[self._timestamp_field_name]
        n = len(ts)
        length = self.length
        if n < length:
            return None
        if isinstance(ts, np.ndarray) and ts.dtype != object:
            order = np.argsort(ts, kind='stable')
            ts_sorted = ts[order]
            if self._delta_threshold is None or n < 2:
                bad = np.zeros(max(n - 1, 0), dtype=bool)
            else:
                bad = np.diff(ts_sorted) > self._delta_threshold
        else:
            # object timestamps (Decimal, datetime objects): Python compares,
            # as the row path does
            ts_list = list(ts)
            order = np.array(sorted(range(n), key=ts_list.__getitem__), dtype=np.int64)
            ts_sorted = [ts_list[i] for i in order]
            if self._delta_threshold is None or n < 2:
                bad = np.zeros(max(n - 1, 0), dtype=bool)
            else:
                bad = np.array([b - a > self._delta_threshold
                                for a, b in zip(ts_sorted, ts_sorted[1:])], dtype=bool)
        # the window starting at s is valid iff no over-threshold delta lies
        # among sorted positions [s, s + length - 1): a prefix sum of the bad
        # deltas
        cs = np.concatenate([[0], np.cumsum(bad)])
        num_starts = n - length + 1
        ok = (cs[length - 1:length - 1 + num_starts] - cs[:num_starts]) == 0
        if self._timestamp_overlap:
            starts = np.flatnonzero(ok)
        else:
            picked = []
            s = 0
            while s < num_starts:  # greedy, as the row path's start += length
                if ok[s]:
                    picked.append(s)
                    s += length
                else:
                    s += 1
            starts = np.asarray(picked, dtype=np.int64)
        if len(starts) == 0:
            return None
        out = {}
        for offset in range(self._min_offset, self._max_offset + 1):
            idx = order[starts + (offset - self._min_offset)]
            wanted = [k for k in self.get_field_names_at_timestep(offset) if k in block]
            out[offset] = {k: block[k][idx] for k in wanted}
        return out

    def _window_within_threshold(self, window):
        if self._delta_threshold is None:
            return True
        ts = [r[self._timestamp_field_name] for r in window]
        for a, b in zip(ts, ts[1:]):
            if b - a > self._delta_threshold:
                return False
        return True

    def make_namedtuple(self, schema, ngram_as_dicts):
        """Convert an ngram of row dicts into offset -> schema-view namedtuple
        (what the reader yields)."""
        result = {}
        for offset, row in ngram_as_dicts.items():
            view = self.get_schema_at_timestep(schema, offset)
            result[offset] = view.make_namedtuple(**{k: row[k] for k in view.fields})
        return result
