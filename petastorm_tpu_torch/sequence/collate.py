"""Ragged/padded collation: variable-length rows -> dense padded batches.

Twin of ``petastorm_tpu/sequence/collate.py``: the same padded lengths,
arrays and waste accounting. The fixed collate path
(:func:`petastorm_tpu_torch.torch.loader.collate_rows`) refuses non-uniform
shapes, because silently padding would change what the model sees.
This module is the explicit opt-in: a :class:`CollateSpec` names which fields
are ragged and HOW to pad them (a ``pad_to`` multiple, ``buckets`` boundaries,
an optional hard ``max_length`` truncation), the collate emits dense
``[B, L, ...]`` arrays plus an int32 ``<field>_lengths`` vector per ragged
field, and every batch's padding waste is accounted
(``padding_waste_fraction``).

Everything here is deterministic: padded lengths are pure functions of the
batch's real lengths and the spec, never of wall clocks or RNG draws.
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError


class PadSpec(object):
    """Padding policy for ONE ragged field (leading axis is the ragged one).

    :param pad_to: pad the batch length up to the next multiple of this
        (e.g. 128 keeps the number of distinct batch shapes small). ``None`` = exact max.
    :param buckets: sorted length boundaries; the batch pads to the smallest
        boundary >= its longest row (lengths beyond the last boundary fall
        back to ``pad_to`` rounding). Pair with
        :class:`~petastorm_tpu_torch.sequence.bucket.BucketBatchBuffer` so rows of
        one batch share a bucket and the padding waste stays small.
    :param max_length: hard cap — longer rows are TRUNCATED to this many
        elements (an explicit data-changing decision, so never a default).
    :param pad_value: fill value for the padded tail (default 0).
    :param emit_lengths: also emit ``<field>_lengths`` (int32 real lengths,
        pre-truncation capped at ``max_length``) into the batch.
    """

    __slots__ = ('pad_to', 'buckets', 'max_length', 'pad_value', 'emit_lengths')

    def __init__(self, pad_to=None, buckets=None, max_length=None, pad_value=0,
                 emit_lengths=True):
        if pad_to is not None and pad_to < 1:
            raise ValueError('pad_to must be >= 1')
        if buckets is not None:
            buckets = tuple(sorted(int(b) for b in buckets))
            if not buckets or buckets[0] < 1:
                raise ValueError('buckets must be a non-empty sequence of lengths >= 1')
        if max_length is not None and max_length < 1:
            raise ValueError('max_length must be >= 1')
        self.pad_to = pad_to
        self.buckets = buckets
        self.max_length = max_length
        self.pad_value = pad_value
        self.emit_lengths = emit_lengths

    def __repr__(self):
        return 'PadSpec(pad_to={}, buckets={}, max_length={})'.format(
            self.pad_to, self.buckets, self.max_length)


def padded_length(length, spec):
    """The dense length a batch whose longest row is ``length`` pads to —
    a pure function of (length, spec): bucket boundary first, then ``pad_to``
    rounding, after the ``max_length`` cap."""
    n = int(length)
    if spec.max_length is not None:
        n = min(n, spec.max_length)
    if spec.buckets is not None:
        i = bisect_left(spec.buckets, n)
        if i < len(spec.buckets):
            return spec.buckets[i]
    if spec.pad_to is not None:
        n = ((n + spec.pad_to - 1) // spec.pad_to) * spec.pad_to
    return max(n, 1)


class CollateSpec(object):
    """Batch-level ragged collation policy: which fields pad, and which field's
    length drives bucketing/packing decisions.

    :param pads: mapping field name -> :class:`PadSpec` (a bare ``PadSpec``
        is accepted for single-field shorthand via ``{'field': PadSpec()}``)
    :param length_of: the field whose per-row length is THE sequence length
        (bucket assignment, token accounting). Defaults to the first ``pads``
        key.
    """

    __slots__ = ('pads', 'length_of')

    def __init__(self, pads, length_of=None):
        if not isinstance(pads, dict) or not pads:
            raise ValueError('pads must be a non-empty {field: PadSpec} dict')
        for name, spec in pads.items():
            if not isinstance(spec, PadSpec):
                raise ValueError('pads[{!r}] must be a PadSpec, got {!r}'.format(name, spec))
        self.pads = dict(pads)
        self.length_of = length_of if length_of is not None else next(iter(pads))
        if self.length_of not in self.pads:
            raise ValueError('length_of {!r} is not a padded field ({})'.format(
                self.length_of, sorted(self.pads)))

    def row_length(self, row):
        """Real (untruncated) sequence length of one row dict/namedtuple."""
        value = row[self.length_of] if isinstance(row, dict) else getattr(row, self.length_of)
        return len(value)


def _cell(row, name):
    return row[name] if isinstance(row, dict) else getattr(row, name)


def _pad_field(values, spec, name):
    """Stack ragged cells into one dense [B, L, ...] array + lengths."""
    cells = [np.asarray(v) for v in values]
    lengths = np.array([c.shape[0] if c.ndim else 0 for c in cells], dtype=np.int32)
    if spec.max_length is not None:
        lengths = np.minimum(lengths, spec.max_length)
    trailing = {c.shape[1:] for c in cells}
    if len(trailing) > 1:
        raise PetastormTpuError(
            'Field {!r} mixes trailing shapes {} within a batch; ragged collation pads '
            'only the leading axis'.format(name, sorted(trailing)))
    target = padded_length(int(lengths.max()) if len(lengths) else 1, spec)
    dtype = cells[0].dtype
    if dtype == object:
        raise PetastormTpuError(
            'Field {!r} decoded to object cells; ragged collation needs numeric '
            'arrays (check the codec / TransformSpec output)'.format(name))
    out = np.full((len(cells), target) + cells[0].shape[1:], spec.pad_value, dtype=dtype)
    for i, c in enumerate(cells):
        n = int(lengths[i])
        out[i, :n] = c[:n]
    return out, lengths


def collate_ragged_rows(rows, spec, stats=None):
    """Collate row dicts/namedtuples into a padded batch.

    Fields named in ``spec.pads`` are padded per their :class:`PadSpec` (with
    an ``<name>_lengths`` int32 vector when ``emit_lengths``); every other
    field goes through the fixed :func:`~petastorm_tpu_torch.torch.loader.collate_rows`
    path unchanged.

    :param stats: optional mutable dict accumulating ``real_tokens`` /
        ``padded_tokens`` across calls (the loader's padding-waste telemetry
        reads these; tokens are counted on ``spec.length_of`` only, so the
        waste fraction describes the model's sequence axis, not every
        padded field).
    """
    from petastorm_tpu_torch.torch.loader import collate_rows

    if not rows:
        raise PetastormTpuError('Cannot collate an empty batch')
    rows = [r._asdict() if hasattr(r, '_asdict') else r for r in rows]
    batch = {}
    for name, pad in spec.pads.items():
        if name not in rows[0]:
            raise PetastormTpuError('CollateSpec pads unknown field {!r} (batch has {})'.format(
                name, sorted(rows[0])))
        padded, lengths = _pad_field([_cell(r, name) for r in rows], pad, name)
        batch[name] = padded
        if pad.emit_lengths:
            batch[name + '_lengths'] = lengths
        if stats is not None and name == spec.length_of:
            stats['real_tokens'] = stats.get('real_tokens', 0) + int(lengths.sum())
            stats['padded_tokens'] = (stats.get('padded_tokens', 0) +
                                      padded.shape[0] * padded.shape[1])
    fixed = [n for n in rows[0] if n not in spec.pads]
    if fixed:
        batch.update(collate_rows(rows, field_names=fixed))
    return batch


def padding_waste_fraction(stats):
    """``1 - real/padded`` over an accumulated stats dict (0.0 before any
    batch — the key-always-present diagnostics contract)."""
    padded = stats.get('padded_tokens', 0)
    if not padded:
        return 0.0
    return round(1.0 - stats.get('real_tokens', 0) / padded, 4)
