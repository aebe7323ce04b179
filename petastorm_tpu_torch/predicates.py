"""Row predicates with a column-pruning contract.

Twin of ``petastorm_tpu/predicates.py``, whole. A predicate declares the
fields it needs (``get_fields``), so a worker reads and decodes only those
columns first, evaluates the mask, and leaves a row group early when no row
survives, before touching the heavy columns. Where the predicate describes
itself as an AND of numeric clauses (``native_clauses``), the fused native
read evaluates it below the GIL, skips whole pages by their min/max
statistics and decodes only the surviving rows (``native/fused.py``).
``in_pseudorandom_split`` hashes with md5 exactly as the JAX package does,
so a split keeps the same rows in both packages.
"""

from __future__ import annotations

import hashlib

import numpy as np


class PredicateBase(object):
    def get_fields(self):
        """Names of fields ``do_include`` needs."""
        raise NotImplementedError

    def do_include(self, values):
        """values: dict field_name -> decoded value for one row. Return True to
        keep the row."""
        raise NotImplementedError

    def do_include_batch(self, block):
        """Optional vectorized evaluation: ``block`` is a dict of whole decoded
        columns (``[N]``/``[N, ...]`` arrays); return a boolean ``[N]`` mask, or
        ``None`` to make the worker fall back to per-row :meth:`do_include`.
        Predicates that can answer column-at-a-time (``in_set``, compositions
        thereof) keep the pushdown path free of per-row Python."""
        return None

    def native_clauses(self):
        """AND-of-clauses description for the fused native predicate stage, or
        ``None`` when this predicate cannot be pushed below the GIL (the
        worker then evaluates it in Python as before). Each clause is a dict
        ``{'field', 'op': 'in'|'range', 'negate'}`` plus ``'values'`` (in) or
        ``'lo'/'hi'/'lo_incl'/'hi_incl'`` (range); clauses are ANDed row-wise.
        Semantics MUST match :meth:`do_include` exactly — the worker trusts
        the native verdict without re-checking."""
        return None


def evaluate_predicate_mask(predicate, block, num_rows):
    """THE contract enforcement for :meth:`PredicateBase.do_include_batch`,
    shared by both workers' pushdown paths: returns a validated boolean mask,
    or ``None`` when the predicate has no batch path / declined (callers fall
    back to per-row ``do_include``)."""
    mask = _batch_mask(predicate, block)
    if mask is None:
        return None
    mask = np.asarray(mask)
    if mask.ndim != 1 or len(mask) != num_rows:
        raise ValueError(
            'do_include_batch must return a 1-D mask with one entry per row; '
            'got shape {} for {} rows'.format(mask.shape, num_rows))
    return mask.astype(bool, copy=False)


def _batch_mask(predicate, block):
    """The optional-batch contract in one place: a predicate without
    ``do_include_batch`` (duck-typed, row-only) declines with ``None``, same
    as one whose batch path returns ``None``."""
    batch_fn = getattr(predicate, 'do_include_batch', None)
    if batch_fn is None:
        return None
    return batch_fn(block)


def _native_semantics_intact(predicate, base):
    """A subclass that overrides ``do_include``/``do_include_batch`` changed
    the predicate's semantics: the base class's clause description no longer
    speaks for it, and the native pushdown — which trusts the clauses without
    re-checking — must decline rather than silently evaluate the BASE
    semantics below the GIL."""
    cls = type(predicate)
    return (cls.do_include is base.do_include and
            cls.do_include_batch is base.do_include_batch)


class in_set(PredicateBase):
    """Keep rows whose scalar field value is in ``inclusion_values``."""

    def __init__(self, inclusion_values, field_name):
        self._inclusion_values = set(inclusion_values)
        self._field_name = field_name

    def get_fields(self):
        return {self._field_name}

    def do_include(self, values):
        return values[self._field_name] in self._inclusion_values

    def do_include_batch(self, block):
        col = block[self._field_name]
        if not isinstance(col, np.ndarray) or col.ndim != 1:
            return None
        # np.isin silently COERCES mixed-type inclusion lists (e.g. ['a', 1]
        # becomes a unicode array and 1 stops matching int columns) instead of
        # raising — so only vectorize when the values demonstrably share the
        # column's comparison domain; anything else keeps per-row semantics
        vals = list(self._inclusion_values)
        if col.dtype.kind in 'biuf':
            ok = all(isinstance(v, (int, float, np.number)) and not isinstance(v, (str, bytes))
                     for v in vals)
        elif col.dtype.kind == 'U':
            ok = all(isinstance(v, str) for v in vals)
        elif col.dtype.kind == 'S':
            ok = all(isinstance(v, bytes) for v in vals)
        elif col.dtype == object:
            ok = (all(isinstance(v, str) for v in vals) and
                  all(isinstance(v, str) for v in col))
        else:
            ok = False
        if not ok:
            return None
        return np.isin(col, vals)

    def native_clauses(self):
        if not _native_semantics_intact(self, in_set):
            return None
        vals = list(self._inclusion_values)
        # numeric/bool membership is the natively-evaluable shape; string and
        # mixed-type sets keep the Python path (same domain caution as the
        # vectorized branch above)
        if not all(isinstance(v, (bool, int, float, np.bool_, np.integer,
                                  np.floating))
                   and not isinstance(v, (str, bytes)) for v in vals):
            return None
        return [{'field': self._field_name, 'op': 'in', 'values': vals,
                 'negate': False}]


class in_range(PredicateBase):
    """Keep rows whose scalar field value lies between ``lo`` and ``hi``
    (either bound optional, inclusivity configurable). This is the canonical
    natively-pushable range predicate: on qualifying stores the fused kernel
    evaluates it below the GIL and skips whole pages via min/max page
    statistics before decoding anything."""

    def __init__(self, field_name, lo=None, hi=None, lo_inclusive=True,
                 hi_inclusive=True):
        if lo is None and hi is None:
            raise ValueError('in_range needs at least one bound')
        self._field_name = field_name
        self._lo = lo
        self._hi = hi
        self._lo_inclusive = bool(lo_inclusive)
        self._hi_inclusive = bool(hi_inclusive)

    def get_fields(self):
        return {self._field_name}

    def _in_range(self, v):
        if self._lo is not None:
            ok = v >= self._lo if self._lo_inclusive else v > self._lo
            if not ok:
                return False
        if self._hi is not None:
            ok = v <= self._hi if self._hi_inclusive else v < self._hi
            if not ok:
                return False
        return True

    def do_include(self, values):
        return bool(self._in_range(values[self._field_name]))

    def do_include_batch(self, block):
        col = block[self._field_name]
        if not isinstance(col, np.ndarray) or col.ndim != 1 \
                or col.dtype.kind not in 'biuf':
            return None
        mask = np.ones(len(col), dtype=bool)
        with np.errstate(invalid='ignore'):
            if self._lo is not None:
                mask &= (col >= self._lo) if self._lo_inclusive else (col > self._lo)
            if self._hi is not None:
                mask &= (col <= self._hi) if self._hi_inclusive else (col < self._hi)
        return mask

    def native_clauses(self):
        if not _native_semantics_intact(self, in_range):
            return None
        return [{'field': self._field_name, 'op': 'range', 'lo': self._lo,
                 'hi': self._hi, 'lo_incl': self._lo_inclusive,
                 'hi_incl': self._hi_inclusive, 'negate': False}]


class in_intersection(PredicateBase):
    """Keep rows whose array field intersects ``inclusion_values``."""

    def __init__(self, inclusion_values, field_name):
        self._inclusion_values = set(inclusion_values)
        self._field_name = field_name

    def get_fields(self):
        return {self._field_name}

    def _cell_intersects(self, value):
        """THE intersection semantics (None excluded; arrays compared over
        ``.flat``), shared by the row and batched paths."""
        if value is None:
            return False
        return not self._inclusion_values.isdisjoint(
            v for v in (value.flat if isinstance(value, np.ndarray) else value))

    def do_include(self, values):
        return self._cell_intersects(values[self._field_name])

    def do_include_batch(self, block):
        col = block[self._field_name]
        if not isinstance(col, np.ndarray):
            return None
        if col.ndim >= 2 and col.dtype.kind in 'biuf':
            # uniform stacked cells: one vectorized isin over the flattened
            # tail axes (same mixed-type guard as in_set — np.isin silently
            # coerces e.g. strings against numeric columns)
            vals = list(self._inclusion_values)
            if not all(isinstance(v, (int, float, np.number)) and not isinstance(v, (str, bytes))
                       for v in vals):
                return None
            return np.isin(col.reshape(len(col), -1), vals).any(axis=1)
        if col.ndim == 1 and col.dtype == object:
            # ragged cells: per-cell set probe, but no per-row dict churn
            return np.fromiter((self._cell_intersects(v) for v in col),
                               dtype=bool, count=len(col))
        return None


class in_lambda(PredicateBase):
    """Arbitrary user predicate over the named fields; optional mutable state
    object is passed as a second argument when provided."""

    def __init__(self, predicate_fields, predicate_func, state=None):
        self._predicate_fields = list(predicate_fields)
        self._predicate_func = predicate_func
        self._state = state

    def get_fields(self):
        return set(self._predicate_fields)

    def do_include(self, values):
        if self._state is None:
            return self._predicate_func(values)
        return self._predicate_func(values, self._state)


class in_negate(PredicateBase):
    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)

    def do_include_batch(self, block):
        inner = _batch_mask(self._predicate, block)
        return None if inner is None else ~np.asarray(inner, dtype=bool)

    def native_clauses(self):
        if not _native_semantics_intact(self, in_negate):
            return None
        inner = getattr(self._predicate, 'native_clauses', lambda: None)()
        if inner is None or len(inner) != 1:
            # NOT over an AND of several clauses is not an AND of clauses
            return None
        cl = dict(inner[0])
        cl['negate'] = not cl.get('negate')
        return [cl]


class in_reduce(PredicateBase):
    """Compose predicates with a reduction over their booleans, e.g.
    ``in_reduce([p1, p2], all)`` or ``in_reduce([p1, p2], any)``."""

    def __init__(self, predicate_list, reduce_func):
        self._predicate_list = list(predicate_list)
        self._reduce_func = reduce_func

    def get_fields(self):
        fields = set()
        for p in self._predicate_list:
            fields |= set(p.get_fields())
        return fields

    def do_include(self, values):
        return self._reduce_func([p.do_include(values) for p in self._predicate_list])

    def do_include_batch(self, block):
        if self._reduce_func is all:
            combine = np.logical_and.reduce
        elif self._reduce_func is any:
            combine = np.logical_or.reduce
        else:
            return None  # arbitrary reducers keep row-at-a-time semantics
        masks = []
        for p in self._predicate_list:
            m = _batch_mask(p, block)
            if m is None:
                return None
            masks.append(np.asarray(m, dtype=bool))
        return combine(masks)

    def native_clauses(self):
        if not _native_semantics_intact(self, in_reduce):
            return None
        if self._reduce_func is not all:
            return None  # only conjunctions are an AND of clauses
        out = []
        for p in self._predicate_list:
            cls = getattr(p, 'native_clauses', lambda: None)()
            if cls is None:
                return None
            out.extend(cls)
        return out or None


class in_pseudorandom_split(PredicateBase):
    """Deterministic hash-bucket train/val/test split on a field.

    ``fraction_list`` are the subset fractions (must sum to <= 1.0);
    ``subset_index`` selects which subset this predicate keeps. The same field
    value always lands in the same subset, across runs and processes.
    """

    _BUCKETS = 2 ** 32

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError('subset_index {} out of range for {} fractions'.format(
                subset_index, len(fraction_list)))
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError('fractions must sum to <= 1.0, got {}'.format(sum(fraction_list)))
        cumsum = np.cumsum([0.0] + list(fraction_list))
        self._low = cumsum[subset_index]
        self._high = cumsum[subset_index + 1]
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def _in_bucket(self, value):
        raw = value if isinstance(value, bytes) else str(value).encode('utf-8')
        bucket = int.from_bytes(hashlib.md5(raw).digest()[:4], 'big') / self._BUCKETS
        return self._low <= bucket < self._high

    def do_include(self, values):
        return self._in_bucket(values[self._predicate_field])

    def do_include_batch(self, block):
        col = block[self._predicate_field]
        if not isinstance(col, np.ndarray) or col.ndim != 1:
            return None
        # the md5 per value is inherent (split stability contract); batching
        # still skips the per-row dict materialization of the fallback path
        return np.fromiter((self._in_bucket(v) for v in col), dtype=bool, count=len(col))
