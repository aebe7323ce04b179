"""The port's predicates (``petastorm_tpu_torch/predicates.py``) against the
JAX package's on the same seeded blocks: each predicate's ``do_include``
row by row, its ``do_include_batch`` mask (or its refusal), its
``native_clauses`` and the ``evaluate_predicate_mask`` contract, all held to
exact equality."""

import numpy as np
import pytest

import petastorm_tpu.predicates as jax_predicates
import petastorm_tpu_torch.predicates as predicates


def _block(seed=0, n=64):
    rng = np.random.default_rng(seed)
    ragged = np.empty(n, dtype=object)
    ragged[:] = [rng.integers(0, 10, int(rng.integers(0, 4))) for _ in range(n)]
    ragged[3] = None
    strings = np.empty(n, dtype=object)
    strings[:] = ['s{}'.format(v) for v in rng.integers(0, 6, n)]
    return {'i64': rng.integers(-50, 50, n).astype(np.int64),
            'i32': rng.integers(0, 20, n).astype(np.int32),
            'u8': rng.integers(0, 256, n).astype(np.uint8),
            'f64': np.where(rng.random(n) < 0.1, np.nan, rng.normal(0, 30, n)),
            'flag': rng.random(n) < 0.5,
            'name': strings,
            'uname': np.array(['u{}'.format(v) for v in rng.integers(0, 4, n)]),
            'tensor': rng.integers(0, 10, (n, 2, 3)).astype(np.int64),
            'ragged': ragged}


def _cases(mod):
    """Every predicate shape, built from ``mod`` (either package)."""
    class RowOverride(mod.in_set):
        def do_include(self, values):
            return values['i64'] > 0

    class BatchOverride(mod.in_range):
        def do_include_batch(self, block):
            return None

    class PlainSub(mod.in_set):
        pass

    class NegOverride(mod.in_negate):
        def do_include(self, values):
            return True

    return {
        'in_set-int': mod.in_set([1, -3, 7, 40], 'i64'),
        'in_set-float-operands': mod.in_set([1.0, 2.5, 7.0], 'i32'),
        'in_set-mixed-types': mod.in_set(['a', 1, 2], 'i64'),
        'in_set-bool': mod.in_set([True], 'flag'),
        'in_set-strings-object': mod.in_set(['s1', 's4'], 'name'),
        'in_set-strings-unicode': mod.in_set(['u0', 'u3'], 'uname'),
        'in_set-unsigned': mod.in_set([0, 255, 17, -1, 300], 'u8'),
        'in_range-closed': mod.in_range('i64', lo=-10, hi=20),
        'in_range-open': mod.in_range('i64', lo=-10, hi=20, lo_inclusive=False,
                                      hi_inclusive=False),
        'in_range-lo-only-float': mod.in_range('f64', lo=5.5),
        'in_range-hi-only': mod.in_range('i32', hi=7),
        'in_range-fractional-bound-int': mod.in_range('i64', lo=2.5),
        'in_range-out-of-type-bound': mod.in_range('u8', lo=-5, hi=1000),
        'in_intersection-tensor': mod.in_intersection([3, 9], 'tensor'),
        'in_intersection-ragged': mod.in_intersection([0, 7], 'ragged'),
        'in_intersection-mixed': mod.in_intersection(['x', 3], 'tensor'),
        'in_lambda': mod.in_lambda(['i64', 'i32'], lambda v: v['i64'] % 3 == v['i32'] % 3),
        'in_lambda-state': mod.in_lambda(['i32'], lambda v, st: v['i32'] in st, state={1, 2, 3}),
        'in_negate-set': mod.in_negate(mod.in_set([1, -3, 7], 'i64')),
        'in_negate-range': mod.in_negate(mod.in_range('f64', hi=0.0)),
        'in_negate-and': mod.in_negate(mod.in_reduce([mod.in_range('i64', lo=0),
                                                      mod.in_range('i32', hi=9)], all)),
        'in_negate-lambda': mod.in_negate(mod.in_lambda(['i64'], lambda v: v['i64'] > 3)),
        'in_reduce-all': mod.in_reduce([mod.in_range('i64', lo=-20),
                                        mod.in_set([1, 2, 3, 4, 5], 'i32')], all),
        'in_reduce-any': mod.in_reduce([mod.in_range('i64', lo=30),
                                        mod.in_set([1, 2], 'i32')], any),
        'in_reduce-sum': mod.in_reduce([mod.in_range('i64', lo=0),
                                        mod.in_range('i32', lo=10)], lambda bs: sum(bs) == 1),
        'in_reduce-nested': mod.in_reduce([mod.in_negate(mod.in_set([0], 'i32')),
                                           mod.in_reduce([mod.in_range('f64', lo=-5),
                                                          mod.in_range('f64', hi=5)], all)], all),
        'in_reduce-with-lambda': mod.in_reduce([mod.in_range('i64', lo=0),
                                                mod.in_lambda(['i32'], lambda v: v['i32'] > 4)],
                                               all),
        'split-0': mod.in_pseudorandom_split([0.3, 0.5, 0.2], 0, 'i64'),
        'split-1-strings': mod.in_pseudorandom_split([0.3, 0.5, 0.2], 1, 'name'),
        'split-2-floats': mod.in_pseudorandom_split([0.3, 0.5, 0.2], 2, 'f64'),
        'override-row': RowOverride([1], 'i64'),
        'override-batch': BatchOverride('i64', lo=0),
        'subclass-plain': PlainSub([1, 2, 3], 'i32'),
        'override-negate-wrapper': NegOverride(mod.in_set([1], 'i64')),
        'negate-over-override': mod.in_negate(RowOverride([1], 'i64')),
        'reduce-over-override': mod.in_reduce([RowOverride([1], 'i64')], all),
    }


CASES = sorted(_cases(predicates))


def _rows(block, fields):
    n = len(next(iter(block.values())))
    return [{f: block[f][i] for f in fields} for i in range(n)]


def _equal(a, b):
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('case', CASES)
def test_predicate_matches_jax_twin(case, seed):
    ours, theirs = _cases(predicates)[case], _cases(jax_predicates)[case]
    block = _block(seed)
    assert ours.get_fields() == theirs.get_fields()
    fields = sorted(ours.get_fields())
    rows = _rows(block, fields)
    assert [ours.do_include(r) for r in rows] == [theirs.do_include(r) for r in rows]
    assert _equal(ours.do_include_batch(dict(block)), theirs.do_include_batch(dict(block)))
    assert ours.native_clauses() == theirs.native_clauses()
    n = len(rows)
    assert _equal(predicates.evaluate_predicate_mask(ours, dict(block), n),
                  jax_predicates.evaluate_predicate_mask(theirs, dict(block), n))
    mask = predicates.evaluate_predicate_mask(ours, dict(block), n)
    if mask is not None and 'override' not in case:
        # a batch answer is the row answer (a subclass that overrides one of
        # the two changed its semantics: only the twins' agreement holds)
        assert mask.tolist() == [bool(ours.do_include(r)) for r in rows]


def test_native_clauses_decline_where_the_jax_ones_do():
    cases = _cases(predicates)
    declined = sorted(k for k, p in cases.items() if p.native_clauses() is None)
    assert declined == sorted(k for k, p in _cases(jax_predicates).items()
                              if p.native_clauses() is None)
    for name in ('override-row', 'override-batch', 'override-negate-wrapper',
                 'negate-over-override', 'reduce-over-override', 'in_negate-and',
                 'in_reduce-any', 'in_set-mixed-types', 'in_set-strings-object'):
        assert name in declined
    assert cases['subclass-plain'].native_clauses() is not None
    assert cases['in_reduce-all'].native_clauses() == [
        {'field': 'i64', 'op': 'range', 'lo': -20, 'hi': None, 'lo_incl': True,
         'hi_incl': True, 'negate': False},
        {'field': 'i32', 'op': 'in', 'values': [1, 2, 3, 4, 5], 'negate': False}]


@pytest.mark.parametrize('value', [0, 1, -7, 2 ** 40, 3.25, 'n01440764', b'\x00\xff', True,
                                   np.int32(12), np.float64(0.5), 'ünïcödé'])
def test_pseudorandom_split_buckets_equal_jax(value):
    fractions = [0.1, 0.2, 0.3, 0.4]
    for subset in range(len(fractions)):
        ours = predicates.in_pseudorandom_split(fractions, subset, 'x')
        theirs = jax_predicates.in_pseudorandom_split(fractions, subset, 'x')
        assert ours.do_include({'x': value}) == theirs.do_include({'x': value})
    # every value lands in exactly one subset of a full split
    assert sum(predicates.in_pseudorandom_split(fractions, s, 'x').do_include({'x': value})
               for s in range(len(fractions))) == 1


def test_pseudorandom_split_arguments_refused_like_jax():
    for mod in (predicates, jax_predicates):
        with pytest.raises(ValueError, match='out of range'):
            mod.in_pseudorandom_split([0.5, 0.5], 2, 'x')
        with pytest.raises(ValueError, match='sum to <= 1.0'):
            mod.in_pseudorandom_split([0.7, 0.5], 0, 'x')
        with pytest.raises(ValueError, match='at least one bound'):
            mod.in_range('x')


class _BadShape(object):
    """A duck-typed predicate whose batch path breaks the contract."""

    def __init__(self, mask):
        self._mask = mask

    def get_fields(self):
        return {'x'}

    def do_include_batch(self, block):
        return self._mask


@pytest.mark.parametrize('mask', [True, np.ones((4, 2), bool), np.ones(3, bool)],
                         ids=['scalar', '2-d', 'short'])
def test_evaluate_predicate_mask_contract_errors_equal_jax(mask):
    block = {'x': np.arange(4)}
    with pytest.raises(ValueError) as ours:
        predicates.evaluate_predicate_mask(_BadShape(mask), block, 4)
    with pytest.raises(ValueError) as theirs:
        jax_predicates.evaluate_predicate_mask(_BadShape(mask), block, 4)
    assert str(ours.value) == str(theirs.value)


def test_evaluate_predicate_mask_declines_without_a_batch_path():
    class RowOnly(object):
        def get_fields(self):
            return {'x'}

    block = {'x': np.arange(4)}
    assert predicates.evaluate_predicate_mask(RowOnly(), block, 4) is None
    assert predicates.evaluate_predicate_mask(_BadShape(None), block, 4) is None
    assert predicates.evaluate_predicate_mask(_BadShape([1, 0, 1, 0]), block, 4).dtype == bool
