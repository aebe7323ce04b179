"""PT1200 — elastic shard maps must be deterministic.

The whole elastic-sharding design rests on one property: every host, given
the same ``(seed, epoch, member set)``, computes the SAME shard map without
talking to anyone (``docs/parallelism.md``, "Elastic pod sharding").  There
is no leader to arbitrate a disagreement — two hosts that derive different
maps for the same generation silently double-read or drop row groups, and
nothing downstream can detect it.  Determinism is therefore not a style
preference in :mod:`petastorm_tpu_torch.elastic.shardmap`; it is the correctness
argument, and its failure modes are lexically checkable:

* **wall-clock reads** (``time.time()``, ``datetime.now()``, …) — two hosts
  never read the same clock, so any clock-derived value diverges the maps;
* **unseeded randomness** — module-global RNG calls (``random.random()``,
  ``np.random.shuffle(...)``) and RNG constructors without an explicit seed
  (``default_rng()``, ``Random()``, ``RandomState(None)``) give each host a
  private stream.  Seeded constructors are fine: deriving the permutation
  from ``default_rng(stable_hash(...))`` is exactly the intended pattern;
* **set-iteration-order dependence** — iterating a ``set``/``frozenset``
  (or materializing one with ``list(set(...))``) bakes hash-table order
  into the map, which varies across processes under hash randomization.
  Wrap the set in ``sorted(...)`` to fix an order first.

The rule scopes to the shard-map module only: membership tracking
legitimately reads wall clocks (lease freshness IS a clock comparison) and
the coordinator stamps telemetry — the purity requirement applies to the
one module whose outputs every host must agree on bit-for-bit.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import (Checker, add_parents, attr_chain,
                                         walk_functions)

#: dotted call chains that read a wall clock
_WALL_CLOCK = frozenset({
    'time.time', 'time.time_ns', 'time.monotonic', 'time.monotonic_ns',
    'time.perf_counter', 'time.perf_counter_ns', 'time.clock_gettime',
    'datetime.now', 'datetime.utcnow', 'datetime.today',
    'datetime.datetime.now', 'datetime.datetime.utcnow',
    'datetime.datetime.today', 'datetime.date.today', 'date.today',
})

#: module-global RNG entry points: a stream shared per-process, never per-pod
_GLOBAL_RNG = frozenset({
    'random.random', 'random.randint', 'random.randrange', 'random.choice',
    'random.choices', 'random.sample', 'random.shuffle', 'random.uniform',
    'random.seed', 'random.getrandbits',
})

#: np.random module-level functions are the legacy global stream
_NP_RANDOM_PREFIXES = ('np.random.', 'numpy.random.')

#: RNG constructors that take the seed as their first argument
_SEEDED_CTORS = frozenset({'default_rng', 'Random', 'RandomState',
                           'SystemRandom', 'Generator', 'PCG64', 'Philox'})

#: np.random constructors reachable through the module chain
_NP_CTOR_CHAINS = frozenset({
    'np.random.default_rng', 'numpy.random.default_rng',
    'np.random.RandomState', 'numpy.random.RandomState',
    'np.random.Generator', 'numpy.random.Generator',
    'random.Random', 'random.SystemRandom',
})

#: builtins that materialize an iteration over their (set-typed) argument in
#: hash order (min/max/sum stay allowed: their values are order-independent)
_ORDER_SENSITIVE_WRAPPERS = frozenset({'list', 'tuple', 'enumerate', 'iter'})


def _call_chain(call):
    """Dotted chain of a Call's func ('np.random.default_rng') or None."""
    return attr_chain(call.func)


def _tail(chain):
    return chain.rsplit('.', 1)[-1] if chain else None


def _is_set_expr(node):
    """Does ``node`` syntactically produce a set/frozenset?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        chain = _call_chain(node)
        if chain in ('set', 'frozenset'):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        # set algebra propagates set-ness from either operand
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _unseeded_ctor(call, chain):
    """A known RNG constructor called with no seed (or an explicit None)."""
    tail = _tail(chain)
    if tail not in _SEEDED_CTORS:
        return False
    if chain not in _NP_CTOR_CHAINS and tail not in ('default_rng',):
        # bare Random()/RandomState() names only count when imported from a
        # random module — we can't resolve imports, so accept the tail match
        # for the unambiguous constructor names and the full-chain forms.
        if tail not in ('Random', 'RandomState', 'SystemRandom'):
            return False
    if not call.args and not call.keywords:
        return True
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is None:
        return True
    for kw in call.keywords:
        if kw.arg == 'seed' and isinstance(kw.value, ast.Constant) \
                and kw.value.value is None:
            return True
    return False


class ElasticDeterminismChecker(Checker):
    code = 'PT1200'
    name = 'elastic-shardmap-determinism'
    description = ('shard-map construction must be a pure function of '
                   '(seed, epoch, members): wall-clock reads, unseeded '
                   'randomness and set-iteration-order dependence diverge '
                   'the maps across hosts')
    scope = ('*elastic/shardmap*.py',)

    def check(self, src):
        add_parents(src.tree)
        for func, _cls in walk_functions(src.tree):
            for node in ast.walk(func):
                if isinstance(node, ast.Call):
                    for finding in self._check_call(src, node):
                        yield finding
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    if _is_set_expr(node.iter):
                        yield self.finding(
                            src, node.lineno,
                            'iterating a set directly: hash order differs '
                            'across processes, so the derived shard map '
                            'would too — wrap the set in sorted(...)')
                elif isinstance(node, ast.comprehension):
                    if _is_set_expr(node.iter):
                        yield self.finding(
                            src, node.iter.lineno,
                            'comprehension iterates a set directly: hash '
                            'order differs across processes — wrap the set '
                            'in sorted(...)')

    def _check_call(self, src, call):
        chain = _call_chain(call)
        if chain is None:
            return
        if chain in _WALL_CLOCK:
            yield self.finding(
                src, call.lineno,
                '{}() reads a wall clock: no two hosts see the same value, '
                'so clock-derived shard maps diverge — derive everything '
                'from (seed, epoch, members)'.format(chain))
            return
        if chain in _GLOBAL_RNG or any(
                chain.startswith(p) and _tail(chain) not in _SEEDED_CTORS
                for p in _NP_RANDOM_PREFIXES):
            yield self.finding(
                src, call.lineno,
                '{}() draws from the process-global RNG stream: each host '
                'gets a private sequence — construct a generator seeded '
                'from stable_hash(seed, epoch, ...)'.format(chain))
            return
        if _unseeded_ctor(call, chain):
            yield self.finding(
                src, call.lineno,
                '{}() constructed without an explicit seed: the OS entropy '
                'default gives every host a different stream — pass a seed '
                'derived from stable_hash(...)'.format(chain))
            return
        tail = _tail(chain)
        if tail in _ORDER_SENSITIVE_WRAPPERS and call.args \
                and _is_set_expr(call.args[0]):
            yield self.finding(
                src, call.lineno,
                '{}(set(...)) bakes hash-table iteration order into the '
                'result: order varies across processes under hash '
                'randomization — use sorted(...) instead'.format(tail))
