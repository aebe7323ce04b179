"""PT1400 — sequence sampling/packing decisions must be deterministic.

The sequence data plane's acceptance bar (``docs/sequence.md``) is
bit-exact reproducibility under a fixed seed: the same seed must reproduce
the same mixture interleaving, the same bucket release order, and the same
packed batches — that is what makes a training run's data order a
checkpointable fact rather than an accident.  The lexically checkable ways
to lose it:

* **wall-clock reads** (``time.time()``, ``datetime.now()``, …) — a
  clock-derived sampling decision is different on every run;
* **module-global RNG draws** (``random.random()``, ``np.random.shuffle``)
  — the process-global stream is shared with whoever else imports
  ``random``, so a seed set elsewhere (or not at all) silently changes the
  data order;
* **RNG constructors without an explicit seed** (``default_rng()``,
  ``Random()``) — OS entropy gives every run a private stream.  Seeded
  constructors (``default_rng(seed)``) are exactly the intended pattern,
  including ``seed=None`` *variables* threaded from a user knob: the rule
  rejects only the lexically-unseeded forms.

The rule scopes to the modules that make sampling/ordering decisions
(mixture, bucketing, packing, the weighted base reader).  The
tail-following reader is deliberately OUT of scope: its poll cadence
legitimately reads clocks — IO pacing is not a sampling decision.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, add_parents, walk_functions
from petastorm_tpu_torch.analysis.elastic_lints import (_GLOBAL_RNG,
                                                  _NP_RANDOM_PREFIXES,
                                                  _SEEDED_CTORS, _WALL_CLOCK,
                                                  _call_chain, _tail,
                                                  _unseeded_ctor)


class SequenceDeterminismChecker(Checker):
    code = 'PT1400'
    name = 'sequence-sampling-determinism'
    description = ('mixture sampling, bucket release and packing decisions '
                   'must be reproducible under a fixed seed: wall-clock '
                   'reads, global-RNG draws and unseeded RNG constructors '
                   'make the data order an accident')
    scope = ('*sequence/mixture*.py', '*sequence/packing*.py',
             '*sequence/bucket*.py', '*weighted_sampling_reader*.py')

    def check(self, src):
        add_parents(src.tree)
        for func, _cls in walk_functions(src.tree):
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                for finding in self._check_call(src, node):
                    yield finding

    def _check_call(self, src, call):
        chain = _call_chain(call)
        if chain is None:
            return
        if chain in _WALL_CLOCK:
            yield self.finding(
                src, call.lineno,
                '{}() reads a wall clock inside sequence sampling/packing '
                'code: the decision differs on every run — derive it from '
                'the seeded stream or the data itself'.format(chain))
            return
        if chain in _GLOBAL_RNG or any(
                chain.startswith(p) and _tail(chain) not in _SEEDED_CTORS
                for p in _NP_RANDOM_PREFIXES):
            yield self.finding(
                src, call.lineno,
                '{}() draws from the process-global RNG stream: any other '
                'import of random/np.random perturbs the data order — use a '
                'generator constructed from the ctor seed'.format(chain))
            return
        if _unseeded_ctor(call, chain):
            yield self.finding(
                src, call.lineno,
                '{}() constructed without an explicit seed: OS entropy gives '
                'every run a different data order — thread the ctor seed '
                'through (seed=None from a user knob is fine; a lexically '
                'missing seed is not)'.format(chain))
