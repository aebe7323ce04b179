"""Small-scope exhaustive model checker for the supervision protocol spec.

BFS over every interleaving of :mod:`spec`'s transition system for a small
configuration, with canonical state hashing (worker-slot symmetry reduction)
and counterexample trace minimization. BFS order makes the first trace to any
violation minimal in length; :func:`minimize_trace` then greedily drops events
that are not needed to reproduce it.

Twin of ``petastorm_tpu/analysis/protocol/modelcheck.py``. ``--serve``,
``--elastic`` and ``--fabric`` check the serve fan-out, elastic resharding
and chunk-fabric specs at their default scopes instead.

CLI::

    python -m petastorm_tpu_torch.analysis.protocol.modelcheck   # default scope
    python -m petastorm_tpu_torch.analysis.protocol.modelcheck --workers 3 --items 4 --crashes 2
    python -m petastorm_tpu_torch.analysis.protocol.modelcheck --mutate requeue_same_id
    python -m petastorm_tpu_torch.analysis.protocol.modelcheck --fabric --mutate no_fallback

Exit codes: 0 = exhausted, all invariants hold; 1 = violation found (the
minimized trace is printed); 2 = usage error; 3 = budget exhausted before the
state space was (the verdict is then only as good as the explored prefix).

The tier-1 test (``tests/test_protocol.py``) runs the default scope with an
explicit wall-clock budget AND a state-count floor
(:data:`DEFAULT_STATE_FLOOR`), so the exhaustive search cannot silently
degenerate into checking a trivial space.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from petastorm_tpu_torch.analysis.protocol import spec as S

#: the default small scope: >= 3 workers, >= 4 items, >= 2 injected crashes
DEFAULT_SCOPE = dict(workers=3, items=4, crashes=2, retries=1, errors=0,
                     policy='skip', publish=True)

#: the default scope must explore at least this many canonical states — a
#: regression tripwire against accidental transition pruning (the real count
#: sits well above; see tests/test_protocol.py)
DEFAULT_STATE_FLOOR = 500_000

#: a second, error-heavy scope exercising the retry/quarantine lattice the
#: crash-only default cannot reach
ERROR_SCOPE = dict(workers=2, items=2, crashes=1, retries=1, errors=2,
                   policy='skip', publish=True)


class CheckResult(object):
    """Outcome of one model-checking run."""

    __slots__ = ('config', 'exhausted', 'states', 'transitions', 'depth',
                 'elapsed_s', 'violation', 'trace', 'terminal_states')

    def __init__(self, config):
        self.config = config
        self.exhausted = False
        self.states = 0
        self.transitions = 0
        self.depth = 0
        self.elapsed_s = 0.0
        self.violation = None   # invariant name, or None
        self.trace = None       # minimized label sequence, or None
        self.terminal_states = 0

    @property
    def ok(self):
        return self.exhausted and self.violation is None

    def to_dict(self):
        return {'config': self.config.describe(), 'exhausted': self.exhausted,
                'states': self.states, 'transitions': self.transitions,
                'depth': self.depth, 'elapsed_s': round(self.elapsed_s, 3),
                'terminal_states': self.terminal_states,
                'violation': self.violation,
                'trace': [format_label(l) for l in self.trace] if self.trace else None}


def check(cfg, budget_s=None, max_states=None):
    """Exhaustively explore ``cfg``'s state space breadth-first.

    Stops at the first invariant violation (returning its minimized trace), at
    ``budget_s`` wall seconds / ``max_states`` states (``exhausted=False``), or
    when the frontier empties (``exhausted=True``).
    """
    result = CheckResult(cfg)
    t0 = time.monotonic()
    init = S.canonicalize(S.initial_state(cfg), cfg)
    parents = {init: None}  # canonical state -> (parent_state, label) | None
    frontier = collections.deque([(init, 0)])
    result.states = 1

    violation = S.check_state(init, cfg)
    violating = init if violation else None
    popped = 0
    while frontier and violation is None:
        state, depth = frontier.popleft()
        popped += 1
        result.depth = max(result.depth, depth)
        succ = S.successors(state, cfg)
        result.transitions += len(succ)
        if not succ:
            result.terminal_states += 1
            violation = S.check_terminal(state, cfg)
            if violation:
                violating = state
                break
        for label, ns in succ:
            if ns in parents:
                continue
            parents[ns] = (state, label)
            result.states += 1
            v = S.check_state(ns, cfg)
            if v is not None:
                violation, violating = v, ns
                break
            frontier.append((ns, depth + 1))
        if violation is None and popped % 2048 == 0:
            # budget checks keyed on POPPED states: a long all-duplicates
            # stretch must still honor the wall clock
            if budget_s is not None and time.monotonic() - t0 > budget_s:
                break
            if max_states is not None and result.states >= max_states:
                break
    else:
        if violation is None:
            result.exhausted = True

    result.elapsed_s = time.monotonic() - t0
    if violation is not None:
        result.violation = violation
        trace = _reconstruct(parents, violating)
        result.trace = minimize_trace(cfg, trace, violation)
    return result


def _reconstruct(parents, state):
    trace = []
    while parents[state] is not None:
        state, label = parents[state]
        trace.append(label)
    trace.reverse()
    return trace


def _trace_violates(cfg, trace, violation):
    """Does ``trace`` replay to a state exhibiting ``violation``? Safety
    violations are checked on every prefix state; the termination violation on
    the final state (which must also be quiescent)."""
    state = S.canonicalize(S.initial_state(cfg), cfg)
    for label in trace:
        state = S.apply_label(state, cfg, label)
        if state is None:
            return False
        if S.check_state(state, cfg) == violation:
            return True
    if violation == 'epoch_termination':
        return (not S.successors(state, cfg)
                and S.check_terminal(state, cfg) == violation)
    return False


def minimize_trace(cfg, trace, violation):
    """Greedy delta-minimization: drop any event whose removal leaves a valid
    trace still exhibiting ``violation``. BFS traces are already length-minimal
    to their particular state; this additionally strips steps that only padded
    the path (e.g. unrelated workers' progress)."""
    trace = list(trace)
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(trace):
            candidate = trace[:i] + trace[i + 1:]
            if _trace_violates(cfg, candidate, violation):
                trace = candidate
                changed = True
            else:
                i += 1
    return trace


def random_walk(cfg, seed, max_steps=500):
    """One seeded random schedule through the spec, over RAW (non-canonical)
    successors so dispatch ids and slot indices stay globally stable — the
    form :func:`spec.replay_into_monitor` needs. Returns ``(trace,
    final_state)``; used by the randomized-schedule conformance tests."""
    import random
    rng = random.Random(seed)
    state = S.initial_state(cfg)
    trace = []
    for _ in range(max_steps):
        succ = S.successors(state, cfg, canonical=False)
        if not succ:
            break
        label, state = succ[rng.randrange(len(succ))]
        trace.append(label)
    return trace, state


def format_label(label):
    """One human-readable line per transition, for counterexample printing."""
    kind = label[0]
    if kind == 'dispatch':
        return 'dispatch item={} as d={} -> worker {}'.format(label[2], label[1], label[3])
    if kind == 'pickup':
        return 'worker {} picks up d={} (claim enqueued)'.format(label[1], label[2])
    if kind == 'publish':
        return 'worker {} publishes payload for d={}'.format(label[1], label[2])
    if kind == 'worker_done':
        return 'worker {} sends done for d={}'.format(label[1], label[2])
    if kind == 'worker_error':
        return 'worker {} sends error for d={}'.format(label[1], label[2])
    if kind == 'crash':
        return 'worker {} CRASHES (pipe lost, channel survives)'.format(label[1])
    if kind == 'finish_death':
        return 'supervisor finishes worker {} death (orphan={})'.format(label[1], label[2])
    if kind == 'sweep':
        parts = ('{} d={}{}'.format(a, d, ' -> d={} w{}'.format(nd, w) if a == 'requeue' else '')
                 for a, d, nd, w in label[1])
        return 'quiet-window sweep: ' + ', '.join(parts)
    if kind.startswith('consume_'):
        rest = kind[len('consume_'):]
        extra = ''
        if rest == 'data':
            extra = ' (live)' if label[3] else ' (stale, dropped)'
        elif rest == 'error_requeue':
            extra = ' -> requeued as d={} to worker {}'.format(label[3], label[4])
        return 'consumer pops {} for d={} from worker {}{}'.format(
            rest.split('_')[0] if rest not in ('claim',) else 'claim',
            label[2], label[1], extra)
    if kind.startswith('orphan_'):
        rest = kind[len('orphan_'):]
        if rest == 'requeue':
            return 'orphan d={} requeued as d={} to worker {}'.format(
                label[1], label[2], label[3])
        return 'orphan d={}: {}'.format(label[1], rest)
    return repr(label)


def format_trace(result):
    lines = ['counterexample ({} steps, invariant: {}):'.format(
        len(result.trace), result.violation)]
    lines.extend('  {:>3}. {}'.format(i + 1, format_label(label))
                 for i, label in enumerate(result.trace))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.analysis.protocol.modelcheck',
        description='Exhaustive small-scope model checker for the worker-pool '
                    'supervision protocol (docs/protocol.md). Exit codes: 0 '
                    'exhausted+clean, 1 violation (minimized trace printed), '
                    '2 usage error, 3 budget ran out before exhaustion.')
    parser.add_argument('--serve', action='store_true',
                        help='check the serve fan-out protocol '
                             '(multi-consumer broadcast-ring invariants, '
                             'docs/serve.md) instead of the supervision '
                             'protocol; --mutate then takes a serve mutation')
    parser.add_argument('--elastic', action='store_true',
                        help='check the elastic resharding protocol (pod '
                             'host join/leave mid-epoch, exactly-once '
                             'handoff; docs/parallelism.md) instead of the '
                             'supervision protocol; --mutate then takes an '
                             'elastic mutation')
    parser.add_argument('--fabric', action='store_true',
                        help='check the chunk-fabric transfer protocol '
                             '(peer-first fetch, circuit breakers, verified '
                             'population, guaranteed fallback; '
                             'docs/fabric.md) instead of the supervision '
                             'protocol; --mutate then takes a fabric '
                             'mutation')
    parser.add_argument('--workers', type=int, default=DEFAULT_SCOPE['workers'])
    parser.add_argument('--items', type=int, default=DEFAULT_SCOPE['items'])
    parser.add_argument('--crashes', type=int, default=DEFAULT_SCOPE['crashes'])
    parser.add_argument('--retries', type=int, default=DEFAULT_SCOPE['retries'])
    parser.add_argument('--errors', type=int, default=DEFAULT_SCOPE['errors'])
    parser.add_argument('--policy', choices=('raise', 'skip', 'retry'),
                        default=DEFAULT_SCOPE['policy'])
    parser.add_argument('--no-publish', action='store_true',
                        help='do not model the payload message as a separate '
                             'step (smaller space, weaker delivery invariant)')
    from petastorm_tpu_torch.analysis.protocol import elastic_spec as EL
    from petastorm_tpu_torch.analysis.protocol import fabric_spec as FB
    from petastorm_tpu_torch.analysis.protocol import serve_spec as SV
    parser.add_argument('--mutate',
                        choices=S.MUTATIONS + SV.MUTATIONS + EL.MUTATIONS + FB.MUTATIONS,
                        default=None,
                        help='seed one protocol defect; the checker must then '
                             'produce a counterexample')
    parser.add_argument('--budget-s', type=float, default=600.0,
                        help='wall-clock exploration budget (default 600)')
    parser.add_argument('--max-states', type=int, default=None)
    parser.add_argument('--min-states', type=int, default=None,
                        help='fail (exit 3) when exhaustion explored fewer '
                             'canonical states than this floor')
    parser.add_argument('--json', action='store_true')
    try:
        args = parser.parse_args(argv)
        if sum((args.serve, args.elastic, args.fabric)) > 1:
            raise ValueError('--serve, --elastic, and --fabric are mutually '
                             'exclusive')
        if args.serve:
            cfg = SV.ServeSpecConfig(mutation=args.mutate,
                                     **SV.DEFAULT_SERVE_SCOPE)
        elif args.elastic:
            cfg = EL.ElasticSpecConfig(mutation=args.mutate,
                                       **EL.DEFAULT_ELASTIC_SCOPE)
        elif args.fabric:
            cfg = FB.FabricSpecConfig(mutation=args.mutate, **FB.DEFAULT_FABRIC_SCOPE)
        else:
            cfg = S.SpecConfig(workers=args.workers, items=args.items,
                               crashes=args.crashes, retries=args.retries,
                               errors=args.errors, policy=args.policy,
                               publish=not args.no_publish, mutation=args.mutate)
    except (SystemExit, ValueError) as e:
        if isinstance(e, SystemExit):
            return 2 if e.code else 0
        print('error: {}'.format(e), file=sys.stderr)
        return 2

    if args.serve or args.elastic or args.fabric:
        module = SV if args.serve else (EL if args.elastic else FB)
        result = module.check(cfg, budget_s=args.budget_s,
                              max_states=args.max_states)
        plane = 'serve' if args.serve else ('elastic' if args.elastic else 'fabric')
        if args.json:
            print(json.dumps(result.to_dict(), indent=2))
        else:
            print('{} scope: {}'.format(plane, cfg.describe()))
            print('explored {} canonical states, {} transitions, depth {}, '
                  '{} terminal, in {:.2f}s'.format(
                      result.states, result.transitions, result.depth,
                      result.terminal_states, result.elapsed_s))
            if result.violation:
                print('counterexample ({} steps, invariant: {}):'.format(
                    len(result.trace), result.violation))
                for i, label in enumerate(result.trace):
                    print('  {:>3}. {!r}'.format(i + 1, label))
            elif result.exhausted:
                print('exhausted: all invariants hold ({})'.format(
                    ', '.join(module.INVARIANTS)))
            else:
                print('NOT exhausted: budget ran out — verdict covers only '
                      'the explored prefix')
        if result.violation:
            return 1
        if not result.exhausted:
            return 3
        if args.min_states is not None and result.states < args.min_states:
            print('state count {} below the declared floor {}'.format(
                result.states, args.min_states), file=sys.stderr)
            return 3
        return 0

    result = check(cfg, budget_s=args.budget_s, max_states=args.max_states)
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
    else:
        print('scope: {}'.format(cfg.describe()))
        print('explored {} canonical states, {} transitions, depth {}, '
              '{} terminal, in {:.2f}s'.format(
                  result.states, result.transitions, result.depth,
                  result.terminal_states, result.elapsed_s))
        if result.violation:
            print(format_trace(result))
        elif result.exhausted:
            print('exhausted: all invariants hold ({})'.format(', '.join(S.INVARIANTS)))
        else:
            print('NOT exhausted: budget ran out — verdict covers only the '
                  'explored prefix')
    if result.violation:
        return 1
    if not result.exhausted:
        return 3
    if args.min_states is not None and result.states < args.min_states:
        print('state count {} below the declared floor {} — the search '
              'degenerated'.format(result.states, args.min_states), file=sys.stderr)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())
