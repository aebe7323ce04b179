"""Executable spec of the elastic resharding protocol (pod churn invariants).

``petastorm_tpu_torch/elastic`` lets hosts join and leave mid-epoch: membership is
lease-based, row-group ownership is a pure function of ``(seed, epoch,
member set)`` stamped with a **generation** number, and in-flight row groups
follow dispatch-id ownership — a departed host's claimed-but-unfinished
groups move only after its lease expires, and a commit marker makes delivery
exclusive. This module states that design as an explicit-state transition
system small enough to check exhaustively, as ``spec.py`` does for the
supervision protocol and ``serve_spec.py`` for the serve fan-out. Twin of
``petastorm_tpu/analysis/protocol/elastic_spec.py``.

Model scope:

* time is abstracted to structure: a lease expiry is a *transition* that is
  enabled once a host crashed (never before — that is exactly what the
  ``reassign_before_expiry`` mutation breaks);
* the shard map is abstracted to ``members[(item + generation) % len]`` —
  any deterministic function of (generation member set) exercises the same
  interleavings as the real rendezvous hash;
* a resharding is enabled whenever the alive set drifted from the current
  generation's member set; crashes and joins come from small budgets.

Checked invariants (catalog order; ``docs/protocol.md``):

* ``exactly_once_coverage`` — no row group is ever delivered twice
  (safety), and at quiescence none was marked done without a delivery;
* ``handoff_after_lease_expiry`` — no row group stays claimed by a host
  whose lease already expired;
* ``generation_monotonic`` — the generation number never regresses;
* ``epoch_termination`` — at quiescence with at least one surviving host,
  every row group has been delivered (join/leave cannot wedge the epoch).

Mutations re-introduce one defect each so the checker's teeth are testable:
``reassign_before_expiry`` (a live host's claims are released for adoption
before its lease expires — the classic double-read), ``skip_done_check``
(claims do not consult the commit scoreboard — re-delivery of finished
groups), ``drop_on_expire`` (a dead host's claims are marked done instead
of re-queued — silent data loss), ``generation_rollback`` (a resharding
reuses generation 0 — maps can regress and hosts disagree forever).
"""

from __future__ import annotations

import collections
import random
import time

# host statuses
OUT, ALIVE, CRASHED, GONE = 0, 1, 2, 3

#: the checked invariants, in catalog order (docs/protocol.md)
INVARIANTS = (
    'exactly_once_coverage',
    'handoff_after_lease_expiry',
    'generation_monotonic',
    'epoch_termination',
)

#: seedable spec defects proving the checker has teeth
MUTATIONS = (
    'reassign_before_expiry',
    'skip_done_check',
    'drop_on_expire',
    'generation_rollback',
)

# state tuple indices
GEN, GENSET, HOSTS, ITEMS, GHOSTS, FLAGS, CRASHES_LEFT, JOINS_LEFT = range(8)

# flags bitmask
F_GEN_REGRESS = 1

# item cell encoding, for cfg.hosts == H:
#   PEND (-1)      not yet claimed
#   h in [0, H)    claimed by host h, no delivery yet
#   H              done: delivered exactly once
#   H+1            done WITHOUT a delivery (mutant: dropped)
#   H+2            delivered twice (violation sink)
#   H+3+h          claimed by host h while a completed delivery already
#                  exists (mutant paths; delivering from here is a double)
PEND = -1


class ElasticSpecConfig(object):
    """Small-scope configuration.

    :param hosts: total host slots (identities 0..hosts-1)
    :param items: row groups in the epoch
    :param initial_alive: hosts alive (and in generation 1) at time zero
    :param crashes: crash-event budget over the run
    :param joins: join-event budget (hosts beyond the initial set)
    :param mutation: one of :data:`MUTATIONS`, or None for the real protocol
    """

    __slots__ = ('hosts', 'items', 'initial_alive', 'crashes', 'joins',
                 'mutation')

    def __init__(self, hosts=3, items=3, initial_alive=2, crashes=1, joins=1,
                 mutation=None):
        if hosts < 1 or items < 1 or initial_alive < 1:
            raise ValueError('empty scope parameter')
        if initial_alive > hosts:
            raise ValueError('initial_alive {} exceeds hosts {}'.format(
                initial_alive, hosts))
        if crashes < 0 or joins < 0:
            raise ValueError('negative event budget')
        if mutation is not None and mutation not in MUTATIONS:
            raise ValueError('unknown mutation {!r} (expected one of {})'.format(
                mutation, MUTATIONS))
        self.hosts = hosts
        self.items = items
        self.initial_alive = initial_alive
        self.crashes = crashes
        self.joins = joins
        self.mutation = mutation

    def describe(self):
        return ('hosts={} items={} initial_alive={} crashes={} joins={}{}'
                .format(self.hosts, self.items, self.initial_alive,
                        self.crashes, self.joins,
                        ' mutation={}'.format(self.mutation)
                        if self.mutation else ''))


def initial_state(cfg):
    hosts = tuple(ALIVE if h < cfg.initial_alive else OUT
                  for h in range(cfg.hosts))
    genset = tuple(range(cfg.initial_alive))
    return (1, genset, hosts, (PEND,) * cfg.items, (-1,) * cfg.items, 0,
            cfg.crashes, cfg.joins)


def canonicalize(state):
    """Hosts are NOT interchangeable (the shard map keys on identity), so
    canonical form is the state itself."""
    return state


def _owner(item, state):
    """The abstract shard map: deterministic in (generation, member set)."""
    genset = state[GENSET]
    return genset[(item + state[GEN]) % len(genset)]


def _done_value(cfg):
    return cfg.hosts


def _claim_value(cell, cfg):
    """The claiming host when ``cell`` is a claim, else None."""
    if 0 <= cell < cfg.hosts:
        return cell
    if cell >= cfg.hosts + 3:
        return cell - (cfg.hosts + 3)
    return None


def _set_item(state, i, value):
    items = state[ITEMS][:i] + (value,) + state[ITEMS][i + 1:]
    return state[:ITEMS] + (items,) + state[ITEMS + 1:]


def _set_ghost(state, i, value):
    ghosts = state[GHOSTS][:i] + (value,) + state[GHOSTS][i + 1:]
    return state[:GHOSTS] + (ghosts,) + state[GHOSTS + 1:]


def _set_host(state, h, status):
    hosts = state[HOSTS][:h] + (status,) + state[HOSTS][h + 1:]
    return state[:HOSTS] + (hosts,) + state[HOSTS + 1:]


def successors(state, cfg):
    """All enabled transitions as (label, canonical next state) pairs."""
    out = []
    H = cfg.hosts
    DONE, DROPPED, DOUBLE = H, H + 1, H + 2
    hosts = state[HOSTS]
    items = state[ITEMS]
    ghosts = state[GHOSTS]
    alive = tuple(h for h in range(H) if hosts[h] == ALIVE)

    for h in alive:
        in_gen = h in state[GENSET]
        for i, cell in enumerate(items):
            # claim: the current-generation owner takes a pending group
            if in_gen and cell == PEND and _owner(i, state) == h:
                out.append((('claim', h, i), _set_item(state, i, h)))
            # the skip_done_check defect: claims ignore the commit
            # scoreboard, so a finished group can be taken again
            if in_gen and cfg.mutation == 'skip_done_check' and cell == DONE \
                    and _owner(i, state) == h:
                out.append((('claim', h, i), _set_item(state, i, H + 3 + h)))
            # deliver: the claiming host finishes its in-flight group
            if cell == h:
                out.append((('deliver', h, i), _set_item(state, i, DONE)))
            if cell == H + 3 + h:
                out.append((('deliver', h, i), _set_item(state, i, DOUBLE)))
            # ghost delivery (reassign_before_expiry only): the host whose
            # claim was wrongly released still finishes its read
            if ghosts[i] == h:
                if cell == DONE:
                    ns = _set_item(state, i, DOUBLE)
                elif cell == PEND:
                    ns = _set_item(state, i, DONE)
                else:
                    holder = _claim_value(cell, cfg)
                    if holder is not None:
                        # the group stays claimed, but a completed delivery
                        # now exists: the holder's own finish doubles it
                        ns = _set_item(state, i, H + 3 + holder)
                    else:
                        ns = _set_item(state, i, DOUBLE)
                out.append((('ghost_deliver', h, i), _set_ghost(ns, i, -1)))

    # crash: a live host dies; its lease has NOT expired yet, so its claims
    # stay pinned (nobody may adopt them)
    if state[CRASHES_LEFT] > 0:
        for h in alive:
            ns = _set_host(state, h, CRASHED)
            ns = ns[:CRASHES_LEFT] + (state[CRASHES_LEFT] - 1,) \
                + ns[CRASHES_LEFT + 1:]
            out.append((('crash', h), ns))

    # lease expiry: a crashed host's claims return to the pool (that is the
    # exactly-once handoff point); with drop_on_expire they are wrongly
    # marked done instead
    for h in range(H):
        if hosts[h] == CRASHED:
            ns = _set_host(state, h, GONE)
            for i, cell in enumerate(items):
                if cell == h:
                    repl = DROPPED if cfg.mutation == 'drop_on_expire' else PEND
                    ns = _set_item(ns, i, repl)
                elif cell == H + 3 + h:
                    # the claim evaporates; the earlier delivery stands
                    ns = _set_item(ns, i, DONE)
            out.append((('expire', h), ns))
        # the reassign_before_expiry defect: the expiry action fires on a
        # host that is still ALIVE — its claims are released for adoption
        # while it keeps processing them (ghost delivery above)
        if cfg.mutation == 'reassign_before_expiry' and hosts[h] == ALIVE \
                and any(c == h for c in items):
            ns = state
            for i, cell in enumerate(items):
                if cell == h:
                    ns = _set_item(ns, i, PEND)
                    ns = _set_ghost(ns, i, h)
            out.append((('expire', h), ns))

    # join: a new host comes up and starts heartbeating
    if state[JOINS_LEFT] > 0:
        for h in range(H):
            if hosts[h] == OUT:
                ns = _set_host(state, h, ALIVE)
                ns = ns[:JOINS_LEFT] + (state[JOINS_LEFT] - 1,)
                out.append((('join', h), ns))

    # reshard: the alive set drifted from the current generation's member
    # set — advance the generation and re-pin the map to the alive set
    if alive and alive != state[GENSET]:
        new_gen = 0 if cfg.mutation == 'generation_rollback' else state[GEN] + 1
        flags = state[FLAGS]
        if new_gen <= state[GEN]:
            flags |= F_GEN_REGRESS
        ns = (new_gen, alive) + state[HOSTS:FLAGS] + (flags,) \
            + state[FLAGS + 1:]
        out.append((('reshard', new_gen, alive), ns))

    return [(label, canonicalize(ns)) for label, ns in out]


def check_state(state, cfg):
    """First violated safety invariant, or None."""
    H = cfg.hosts
    if any(cell == H + 2 for cell in state[ITEMS]):
        return 'exactly_once_coverage'
    for cell in state[ITEMS]:
        holder = _claim_value(cell, cfg)
        if holder is not None and state[HOSTS][holder] == GONE:
            return 'handoff_after_lease_expiry'
    if state[FLAGS] & F_GEN_REGRESS:
        return 'generation_monotonic'
    return None


def check_terminal(state, cfg):
    """Liveness at quiescence: with at least one surviving host, the epoch
    must have terminated with every row group delivered exactly once. A pod
    with NO survivors is vacuously fine (there is nobody left to finish)."""
    H = cfg.hosts
    if not any(s == ALIVE for s in state[HOSTS]):
        return None
    if any(cell == H + 1 for cell in state[ITEMS]):
        return 'exactly_once_coverage'     # done-without-delivery: dropped
    if any(cell != H for cell in state[ITEMS]):
        return 'epoch_termination'
    return None


class ElasticCheckResult(object):
    __slots__ = ('config', 'exhausted', 'states', 'transitions', 'depth',
                 'elapsed_s', 'violation', 'trace', 'terminal_states')

    def __init__(self, config):
        self.config = config
        self.exhausted = False
        self.states = 0
        self.transitions = 0
        self.depth = 0
        self.elapsed_s = 0.0
        self.violation = None
        self.trace = None
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
                'trace': [repr(l) for l in self.trace] if self.trace else None}


def check(cfg, budget_s=None, max_states=None):
    """Exhaustive BFS over every interleaving of the elastic pod system.
    BFS order makes the first counterexample length-minimal."""
    result = ElasticCheckResult(cfg)
    t0 = time.monotonic()
    init = canonicalize(initial_state(cfg))
    parents = {init: None}
    frontier = collections.deque([(init, 0)])
    result.states = 1
    violation, violating = check_state(init, cfg), None
    if violation:
        violating = init
    popped = 0
    while frontier and violation is None:
        state, depth = frontier.popleft()
        popped += 1
        result.depth = max(result.depth, depth)
        succ = successors(state, cfg)
        result.transitions += len(succ)
        if not succ:
            result.terminal_states += 1
            violation = check_terminal(state, cfg)
            if violation:
                violating = state
                break
        for label, ns in succ:
            if ns in parents:
                continue
            parents[ns] = (state, label)
            result.states += 1
            v = check_state(ns, cfg)
            if v is not None:
                violation, violating = v, ns
                break
            frontier.append((ns, depth + 1))
        if violation is None and popped % 2048 == 0:
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
        trace = []
        s = violating
        while parents[s] is not None:
            s, label = parents[s]
            trace.append(label)
        trace.reverse()
        result.trace = trace
    return result


def random_walk(cfg, seed, max_steps=200):
    """One seeded schedule through the system: the trace walked and whether
    it ended in a violating state. Drives the monitor-conformance fuzz in
    ``tests/test_elastic.py``."""
    rng = random.Random(seed)
    state = initial_state(cfg)
    trace = []
    violation = check_state(state, cfg)
    for _ in range(max_steps):
        if violation is not None:
            break
        succ = successors(state, cfg)
        if not succ:
            violation = check_terminal(state, cfg)
            break
        label, state = succ[rng.randrange(len(succ))]
        trace.append(label)
        violation = check_state(state, cfg)
    return trace, violation


def replay_into_monitor(trace, monitor):
    """Replay a spec trace through an :class:`~petastorm_tpu_torch.analysis.
    protocol.monitor.ElasticMonitor` — the event-projection glue that keeps
    the runtime monitor honest against the spec. Healthy traces must pass;
    mutant traces that reach an event-visible defect must raise
    :class:`~petastorm_tpu_torch.errors.ProtocolViolation`."""
    for label in trace:
        kind = label[0]
        if kind == 'claim':
            monitor.on_claim(label[1], label[2])
        elif kind in ('deliver', 'ghost_deliver'):
            monitor.on_deliver(label[1], label[2])
        elif kind == 'expire':
            monitor.on_lease_expire(label[1])
        elif kind == 'join':
            monitor.on_join(label[1])
        elif kind == 'reshard':
            monitor.on_reshard(label[1], label[2])
        # 'crash' has no consumer-visible event: the lease just stops renewing


#: the tier-1 default scope (tests/test_elastic.py gates exhaustion + a
#: state floor on it, like the supervision and serve scopes)
DEFAULT_ELASTIC_SCOPE = dict(hosts=4, items=4, initial_alive=2, crashes=2,
                             joins=2)

#: the default scope must explore at least this many canonical states — the
#: regression tripwire against accidental transition pruning
DEFAULT_ELASTIC_STATE_FLOOR = 100_000

__all__ = ['DEFAULT_ELASTIC_SCOPE', 'DEFAULT_ELASTIC_STATE_FLOOR',
           'ElasticCheckResult', 'ElasticSpecConfig', 'INVARIANTS',
           'MUTATIONS', 'canonicalize', 'check', 'check_state',
           'check_terminal', 'initial_state', 'random_walk',
           'replay_into_monitor', 'successors']
