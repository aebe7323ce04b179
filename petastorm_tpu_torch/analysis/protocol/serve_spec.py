"""Executable spec of the serve fan-out protocol (multi-consumer invariants).

The broadcast ring (``native/shm_ring.cpp`` ``pstpu_bcast_*``) is what makes
the shared reader daemon (``docs/serve.md``) trustworthy: a published batch is
logically reference-counted across K attached consumers by *min-head
reclamation* — each consumer's cursor advance is its release, and a slot's
bytes are reclaimed when the slowest attached cursor passes them. This module
states that design as an explicit-state transition system small enough to
check exhaustively, as ``spec.py`` does for the supervision protocol. Twin
of ``petastorm_tpu/analysis/protocol/serve_spec.py``.

Model scope:

* messages are whole batches (the ring's byte arithmetic is abstracted to a
  capacity of ``ring_cap`` in-flight messages);
* joins happen at the producer's current position (the implementation grants
  slots daemon-side between writes — the ``join_stale_cursor`` mutation is
  exactly what that design rules out);
* eviction is *enabled* (not forced) whenever an attached consumer's lag
  exceeds ``lag_bound`` — time is abstracted to structure, as in ``spec.py``;
* an evicted slot stops constraining reclamation and must never be delivered
  to again (the seqlock validation in ``pstpu_bcast_read``).

Checked invariants (catalog order; ``docs/protocol.md``):

* ``released_exactly_once_per_consumer`` — no attached consumer instance is
  ever delivered the same batch twice;
* ``no_overwritten_read`` — no consumer is delivered a batch whose slot the
  producer had already reclaimed (a torn read);
* ``evicted_never_delivered`` — an evicted consumer receives nothing further;
* ``tenant_epoch_termination`` — at quiescence every still-attached consumer
  has received EXACTLY the batches published since its attach point: detach
  and eviction of others lose nothing and double-deliver nothing for the
  consumers that remain.

Mutations re-introduce one defect each so the checker's teeth are testable:
``reclaim_ignores_slowest`` (free-space scan skips the most-lagged consumer —
the min-head bug), ``evict_keeps_delivering`` (reads keep working after
eviction — the missing seqlock validation), ``join_stale_cursor`` (a joiner
snapshots its cursor racily at 0 — the join-outside-the-write-lock bug).
"""

from __future__ import annotations

import collections
import time

# consumer slot states
FREE, ATTACHED, EVICTED = 0, 1, 2

#: the checked invariants, in catalog order (docs/protocol.md)
INVARIANTS = (
    'released_exactly_once_per_consumer',
    'no_overwritten_read',
    'evicted_never_delivered',
    'tenant_epoch_termination',
)

#: seedable spec defects proving the checker has teeth
MUTATIONS = (
    'reclaim_ignores_slowest',
    'evict_keeps_delivering',
    'join_stale_cursor',
)

# state tuple: (published, slots)
# slot tuple: (state, attach_at, cursor, delivered, violated_flags)
#   delivered: sorted tuple of message indices this instance received
S_STATE, S_ATTACH, S_CURSOR, S_DELIVERED, S_FLAGS = range(5)


class ServeSpecConfig(object):
    """Small-scope configuration.

    :param messages: batches the producer will publish for the stream
    :param slots: consumer slots (symmetric; canonicalization exploits this)
    :param attaches: attach-event budget (instances over the run)
    :param detaches: graceful-detach budget
    :param ring_cap: in-flight message capacity of the broadcast ring
    :param lag_bound: eviction becomes enabled when a consumer lags more than
        this many messages behind the producer
    :param mutation: one of :data:`MUTATIONS`, or None for the real protocol
    """

    __slots__ = ('messages', 'slots', 'attaches', 'detaches', 'ring_cap',
                 'lag_bound', 'mutation')

    def __init__(self, messages=4, slots=3, attaches=4, detaches=1,
                 ring_cap=2, lag_bound=1, mutation=None):
        if messages < 1 or slots < 1 or attaches < 1 or ring_cap < 1:
            raise ValueError('empty scope parameter')
        if mutation is not None and mutation not in MUTATIONS:
            raise ValueError('unknown mutation {!r} (expected one of {})'.format(
                mutation, MUTATIONS))
        self.messages = messages
        self.slots = slots
        self.attaches = attaches
        self.detaches = detaches
        self.ring_cap = ring_cap
        self.lag_bound = lag_bound
        self.mutation = mutation

    def describe(self):
        return ('messages={} slots={} attaches={} detaches={} ring_cap={} '
                'lag_bound={}{}'.format(
                    self.messages, self.slots, self.attaches, self.detaches,
                    self.ring_cap, self.lag_bound,
                    ' mutation={}'.format(self.mutation) if self.mutation else ''))


def initial_state(cfg):
    slot = (FREE, 0, 0, (), ())
    return (0, (slot,) * cfg.slots, cfg.attaches, cfg.detaches)

# extended state tuple: (published, slots, attach_budget, detach_budget)
PUBLISHED, SLOTS, ATTACH_BUDGET, DETACH_BUDGET = range(4)


def canonicalize(state):
    """Slots are interchangeable: sort them."""
    return (state[PUBLISHED], tuple(sorted(state[SLOTS])),
            state[ATTACH_BUDGET], state[DETACH_BUDGET])


def _reclaim_horizon(state, cfg):
    """First message index still guaranteed live in the ring: everything
    below ``published - ring_cap`` may have been reclaimed UNLESS an attached
    cursor pins it. With the real protocol the producer never publishes past
    an attached cursor + ring_cap, so the horizon equals
    ``min(attached cursors)`` when any consumer is attached."""
    published = state[PUBLISHED]
    cursors = [s[S_CURSOR] for s in state[SLOTS] if s[S_STATE] == ATTACHED]
    if not cursors:
        return published
    return min(cursors)


def _publish_enabled(state, cfg):
    if state[PUBLISHED] >= cfg.messages:
        return False
    cursors = [s[S_CURSOR] for s in state[SLOTS] if s[S_STATE] == ATTACHED]
    if cfg.mutation == 'reclaim_ignores_slowest' and len(cursors) > 1:
        cursors.remove(min(cursors))  # the defect: the slowest does not count
    floor = min(cursors) if cursors else state[PUBLISHED]
    return state[PUBLISHED] - floor < cfg.ring_cap


def _set_slot(state, i, slot):
    slots = state[SLOTS][:i] + (slot,) + state[SLOTS][i + 1:]
    return (state[PUBLISHED], slots, state[ATTACH_BUDGET], state[DETACH_BUDGET])


def successors(state, cfg):
    """All enabled transitions as (label, canonical next state) pairs."""
    out = []
    published = state[PUBLISHED]
    slots = state[SLOTS]

    # producer: publish the next batch (bounded by the slowest attached cursor)
    if _publish_enabled(state, cfg):
        out.append((('publish', published),
                    (published + 1, slots, state[ATTACH_BUDGET],
                     state[DETACH_BUDGET])))

    horizon = published - cfg.ring_cap  # oldest physically retained index
    for i, s in enumerate(slots):
        st = s[S_STATE]
        if st == FREE and state[ATTACH_BUDGET] > 0:
            # attach: cursor snapshots the producer position (daemon-side
            # grant); the mutation snapshots a stale 0 instead
            cursor = 0 if cfg.mutation == 'join_stale_cursor' else published
            ns = _set_slot(state, i, (ATTACHED, cursor, cursor, (), ()))
            ns = (ns[PUBLISHED], ns[SLOTS], ns[ATTACH_BUDGET] - 1,
                  ns[DETACH_BUDGET])
            out.append((('attach', i, cursor), ns))
        if st == ATTACHED:
            if s[S_CURSOR] < published:
                # read: deliver the cursor message and advance. A read below
                # the physical horizon is a torn read (flagged, not hidden).
                m = s[S_CURSOR]
                flags = s[S_FLAGS]
                if m < published - cfg.ring_cap:
                    flags = tuple(sorted(set(flags) | {'torn'}))
                delivered = tuple(sorted(s[S_DELIVERED] + (m,)))
                ns = _set_slot(state, i, (ATTACHED, s[S_ATTACH], m + 1,
                                          delivered, flags))
                out.append((('deliver', i, m), ns))
            if state[DETACH_BUDGET] > 0:
                # graceful detach: the instance's record is dropped (it left
                # voluntarily); remaining consumers must be unaffected
                ns = _set_slot(state, i, (FREE, 0, 0, (), ()))
                ns = (ns[PUBLISHED], ns[SLOTS], ns[ATTACH_BUDGET],
                      ns[DETACH_BUDGET] - 1)
                out.append((('detach', i), ns))
            if published - s[S_CURSOR] > cfg.lag_bound:
                # eviction enabled (never forced): the slot stops counting
                ns = _set_slot(state, i, (EVICTED, s[S_ATTACH], s[S_CURSOR],
                                          s[S_DELIVERED], s[S_FLAGS]))
                out.append((('evict', i), ns))
        if st == EVICTED and cfg.mutation == 'evict_keeps_delivering' \
                and s[S_CURSOR] < published:
            # the defect: the missing seqlock validation lets an evicted
            # consumer keep reading reclaimed slots
            m = s[S_CURSOR]
            delivered = tuple(sorted(s[S_DELIVERED] + (m,)))
            flags = tuple(sorted(set(s[S_FLAGS]) | {'evicted_read'}))
            ns = _set_slot(state, i, (EVICTED, s[S_ATTACH], m + 1, delivered,
                                      flags))
            out.append((('deliver_evicted', i, m), ns))

    return [(label, canonicalize(ns)) for label, ns in out]


def check_state(state, cfg):
    """First violated safety invariant, or None."""
    for s in state[SLOTS]:
        delivered = s[S_DELIVERED]
        if len(delivered) != len(set(delivered)):
            return 'released_exactly_once_per_consumer'
        if 'torn' in s[S_FLAGS]:
            return 'no_overwritten_read'
        if 'evicted_read' in s[S_FLAGS]:
            return 'evicted_never_delivered'
    return None


def check_terminal(state, cfg):
    """'tenant_epoch_termination' when a quiescent state leaves any attached
    consumer short of (or beyond) its window [attach_at, messages)."""
    if state[PUBLISHED] != cfg.messages:
        return 'tenant_epoch_termination'  # quiescent but unpublished: stuck
    for s in state[SLOTS]:
        if s[S_STATE] != ATTACHED:
            continue
        expected = tuple(range(s[S_ATTACH], cfg.messages))
        if s[S_DELIVERED] != expected:
            return 'tenant_epoch_termination'
    return None


class ServeCheckResult(object):
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
    """Exhaustive BFS over every interleaving of the serve fan-out system.
    BFS order makes the first counterexample length-minimal."""
    result = ServeCheckResult(cfg)
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


#: the tier-1 default scope (tests/test_serve.py gates exhaustion + a state
#: floor on it, like the supervision scope in tests/test_protocol.py):
#: ~944k canonical states, ~20s on the reference container
DEFAULT_SERVE_SCOPE = dict(messages=7, slots=4, attaches=7, detaches=3,
                           ring_cap=3, lag_bound=2)

#: the default scope must explore at least this many canonical states — the
#: regression tripwire against accidental transition pruning (the real count
#: sits near 944k)
DEFAULT_SERVE_STATE_FLOOR = 200_000

__all__ = ['DEFAULT_SERVE_SCOPE', 'DEFAULT_SERVE_STATE_FLOOR', 'INVARIANTS',
           'MUTATIONS', 'ServeCheckResult',
           'ServeSpecConfig', 'canonicalize', 'check', 'check_state',
           'check_terminal', 'initial_state', 'successors']
