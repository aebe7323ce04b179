"""Executable spec of the chunk-fabric transfer protocol (``docs/fabric.md``).

``petastorm_tpu_torch/fabric`` lets a host that misses a chunk fetch it from a
pod peer's mirror before touching the object store: peer-first with sha256
verification, a per-peer circuit breaker, and an unconditional object-store
fallback. This module states that design as an explicit-state transition
system small enough to check exhaustively, as ``spec.py`` does for the
supervision protocol, ``serve_spec.py`` for the serve fan-out and
``elastic_spec.py`` for elastic resharding. Twin of
``petastorm_tpu/analysis/protocol/fabric_spec.py``: the same states,
transitions, invariants and mutations.

Model scope (one fetching host, ``peers`` serving peers, ``chunks`` chunk
fetches in flight):

* a peer is UP or CRASHED; a crashed peer's lease has not expired yet, so
  requests still route to it and fail (connect refused) — exactly the
  window the breaker exists for;
* network faults (refused / reset / truncated / corrupt payloads) come from
  small budgets; resets, truncations and refusals collapse into one
  "transient failure" transition because the client classifies them
  identically, while corruption is separate (it exercises the hash gate);
* the breaker is modeled per peer as (state, consecutive failures); the
  open→half-open cooldown is a *transition*, time abstracted to structure;
* verification and population collapse into the request-resolution
  transitions: ``req_ok`` is verified bytes populating the mirror,
  ``req_corrupt`` is bytes failing the hash (discarded — unless the
  ``skip_hash_check`` mutation lets them through).

Checked invariants (catalog order; ``docs/protocol.md``):

* ``populate_once`` — a chunk is populated at most once on this host;
* ``hash_verified`` — fetched bytes always hash-verify or are discarded
  (no poisoned mirror);
* ``breaker_discipline`` — a peer whose breaker is open receives no
  requests (judged at admission: a breaker opening mid-flight on an
  already-issued request is NOT a violation);
* ``fetch_termination`` — every fetch terminates via peer bytes, fallback
  bytes, or a surfaced error, under any combination of crashes, faults,
  and fallback failures.

Mutations re-introduce one defect each so the checker's teeth are testable:
``skip_hash_check`` (corrupt payloads populate the mirror), ``double_populate``
(a completed fetch can populate again — the single-flight guard removed),
``request_open_peer`` (admission ignores the breaker), ``no_fallback``
(a failed peer fetch strands the chunk instead of degrading).
"""

from __future__ import annotations

import collections
import random
import time

# peer liveness
UP, CRASHED = 0, 1

# breaker states (mirrors fabric/breaker.py)
B_CLOSED, B_OPEN, B_HALF = 0, 1, 2

#: the checked invariants, in catalog order (docs/protocol.md)
INVARIANTS = (
    'populate_once',
    'hash_verified',
    'breaker_discipline',
    'fetch_termination',
)

#: seedable spec defects proving the checker has teeth
MUTATIONS = (
    'skip_hash_check',
    'double_populate',
    'request_open_peer',
    'no_fallback',
)

# state tuple indices
CHUNKS, PEERS, CRASHES_LEFT, FAULTS_LEFT, FB_FAILS_LEFT, FLAGS = range(6)

# flags bitmask
F_OPEN_REQ = 1      # a request was admitted to an open-breaker peer
F_DOUBLE = 2        # a chunk was populated twice
F_POISON = 4        # unverified bytes reached the mirror

# chunk cell encoding, for cfg.peers == P:
#   PEND (0)        fetch not started
#   1 + p           request in flight to peer p
#   1 + P           fallback (object-store read) in flight
#   2 + P           done: populated from a peer
#   3 + P           done: populated from the fallback
#   4 + P           done: fallback failed, error surfaced to the caller
#   5 + P           stuck: peer failed and nothing degraded (mutant sink)
PEND = 0


class FabricSpecConfig(object):
    """Small-scope configuration.

    :param peers: serving peers visible to the fetching host
    :param chunks: chunk fetches in the run
    :param crashes: peer-crash budget
    :param faults: transient-network-fault budget (refused/reset/truncated
        payloads AND corrupt payloads draw from it)
    :param fb_fails: object-store fallback failure budget
    :param breaker_k: consecutive failures that open a peer's breaker
    :param mutation: one of :data:`MUTATIONS`, or None for the real protocol
    """

    __slots__ = ('peers', 'chunks', 'crashes', 'faults', 'fb_fails',
                 'breaker_k', 'mutation')

    def __init__(self, peers=2, chunks=3, crashes=1, faults=2, fb_fails=1,
                 breaker_k=2, mutation=None):
        if peers < 1 or chunks < 1:
            raise ValueError('empty scope parameter')
        if crashes < 0 or faults < 0 or fb_fails < 0:
            raise ValueError('negative event budget')
        if breaker_k < 1:
            raise ValueError('breaker_k must be >= 1')
        if mutation is not None and mutation not in MUTATIONS:
            raise ValueError('unknown mutation {!r} (expected one of {})'.format(
                mutation, MUTATIONS))
        self.peers = peers
        self.chunks = chunks
        self.crashes = crashes
        self.faults = faults
        self.fb_fails = fb_fails
        self.breaker_k = breaker_k
        self.mutation = mutation

    def describe(self):
        return ('peers={} chunks={} crashes={} faults={} fb_fails={} '
                'breaker_k={}{}'.format(
                    self.peers, self.chunks, self.crashes, self.faults,
                    self.fb_fails, self.breaker_k,
                    ' mutation={}'.format(self.mutation)
                    if self.mutation else ''))


def initial_state(cfg):
    peers = tuple((UP, 0, B_CLOSED) for _ in range(cfg.peers))
    return ((PEND,) * cfg.chunks, peers, cfg.crashes, cfg.faults,
            cfg.fb_fails, 0)


def canonicalize(state):
    """Peers are NOT interchangeable (rendezvous ranking keys on identity),
    so canonical form is the state itself."""
    return state


def _cells(cfg):
    P = cfg.peers
    return {'fb': 1 + P, 'done_peer': 2 + P, 'done_fb': 3 + P,
            'done_err': 4 + P, 'stuck': 5 + P}


def _set_chunk(state, c, value):
    chunks = state[CHUNKS][:c] + (value,) + state[CHUNKS][c + 1:]
    return (chunks,) + state[1:]


def _set_peer(state, p, peer):
    peers = state[PEERS][:p] + (peer,) + state[PEERS][p + 1:]
    return state[:PEERS] + (peers,) + state[PEERS + 1:]


def _spend(state, idx):
    return state[:idx] + (state[idx] - 1,) + state[idx + 1:]


def _flag(state, bit):
    return state[:FLAGS] + (state[FLAGS] | bit,)


def _peer_success(state, p):
    return _set_peer(state, p, (state[PEERS][p][0], 0, B_CLOSED))


def _peer_failure(state, p, cfg):
    up, failures, breaker = state[PEERS][p]
    failures += 1
    if breaker == B_HALF or failures >= cfg.breaker_k:
        breaker = B_OPEN
    return _set_peer(state, p, (up, failures, breaker))


def successors(state, cfg):
    """All enabled transitions as (label, canonical next state) pairs."""
    out = []
    P = cfg.peers
    cells = _cells(cfg)
    FB, DONE_PEER, DONE_FB = cells['fb'], cells['done_peer'], cells['done_fb']
    DONE_ERR, STUCK = cells['done_err'], cells['stuck']
    chunks = state[CHUNKS]
    peers = state[PEERS]

    for c, cell in enumerate(chunks):
        # start: admission picks any breaker-admitted peer (the real client
        # picks the rendezvous-best one; any admitted peer exercises the
        # same protocol), or goes straight to the fallback when none is
        if cell == PEND:
            any_admitted = False
            for p, (up, _f, breaker) in enumerate(peers):
                if breaker != B_OPEN:
                    any_admitted = True
                    out.append((('start', c, p, True),
                                _set_chunk(state, c, 1 + p)))
                elif cfg.mutation == 'request_open_peer':
                    # the defect: admission ignores the breaker entirely
                    out.append((('start', c, p, False),
                                _flag(_set_chunk(state, c, 1 + p),
                                      F_OPEN_REQ)))
            if not any_admitted:
                out.append((('start', c, None, True),
                            _set_chunk(state, c, FB)))

        # request resolution
        elif 1 <= cell <= P:
            p = cell - 1
            up = peers[p][0] == UP
            fail_target = STUCK if cfg.mutation == 'no_fallback' else FB
            if up:
                # verified bytes populate the mirror; breaker resets
                out.append((('req_ok', c, p),
                            _peer_success(_set_chunk(state, c, DONE_PEER), p)))
                if state[FAULTS_LEFT] > 0:
                    # transient failure (refused / reset / truncated): the
                    # client classifies them identically -> one transition
                    out.append((('req_fail', c, p),
                                _peer_failure(_spend(
                                    _set_chunk(state, c, fail_target),
                                    FAULTS_LEFT), p, cfg)))
                    # corrupt payload: hash gate discards it (a failure) —
                    # unless the skip_hash_check defect lets it populate
                    if cfg.mutation == 'skip_hash_check':
                        out.append((('req_corrupt', c, p, True),
                                    _flag(_spend(
                                        _set_chunk(state, c, DONE_PEER),
                                        FAULTS_LEFT), F_POISON)))
                    else:
                        out.append((('req_corrupt', c, p, False),
                                    _peer_failure(_spend(
                                        _set_chunk(state, c, fail_target),
                                        FAULTS_LEFT), p, cfg)))
            else:
                # crashed peer, lease not yet expired: connect refused
                out.append((('req_fail', c, p),
                            _peer_failure(
                                _set_chunk(state, c, fail_target), p, cfg)))

        # fallback resolution
        elif cell == FB:
            out.append((('fb_ok', c), _set_chunk(state, c, DONE_FB)))
            if state[FB_FAILS_LEFT] > 0:
                out.append((('fb_fail', c),
                            _spend(_set_chunk(state, c, DONE_ERR),
                                   FB_FAILS_LEFT)))

        # the double_populate defect: a completed fetch populates again
        # (the single-flight guard removed)
        elif cell in (DONE_PEER, DONE_FB) and \
                cfg.mutation == 'double_populate':
            out.append((('double', c), _flag(state, F_DOUBLE)))

    # peer crash (SIGKILL mid-anything; its lease lives on for a while)
    if state[CRASHES_LEFT] > 0:
        for p, (up, failures, breaker) in enumerate(peers):
            if up == UP:
                out.append((('crash', p),
                            _spend(_set_peer(state, p,
                                             (CRASHED, failures, breaker)),
                                   CRASHES_LEFT)))

    # breaker cooldown: open -> half-open (time abstracted to structure)
    for p, (up, failures, breaker) in enumerate(peers):
        if breaker == B_OPEN:
            out.append((('cooldown', p),
                        _set_peer(state, p, (up, failures, B_HALF))))

    return [(label, canonicalize(ns)) for label, ns in out]


def check_state(state, cfg):
    """First violated safety invariant, or None."""
    flags = state[FLAGS]
    if flags & F_DOUBLE:
        return 'populate_once'
    if flags & F_POISON:
        return 'hash_verified'
    if flags & F_OPEN_REQ:
        return 'breaker_discipline'
    return None


def check_terminal(state, cfg):
    """Liveness at quiescence: every fetch must have resolved — peer bytes,
    fallback bytes, or a surfaced error. A stranded chunk (the no_fallback
    mutant's sink) is exactly the hang this invariant forbids."""
    cells = _cells(cfg)
    done = (cells['done_peer'], cells['done_fb'], cells['done_err'])
    if any(cell not in done for cell in state[CHUNKS]):
        return 'fetch_termination'
    return None


class FabricCheckResult(object):
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
    """Exhaustive BFS over every interleaving of the fabric transfer system.
    BFS order makes the first counterexample length-minimal."""
    result = FabricCheckResult(cfg)
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
    ``tests/test_torch_fabric.py``."""
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
    """Replay a spec trace through a :class:`~petastorm_tpu_torch.analysis.
    protocol.monitor.FabricMonitor` — the event-projection glue that keeps
    the runtime monitor honest against the spec. Healthy traces must pass;
    mutant traces that reach an event-visible defect must raise
    :class:`~petastorm_tpu_torch.errors.ProtocolViolation`. (``no_fallback`` is a
    liveness defect with no event to observe — the model checker, not the
    monitor, owns it.)"""
    for label in trace:
        kind = label[0]
        if kind == 'start' and label[2] is not None:
            monitor.on_request('peer{}'.format(label[2]), allowed=label[3])
        elif kind == 'req_ok':
            monitor.on_populate('chunk{}'.format(label[1]), verified=True)
            monitor.on_outcome('chunk{}'.format(label[1]), 'peer')
        elif kind == 'req_corrupt' and label[3]:
            # the skip_hash_check mutant: unverified bytes hit the mirror
            monitor.on_populate('chunk{}'.format(label[1]), verified=False)
        elif kind == 'fb_ok':
            monitor.on_populate('chunk{}'.format(label[1]), verified=True)
            monitor.on_outcome('chunk{}'.format(label[1]), 'fallback')
        elif kind == 'fb_fail':
            monitor.on_outcome('chunk{}'.format(label[1]), 'error')
        elif kind == 'double':
            monitor.on_populate('chunk{}'.format(label[1]), verified=True)
        # 'req_fail', 'crash', 'cooldown' have no mirror-visible event


#: the tier-1 default scope (tests/test_torch_fabric.py gates exhaustion + a
#: state floor on it, like the supervision, serve, and elastic scopes)
DEFAULT_FABRIC_SCOPE = dict(peers=3, chunks=4, crashes=2, faults=3,
                            fb_fails=2, breaker_k=2)

#: the default scope must explore at least this many canonical states — the
#: regression tripwire against accidental transition pruning (the scope
#: above explores ~435k)
DEFAULT_FABRIC_STATE_FLOOR = 200_000

__all__ = ['DEFAULT_FABRIC_SCOPE', 'DEFAULT_FABRIC_STATE_FLOOR',
           'FabricCheckResult', 'FabricSpecConfig', 'INVARIANTS',
           'MUTATIONS', 'canonicalize', 'check', 'check_state',
           'check_terminal', 'initial_state', 'random_walk',
           'replay_into_monitor', 'successors']
