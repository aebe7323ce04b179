"""Executable spec of the worker-pool supervision protocol.

The protocol that keeps ``ProcessPool`` exactly-once under crashes (dispatch-id
ownership, claim heartbeats, two-stage death handling, stale-straggler
dropping, quiet-window sweep — ``docs/robustness.md``) is stated here as an
explicit-state transition system small enough to check exhaustively
(``modelcheck.py``) and deterministic enough to check the real implementation
against at runtime (``monitor.py``). ``docs/protocol.md`` is the prose
companion: state vocabulary, transition catalog, invariant catalog, and how to
read a counterexample trace. Twin of ``petastorm_tpu/analysis/protocol/spec.py``:
the same states, labels, invariants and mutations, so both packages' checkers
explore the same spaces.

Model scope (what is abstracted):

* **Time is abstracted to structure.** Grace windows, heartbeat staleness and
  the quiet-window timer become *enablement conditions*: the sweep may fire
  whenever the supervisor-visible gates hold (all live workers idle, channels
  silent, retired channels drained). The model therefore includes schedules
  the timers make merely unlikely — e.g. a sweep firing while an item still
  sits in a live worker's dispatch pipe — which is exactly why the stale-drop
  rules must carry the exactly-once invariant on their own.
* **Channels are FIFO**, matching the shm ring; the zmq fallback's
  grace-period drain approximates the ring's exact "retired channel empty"
  test and is modeled by the latter.
* Respawn always succeeds (slot shedding / ``WorkerPoolDepletedError`` is a
  degraded-mode concern, not a protocol-invariant concern); serialization,
  blob routing and telemetry piggybacks are payload concerns with no
  accounting effect and are not modeled (``metrics``/idle ``heartbeat``
  messages never change supervisor ownership state).

Two sound reductions keep the small-scope search exhaustible:

* **Symmetry canonicalization.** Worker slots are interchangeable, so states
  are canonicalized by sorting the per-slot component; logical items are
  interchangeable too (identity enters the dynamics only through the per-item
  accounting vectors and in-flight records), so dispatched items are
  canonically renamed by their accounting signature. Dispatch ids enter the
  dynamics only through equality and fresh allocation, so they are densely
  renumbered order-preservingly (a bisimulation quotient) — except for
  mutated specs, whose counterexample traces must keep globally stable ids
  for :func:`replay_into_monitor`.
* **Bounded transports.** The real results channel is a fixed-capacity ring
  and the dispatch pipe has a zmq HWM — workers block, they do not buffer
  unboundedly. The model mirrors that with small caps
  (``SpecConfig(chan_cap=..., pipe_cap=...)``): a send into a full channel is
  simply not enabled until the consumer drains. Exhaustiveness is relative to
  these caps, as is standard for small-scope checking.
* **Partial-order reduction.** Popping a claim, a payload, a completion, or a
  stale error off a channel head is executed *eagerly* as the state's only
  explored transition: each such pop stays enabled until taken (nothing else
  removes a channel head), commutes with every other enabled transition
  (channel appends land at the tail; a crash preserves the channel; the
  ``finish_death``/``sweep`` gates that read the claim table are necessarily
  disabled while the relevant channel is non-empty — the claim a pop might
  clear belongs to the worker whose channel holds the message), and affects
  the invariant predicates only monotonically — so every violation reachable
  by delaying the pop is reachable (same canonical state) by taking it first.
  Branching remains exactly where protocol decisions live: dispatch/requeue
  routing, worker-step-vs-crash interleavings, live error handling, orphan
  resolution and the sweep. Once the crash and error budgets are exhausted, a
  worker's only-move steps (pickup; the published worker's completion send)
  join the eager set by the same argument — their lone conflict partners were
  the crash of the same worker and the quiet-window sweep, the latter provably
  never co-enabled with an accounted claim. The reduction is disabled for
  mutated specs: a mutation (e.g. ``requeue_same_id``) may break the
  unique-dispatch-id assumption several of the commutation arguments rest on.

Mutations (``SpecConfig(mutation=...)``) re-introduce one protocol defect
each, so the checker's teeth can be tested: every mutation must yield a
counterexample trace (see ``tests/test_protocol.py``).
"""

from __future__ import annotations

import itertools

from petastorm_tpu_torch.errors import ProtocolViolation

# worker phases
IDLE, WORK, PUB = 0, 1, 2

# results-channel message kinds, named after protocol.MESSAGE_KINDS values
C_CLAIM, C_DATA, C_DONE, C_ERROR = 'claim', 'data', 'done', 'error'

# state tuple indices
(NEXT_ITEM, NEXT_D, INFLIGHT, SLOTS, ORPHANS, DELIVERED, COMPLETED,
 QUARANTINED, COMPLETED_ITEMS, CRASHES, ERRORS, DEATHS_SEEN, RAISED) = range(13)

# slot tuple indices: (alive, phase, cur, pipe, chan, sup_busy)
S_ALIVE, S_PHASE, S_CUR, S_PIPE, S_CHAN, S_SUP = range(6)

#: the five checked invariants, in catalog order (docs/protocol.md)
INVARIANTS = (
    'exactly_once_delivery',      # every item's payload reaches the consumer <= once
    'exactly_once_completion',    # every item completes (delivered/quarantined/raised) <= once
    'no_double_count',            # pool completed_items == sum of per-item completions
    'bounded_attempts',           # no item exceeds max_item_retries failed attempts
    'epoch_termination',          # every quiescent run converges: all items resolved
)

#: seedable spec defects for verifying the checker/monitor have teeth
MUTATIONS = (
    'requeue_same_id',          # requeue reuses the old dispatch id (stale detection dies)
    'requeue_published',        # error-requeue ignores the published flag (double delivery)
    'no_stale_drop',            # stale _DONE counted as a completion (double count)
    'no_drain_before_respawn',  # ownership decided before the dead worker's channel drains
)


class SpecConfig(object):
    """Small-scope configuration of the transition system.

    :param workers: pool slots (symmetric; canonicalization exploits this)
    :param items: logical items the ventilator will dispatch
    :param crashes: worker-crash budget (SIGKILL at any point)
    :param retries: ``max_item_retries`` — failed attempts allowed per item
    :param errors: worker-raised error budget (0 = crash-only exploration)
    :param policy: ``'raise' | 'skip' | 'retry'`` — the ErrorPolicy under test
    :param publish: model the payload (``data``) message as a separate step, so
        crash/error-after-publish interleavings exist (required for the
        delivery invariant to mean anything)
    :param mutation: one of :data:`MUTATIONS` (None = the real protocol)
    :param chan_cap: results-channel capacity in messages (the shm ring bound)
    :param pipe_cap: dispatch-pipe capacity for fresh dispatches (the zmq HWM
        bound; requeues bypass it — the implementation's sender buffers them)
    """

    __slots__ = ('workers', 'items', 'crashes', 'retries', 'errors', 'policy',
                 'publish', 'mutation', 'chan_cap', 'pipe_cap')

    def __init__(self, workers=3, items=4, crashes=2, retries=1, errors=0,
                 policy='skip', publish=True, mutation=None,
                 chan_cap=3, pipe_cap=1):
        if workers < 1 or items < 0 or crashes < 0 or retries < 0 or errors < 0:
            raise ValueError('negative/empty scope parameter')
        if crashes >= workers:
            # all slots may then be dead at once with an undeliverable requeue
            # in hand; the implementation's zmq PUSH would simply buffer until
            # a respawn connects, which this model does not represent
            raise ValueError('crashes budget must stay below workers '
                             '(got {} >= {})'.format(crashes, workers))
        if policy not in ('raise', 'skip', 'retry'):
            raise ValueError('policy must be raise/skip/retry, got {!r}'.format(policy))
        if mutation is not None and mutation not in MUTATIONS:
            raise ValueError('unknown mutation {!r} (expected one of {})'.format(
                mutation, MUTATIONS))
        if chan_cap < 3 or pipe_cap < 1:
            # a channel must at least hold one item's claim+data+done burst
            raise ValueError('chan_cap must be >= 3 and pipe_cap >= 1')
        self.workers, self.items, self.crashes = workers, items, crashes
        self.retries, self.errors, self.policy = retries, errors, policy
        self.publish, self.mutation = bool(publish), mutation
        self.chan_cap, self.pipe_cap = chan_cap, pipe_cap

    def describe(self):
        return ('workers={} items={} crashes={} retries={} errors={} policy={} '
                'publish={} chan_cap={} pipe_cap={}{}'.format(
                    self.workers, self.items, self.crashes, self.retries,
                    self.errors, self.policy, self.publish, self.chan_cap,
                    self.pipe_cap,
                    ' mutation={}'.format(self.mutation) if self.mutation else ''))


def initial_state(cfg):
    slot = (1, IDLE, -1, (), (), -1)
    return (0, 0, (), (slot,) * cfg.workers, (), (0,) * cfg.items,
            (0,) * cfg.items, (0,) * cfg.items, 0, 0, 0, 0, 0)


def _renumber_ids(state):
    """Order-preserving dense renumbering of the dispatch ids alive in
    ``state`` (ids only enter the dynamics through equality and fresh
    allocation, so this is a bisimulation quotient): two states whose requeue
    histories burned different id counts collapse. Skipped for mutated specs
    so counterexample traces keep globally stable ids — that stability is what
    :func:`replay_into_monitor` exercises."""
    ids = {rec[0] for rec in state[INFLIGHT]}
    ids.update(state[ORPHANS])
    for s in state[SLOTS]:
        if s[S_CUR] != -1:
            ids.add(s[S_CUR])
        if s[S_SUP] != -1:
            ids.add(s[S_SUP])
        ids.update(s[S_PIPE])
        ids.update(d for _k, d in s[S_CHAN])
    k = len(ids)
    if not ids:
        return state if state[NEXT_D] == 0 else _set(state, NEXT_D, 0)
    if max(ids) == k - 1:  # already dense: at most the allocator needs resetting
        return state if state[NEXT_D] == k else _set(state, NEXT_D, k)
    rn = {d: i for i, d in enumerate(sorted(ids))}
    rn[-1] = -1
    state = _set(state, NEXT_D, k)
    state = _set(state, INFLIGHT, tuple(sorted(
        (rn[d], it, att, pub) for d, it, att, pub in state[INFLIGHT])))
    state = _set(state, ORPHANS, tuple(sorted(rn[d] for d in state[ORPHANS])))
    slots = tuple(
        (s[S_ALIVE], s[S_PHASE], rn[s[S_CUR]],
         tuple(rn[d] for d in s[S_PIPE]),
         tuple((k, rn[d]) for k, d in s[S_CHAN]), rn[s[S_SUP]])
        for s in state[SLOTS])
    return _set(state, SLOTS, slots)


def canonicalize(state, cfg=None):
    """Collapse the spec symmetries to one representative: densely renumber
    dispatch ids (unmutated specs only), sort the interchangeable worker
    slots, then canonically rename the dispatched items by their accounting
    signature (two items with identical delivered/completed/quarantined
    counts and identical in-flight records are interchangeable)."""
    if cfg is None or cfg.mutation is None:
        state = _renumber_ids(state)
    state = state[:SLOTS] + (tuple(sorted(state[SLOTS])),) + state[SLOTS + 1:]
    ni = state[NEXT_ITEM]
    if ni <= 1:
        return state
    inflight = state[INFLIGHT]
    deliv, comp, quar = state[DELIVERED], state[COMPLETED], state[QUARANTINED]

    def sig(i):
        return (comp[i], deliv[i], quar[i],
                tuple((d, att, pub) for d, it, att, pub in inflight if it == i))

    order = sorted(range(ni), key=sig)
    if order == list(range(ni)):
        return state
    rename = {old: new for new, old in enumerate(order)}
    inflight = tuple(sorted((d, rename[it], att, pub)
                            for d, it, att, pub in inflight))

    def permute(vec):
        return tuple(vec[order[j]] for j in range(ni)) + vec[ni:]

    state = _set(state, INFLIGHT, inflight)
    state = _set(state, DELIVERED, permute(deliv))
    state = _set(state, COMPLETED, permute(comp))
    return _set(state, QUARANTINED, permute(quar))


def _set(t, i, v):
    return t[:i] + (v,) + t[i + 1:]


def _set_slot(state, w, slot):
    return _set(state, SLOTS, _set(state[SLOTS], w, slot))


def _bump(vec, i):
    return _set(vec, i, vec[i] + 1)


def _infl_get(inflight, d):
    for rec in inflight:
        if rec[0] == d:
            return rec
    return None


def _infl_del(inflight, d):
    return tuple(r for r in inflight if r[0] != d)


def _infl_add(inflight, rec):
    return tuple(sorted(inflight + (rec,)))


def _clear_claim(slots, d):
    """Mirror of ``ProcessPool._clear_claim``: a done/error for dispatch ``d``
    releases whichever supervisor-side ownership record names it."""
    out = list(slots)
    for w, s in enumerate(out):
        if s[S_SUP] == d:
            out[w] = _set(s, S_SUP, -1)
    return tuple(out)


def _complete(state, d, item):
    """Exactly-once completion accounting: remove from inflight, count the
    item complete, advance the pool counter."""
    state = _set(state, INFLIGHT, _infl_del(state[INFLIGHT], d))
    state = _set(state, COMPLETED, _bump(state[COMPLETED], item))
    return _set(state, COMPLETED_ITEMS, state[COMPLETED_ITEMS] + 1)


def _quarantine(state, d, item):
    state = _complete(state, d, item)
    return _set(state, QUARANTINED, _bump(state[QUARANTINED], item))


def _requeue(state, cfg, d, rec, target_w):
    """Re-dispatch ``rec`` under a NEW dispatch id routed to ``target_w``'s
    pipe (the ``requeue_same_id`` mutation keeps the old id — the defect the
    exactly-once argument hinges on never having)."""
    item, att = rec[1], rec[2]
    if cfg.mutation == 'requeue_same_id':
        nd = d
        inflight = _infl_add(_infl_del(state[INFLIGHT], d), (nd, item, att + 1, 0))
    else:
        nd = state[NEXT_D]
        state = _set(state, NEXT_D, nd + 1)
        inflight = _infl_add(_infl_del(state[INFLIGHT], d), (nd, item, att + 1, 0))
    state = _set(state, INFLIGHT, inflight)
    slot = state[SLOTS][target_w]
    state = _set_slot(state, target_w, _set(slot, S_PIPE, slot[S_PIPE] + (nd,)))
    return nd, state


def _fail_item(state, cfg, d, rec, live_workers, prefix):
    """The crash-failure policy of ``_fail_crashed_item``: retry within
    budget, else quarantine (skip) or poison-raise. Yields (label, state) per
    routing choice."""
    item, att = rec[1], rec[2]
    out = []
    if att < cfg.retries:
        for w in live_workers:
            nd, ns = _requeue(state, cfg, d, rec, w)
            out.append(((prefix + '_requeue', d, nd, w), ns))
    elif cfg.policy == 'skip':
        out.append(((prefix + '_quarantine', d), _quarantine(state, d, item)))
    else:
        ns = _set(_complete(state, d, item), RAISED, 1)
        out.append(((prefix + '_poison_raise', d), ns))
    return out


def _consume_head(state, cfg, w):
    """Transitions for the consumer popping the head of slot ``w``'s results
    channel: claims update the supervisor ownership view, data/done/error are
    classified live vs stale against the in-flight table — the stale-straggler
    drop that exactly-once rests on."""
    out = []
    s = state[SLOTS][w]
    kind, d = s[S_CHAN][0]
    popped = _set_slot(state, w, _set(s, S_CHAN, s[S_CHAN][1:]))
    rec = _infl_get(state[INFLIGHT], d)
    if kind == C_CLAIM:
        # _note_heartbeat: the supervisor view takes the claim verbatim,
        # stale or not
        ps = popped[SLOTS][w]
        ns = _set_slot(popped, w, _set(ps, S_SUP, d))
        out.append((('consume_claim', w, d), ns))
    elif kind == C_DATA:
        if rec is not None:
            ns = _set(popped, INFLIGHT,
                      _infl_add(_infl_del(popped[INFLIGHT], d),
                                (d, rec[1], rec[2], 1)))
            ns = _set(ns, DELIVERED, _bump(ns[DELIVERED], rec[1]))
            out.append((('consume_data', w, d, True), ns))
        else:
            out.append((('consume_data', w, d, False), popped))
    elif kind == C_DONE:
        ns = _set(popped, SLOTS, _clear_claim(popped[SLOTS], d))
        if rec is not None:
            out.append((('consume_done_live', w, d), _complete(ns, d, rec[1])))
        elif cfg.mutation == 'no_stale_drop':
            ns = _set(ns, COMPLETED_ITEMS, ns[COMPLETED_ITEMS] + 1)
            out.append((('consume_done_stale_counted', w, d), ns))
        else:
            out.append((('consume_done_stale', w, d), ns))
    else:  # C_ERROR
        ns = _set(popped, SLOTS, _clear_claim(popped[SLOTS], d))
        if rec is None:
            out.append((('consume_error_stale', w, d), ns))
        else:
            item, att, pub = rec[1], rec[2], rec[3]
            if pub and cfg.policy != 'raise' and cfg.mutation != 'requeue_published':
                # the item's payload already reached the consumer (FIFO:
                # its data message preceded this error) — re-running would
                # deliver twice, so it completes delivered instead
                out.append((('consume_error_published_complete', w, d),
                            _complete(ns, d, item)))
            elif att < cfg.retries and cfg.policy in ('skip', 'retry'):
                nlive = [x for x, sl in enumerate(ns[SLOTS]) if sl[S_ALIVE]]
                for tw in nlive:
                    nd, rs = _requeue(ns, cfg, d, rec, tw)
                    out.append((('consume_error_requeue', w, d, nd, tw), rs))
            elif cfg.policy == 'skip':
                out.append((('consume_error_quarantine', w, d),
                            _quarantine(ns, d, item)))
            else:
                rs = _set(_complete(ns, d, item), RAISED, 1)
                out.append((('consume_error_raise', w, d), rs))
    return out


def successors(state, cfg, canonical=True):
    """All enabled transitions of ``state`` as ``(label, next_state)`` pairs
    (canonicalized unless ``canonical=False`` — raw successors keep dispatch
    ids and slot indices globally stable, which random-walk traces replayed
    into the runtime monitor rely on). Labels are structured tuples (see
    ``replay_into_monitor`` for the mapping to runtime-monitor events)."""
    if state[RAISED]:
        return []
    out = []
    slots = state[SLOTS]
    inflight = state[INFLIGHT]
    live = [w for w, s in enumerate(slots) if s[S_ALIVE]]

    # partial-order reduction (module docstring): a channel head that is not a
    # LIVE error is popped eagerly as the sole explored transition — it
    # commutes with everything else enabled and only monotonically advances
    # the invariant predicates, so no violation is lost. Disabled for mutated
    # specs, whose broken id discipline voids the commutation argument.
    if cfg.mutation is None:
        for w, s in enumerate(slots):
            if s[S_CHAN]:
                kind, d = s[S_CHAN][0]
                if kind != C_ERROR or _infl_get(inflight, d) is None:
                    head = _consume_head(state, cfg, w)
                    if not canonical:
                        return head
                    return [(lab, canonicalize(ns, cfg)) for lab, ns in head]
        # once the crash/error budgets are spent, a worker's only-move steps
        # are safe singletons too (module docstring): pickup (unless a sweep
        # could race it) and the published worker's completion send
        if state[CRASHES] >= cfg.crashes and state[ERRORS] >= cfg.errors:
            sweep_possible = state[DEATHS_SEEN] and not state[ORPHANS] and inflight
            for w, s in enumerate(slots):
                if not s[S_ALIVE] or len(s[S_CHAN]) >= cfg.chan_cap:
                    continue
                if s[S_PHASE] == PUB:
                    d = s[S_CUR]
                    ns = _set_slot(state, w, (1, IDLE, -1, s[S_PIPE],
                                              s[S_CHAN] + ((C_DONE, d),), s[S_SUP]))
                    return [(('worker_done', w, d),
                             canonicalize(ns, cfg) if canonical else ns)]
                if s[S_PHASE] == IDLE and s[S_PIPE] and not sweep_possible:
                    d = s[S_PIPE][0]
                    ns = _set_slot(state, w, (1, WORK, d, s[S_PIPE][1:],
                                              s[S_CHAN] + ((C_CLAIM, d),), s[S_SUP]))
                    return [(('pickup', w, d),
                             canonicalize(ns, cfg) if canonical else ns)]

    # -- ventilator: dispatch the next item to a live worker's pipe ---------
    if state[NEXT_ITEM] < cfg.items:
        item = state[NEXT_ITEM]
        d = state[NEXT_D]
        base = _set(_set(state, NEXT_ITEM, item + 1), NEXT_D, d + 1)
        base = _set(base, INFLIGHT, _infl_add(inflight, (d, item, 0, 0)))
        for w in live:
            s = slots[w]
            if len(s[S_PIPE]) < cfg.pipe_cap:  # zmq HWM: full pipe blocks the sender
                ns = _set_slot(base, w, _set(s, S_PIPE, s[S_PIPE] + (d,)))
                out.append((('dispatch', d, item, w), ns))

    # -- worker-side steps --------------------------------------------------
    for w, s in enumerate(slots):
        if s[S_ALIVE]:
            # a full results channel blocks the sender (the ring's capacity
            # bound): the step simply is not enabled until the consumer drains
            chan_open = len(s[S_CHAN]) < cfg.chan_cap
            if s[S_PHASE] == IDLE and s[S_PIPE] and chan_open:
                d = s[S_PIPE][0]
                ns = _set_slot(state, w, (1, WORK, d, s[S_PIPE][1:],
                                          s[S_CHAN] + ((C_CLAIM, d),), s[S_SUP]))
                out.append((('pickup', w, d), ns))
            if s[S_PHASE] == WORK and chan_open:
                d = s[S_CUR]
                done = _set_slot(state, w, (1, IDLE, -1, s[S_PIPE],
                                            s[S_CHAN] + ((C_DONE, d),), s[S_SUP]))
                out.append((('worker_done', w, d), done))
                if cfg.publish:
                    pub = _set_slot(state, w, (1, PUB, d, s[S_PIPE],
                                               s[S_CHAN] + ((C_DATA, d),), s[S_SUP]))
                    out.append((('publish', w, d), pub))
                if state[ERRORS] < cfg.errors:
                    err = _set_slot(state, w, (1, IDLE, -1, s[S_PIPE],
                                               s[S_CHAN] + ((C_ERROR, d),), s[S_SUP]))
                    out.append((('worker_error', w, d),
                                _set(err, ERRORS, state[ERRORS] + 1)))
            elif s[S_PHASE] == PUB and chan_open:
                d = s[S_CUR]
                done = _set_slot(state, w, (1, IDLE, -1, s[S_PIPE],
                                            s[S_CHAN] + ((C_DONE, d),), s[S_SUP]))
                out.append((('worker_done', w, d), done))
                if state[ERRORS] < cfg.errors:
                    err = _set_slot(state, w, (1, IDLE, -1, s[S_PIPE],
                                               s[S_CHAN] + ((C_ERROR, d),), s[S_SUP]))
                    out.append((('worker_error', w, d),
                                _set(err, ERRORS, state[ERRORS] + 1)))
            if state[CRASHES] < cfg.crashes:
                # SIGKILL at any point: worker memory (phase, current item,
                # undelivered pipe) vanishes; committed channel messages
                # survive (shared memory outlives the writer)
                ns = _set_slot(state, w, (0, IDLE, -1, (), s[S_CHAN], s[S_SUP]))
                ns = _set(_set(ns, CRASHES, state[CRASHES] + 1), DEATHS_SEEN, 1)
                out.append((('crash', w), ns))
        else:
            drained = not s[S_CHAN]
            if drained or cfg.mutation == 'no_drain_before_respawn':
                # two-stage death handling: ownership + respawn only after the
                # dead worker's channel fully drained (the mutation breaks
                # exactly this and must lose an item)
                owned = s[S_SUP]
                ns = state
                if owned != -1:
                    ns = _set(ns, ORPHANS, tuple(sorted(set(ns[ORPHANS]) | {owned})))
                ns = _set_slot(ns, w, (1, IDLE, -1, (), s[S_CHAN] if not drained else (), -1))
                out.append((('finish_death', w, owned if owned != -1 else None), ns))

    # -- consumer: pop the head of any non-empty channel (FIFO per channel) -
    for w, s in enumerate(slots):
        if s[S_CHAN]:
            out.extend(_consume_head(state, cfg, w))

    # -- supervisor: orphan resolution --------------------------------------
    retired_drained = all(s[S_ALIVE] or not s[S_CHAN] for s in slots)
    if state[ORPHANS] and retired_drained:
        for d in state[ORPHANS]:
            base = _set(state, ORPHANS, tuple(x for x in state[ORPHANS] if x != d))
            rec = _infl_get(inflight, d)
            if rec is None:
                out.append((('orphan_noop', d), base))
            elif rec[3]:
                out.append((('orphan_complete_published', d),
                            _complete(base, d, rec[1])))
            else:
                out.extend(_fail_item(base, cfg, d, rec, live, 'orphan'))

    # -- supervisor: quiet-window sweep -------------------------------------
    if (state[DEATHS_SEEN] and not state[ORPHANS] and retired_drained and inflight
            and all((not s[S_ALIVE]) or (s[S_SUP] == -1 and not s[S_CHAN])
                    for s in slots)):
        # the supervisor cannot see live workers' dispatch pipes — the sweep
        # deliberately fires even when an item still sits in one (the model's
        # timers-as-structure over-approximation); exactly-once must survive
        # the resulting stale processing
        outcomes_per_item = []
        for rec in inflight:
            d, item, att, pub = rec
            if pub:
                outcomes_per_item.append([('complete', d, rec, None)])
            elif att < cfg.retries:
                outcomes_per_item.append([('requeue', d, rec, w) for w in live])
            elif cfg.policy == 'skip':
                outcomes_per_item.append([('quarantine', d, rec, None)])
            else:
                outcomes_per_item.append([('poison_raise', d, rec, None)])
        for combo in itertools.product(*outcomes_per_item):
            ns = state
            label_parts = []
            for action, d, rec, w in combo:
                if action == 'complete':
                    ns = _complete(ns, d, rec[1])
                    label_parts.append(('complete', d, None, None))
                elif action == 'requeue':
                    nd, ns = _requeue(ns, cfg, d, rec, w)
                    label_parts.append(('requeue', d, nd, w))
                elif action == 'quarantine':
                    ns = _quarantine(ns, d, rec[1])
                    label_parts.append(('quarantine', d, None, None))
                else:
                    ns = _set(_complete(ns, d, rec[1]), RAISED, 1)
                    label_parts.append(('poison_raise', d, None, None))
            out.append((('sweep', tuple(label_parts)), ns))

    if not canonical:
        return out
    return [(label, canonicalize(ns, cfg)) for label, ns in out]


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def check_state(state, cfg):
    """First violated safety invariant of ``state``, or None."""
    if any(v > 1 for v in state[DELIVERED]):
        return 'exactly_once_delivery'
    if any(v > 1 for v in state[COMPLETED]):
        return 'exactly_once_completion'
    if state[COMPLETED_ITEMS] != sum(state[COMPLETED]):
        return 'no_double_count'
    if any(v > 1 for v in state[QUARANTINED]) or \
            any(rec[2] > cfg.retries for rec in state[INFLIGHT]):
        return 'bounded_attempts'
    return None


def check_terminal(state, cfg):
    """'epoch_termination' when a quiescent (transition-free) non-raised state
    has unresolved items — a lost item or stuck accounting."""
    if state[RAISED]:
        return None  # the raise policy aborts the epoch by contract
    if sum(state[COMPLETED]) != cfg.items or state[INFLIGHT] or state[ORPHANS]:
        return 'epoch_termination'
    return None


# ---------------------------------------------------------------------------
# replay helpers (trace -> spec, trace -> runtime monitor)
# ---------------------------------------------------------------------------

def apply_label(state, cfg, label):
    """The successor of ``state`` reached by ``label``, or None when ``label``
    is not enabled — the validity test trace minimization is built on."""
    for lab, ns in successors(state, cfg):
        if lab == label:
            return ns
    return None


def replay_trace(cfg, trace):
    """Replay ``trace`` (a label sequence) from the initial state; returns the
    final state or raises :class:`ProtocolViolation` on an unenabled label."""
    state = canonicalize(initial_state(cfg), cfg)
    for i, label in enumerate(trace):
        ns = apply_label(state, cfg, label)
        if ns is None:
            raise ProtocolViolation(
                'trace step {} ({!r}) is not enabled in the spec'.format(i, label))
        state = ns
    return state


def events_for_label(label):
    """The runtime-monitor event calls the REAL pool would emit for one spec
    transition — ``(method_name, args...)`` tuples, consumed by
    :func:`replay_into_monitor`. Worker-internal steps (pickup, publish,
    crash...) emit nothing: the monitor, like the supervisor, only sees the
    consumer side."""
    kind = label[0]
    if kind == 'dispatch':
        return [('on_dispatch', label[1], label[2])]
    if kind == 'consume_claim':
        return [('on_message', 'claim', label[2], None)]
    if kind == 'consume_data':
        return [('on_message', 'data', label[2], label[3])]
    if kind == 'consume_done_live':
        return [('on_message', 'done', label[2], True),
                ('on_complete', label[2], True, False)]
    if kind == 'consume_done_stale':
        return [('on_message', 'done', label[2], False)]
    if kind == 'consume_done_stale_counted':
        # the no_stale_drop mutation: the pool books a stale done as live
        return [('on_message', 'done', label[2], True),
                ('on_complete', label[2], True, False)]
    if kind == 'consume_error_stale':
        return [('on_message', 'error', label[2], False)]
    if kind == 'consume_error_requeue':
        return [('on_message', 'error', label[2], True),
                ('on_requeue', label[2], label[3])]
    if kind == 'consume_error_quarantine':
        return [('on_message', 'error', label[2], True),
                ('on_complete', label[2], False, True)]
    if kind == 'consume_error_raise':
        return [('on_message', 'error', label[2], True),
                ('on_complete', label[2], False, False)]
    if kind == 'consume_error_published_complete':
        return [('on_message', 'error', label[2], True),
                ('on_complete', label[2], True, False)]
    if kind in ('orphan_requeue',):
        return [('on_requeue', label[1], label[2])]
    if kind == 'orphan_complete_published':
        return [('on_complete', label[1], True, False)]
    if kind == 'orphan_quarantine':
        return [('on_complete', label[1], False, True)]
    if kind == 'orphan_poison_raise':
        return [('on_complete', label[1], False, False)]
    if kind == 'sweep':
        events = []
        for action, d, nd, _w in label[1]:
            if action == 'complete':
                events.append(('on_complete', d, True, False))
            elif action == 'requeue':
                events.append(('on_requeue', d, nd))
            elif action == 'quarantine':
                events.append(('on_complete', d, False, True))
            else:
                events.append(('on_complete', d, False, False))
        return events
    return []  # worker-internal / noop steps: invisible to the consumer


def replay_into_monitor(trace, monitor):
    """Feed the consumer-visible projection of a spec trace through a runtime
    :class:`~petastorm_tpu_torch.analysis.protocol.monitor.ProtocolMonitor`. Legal
    traces must be accepted; mutation counterexamples must raise
    :class:`ProtocolViolation` — the soundness/teeth contract tying the model
    checker and the monitor together."""
    for label in trace:
        for event in events_for_label(label):
            getattr(monitor, event[0])(*event[1:])


__all__ = [
    'INVARIANTS', 'MUTATIONS', 'ProtocolViolation', 'SpecConfig',
    'apply_label', 'canonicalize', 'check_state', 'check_terminal',
    'events_for_label', 'initial_state', 'replay_into_monitor', 'replay_trace',
    'successors',
]
