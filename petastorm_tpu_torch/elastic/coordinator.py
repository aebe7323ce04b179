"""Elastic resharding coordinator, and the ventilator that drives it.

Twin of ``petastorm_tpu/elastic/coordinator.py`` with the same on-disk
layout, so hosts of both packages can share one coordination directory. The
coordinator owns one host's view of it:

* ``members/``: heartbeat leases (:mod:`petastorm_tpu_torch.elastic.membership`);
* ``generations/NNNNNNNN.json``: the generation log. Each file pins one
  generation's sorted member list; it is published with ``os.link`` (or
  ``O_EXCL``), so exactly one proposal wins each number and the sequence is
  monotonic by construction. The *current* generation is the highest file;
* ``epochs/NNNNNN/done/NNNNNNNN``: the per-epoch scoreboard. A row group is
  **committed** when its marker exists; markers are created with
  ``O_EXCL``, so exactly one host wins each commit however racy the handoff
  was: the COMMIT is exactly-once by construction. Sample delivery is
  at-least-once in one narrow window: a host stalled past ``lease_s`` but
  still running may have its in-flight groups adopted, and then both yield
  those rows; only one wins the marker, and ``lease_s`` bounds the exposure;
* ``epochs/NNNNNN/inflight/<host>.json``: each host's claimed but not yet
  committed row groups. A *live* host's are never claimed by anyone else; a
  dead host's (lease expired or gone) become adoptable, counted as
  ``rowgroups_handed_off``;
* ``commits/<host>.jsonl``: an append-only log of the commits this host won
  (``epoch``, ``item``, global ``rank``, ``generation``, ``host``). The union
  of all hosts' logs is the pod's committed stream.

The protocol, per poll: scan the leases; if the alive set differs from the
current generation's member set, propose generation N+1 with the alive set
(losers adopt the winner's file). Unstarted row groups re-partition under the
new map at once: ownership is the pure function
:func:`~petastorm_tpu_torch.elastic.shardmap.owner_of`, so no state migrates.
In-flight row groups stay pinned to the claiming host while its lease lives,
and are adopted by their new owner only after it expires.

The JAX coordinator also reports each event to the runtime elastic monitor,
which is not ported (:func:`~petastorm_tpu_torch.elastic.resolve_elastic`
refuses it).
"""

from __future__ import annotations

import errno
import itertools
import json
import logging
import os
import threading
import time
from collections import OrderedDict

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.elastic.membership import MembershipRegistry
from petastorm_tpu_torch.elastic.shardmap import ShardMap

logger = logging.getLogger(__name__)


def _atomic_write(path, payload, retry):
    tmp = '{}.tmp.{}'.format(path, os.getpid())

    def write_and_swap():
        with open(tmp, 'w') as f:
            f.write(payload)
        os.rename(tmp, path)

    retry.call(write_and_swap)


class ElasticCoordinator(object):
    """One host's protocol engine over the shared coordination directory.

    Not thread-safe by itself; the elastic ventilator serializes calls on
    its feeding thread, except :meth:`commit` which may run on the
    consumer's results thread — commit only touches ``O_EXCL`` markers,
    the append-only log, and lock-guarded caches.
    """

    def __init__(self, config, num_items, seed=None, shuffle=True):
        self.config = config
        self.num_items = int(num_items)
        self.seed = seed
        self.shuffle = bool(shuffle)
        self.host_id = config.host_id
        self.coord_dir = config.coord_dir
        self.poll_s = config.poll_s
        self._retry = config.retry_policy()
        self.registry = MembershipRegistry(self.coord_dir, self.host_id,
                                           lease_s=config.lease_s,
                                           retry=self._retry)
        self._generations_dir = os.path.join(self.coord_dir, 'generations')
        self._epochs_dir = os.path.join(self.coord_dir, 'epochs')
        self._commit_log = os.path.join(self.coord_dir, 'commits',
                                        self.host_id + '.jsonl')
        self._lock = threading.Lock()
        self._generation = 0
        self._members = ()
        self._maps = {}             # (generation, epoch) -> ShardMap
        self._last_alive = ()
        self._counted_expired = set()
        self._last_scan = 0.0
        self._epoch_state = {}      # epoch -> dict(done=set, deferred=set,
                                    #   dead_inflight=set, ventilated=set,
                                    #   inflight=set, handed_off=set)
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._started:
            return
        self._retry.call(os.makedirs, self._generations_dir, exist_ok=True)
        self._retry.call(os.makedirs, self._epochs_dir, exist_ok=True)
        self._retry.call(os.makedirs, os.path.dirname(self._commit_log),
                         exist_ok=True)
        self.registry.join()
        self._started = True
        self.poll(epoch=None, force=True)

    def close(self):
        if self._started:
            self.registry.leave()
            self._started = False

    # -- generation log ----------------------------------------------------

    def _gen_path(self, generation):
        return os.path.join(self._generations_dir,
                            '{:08d}.json'.format(generation))

    def _read_current_generation(self):
        try:
            names = self._retry.call(os.listdir, self._generations_dir)
        except OSError as e:
            if getattr(e, 'errno', None) == errno.ENOENT:
                return 0, ()
            raise
        numbers = sorted(int(n.split('.')[0]) for n in names
                         if n.endswith('.json') and n.split('.')[0].isdigit())
        for generation in reversed(numbers):
            try:
                data = self._retry.call(self._read_json,
                                        self._gen_path(generation))
            except (OSError, ValueError):
                # a peer's publish not yet fully visible (eventual-consistency
                # shared fs) or an I/O hiccup past the retry budget: skip it
                # this poll — a later scan will see the complete file
                continue
            return generation, tuple(data.get('members') or ())
        return self._generation, self._members

    def _read_json(self, path):
        with open(path, 'r') as f:
            return json.loads(f.read())

    def _propose_generation(self, generation, members):
        """Atomic exclusive proposal: the payload is staged in a private tmp
        file and published with ``os.link`` — link is atomic AND exclusive
        (EEXIST when a peer won the number), so a concurrent reader sees
        either no file or a complete one, never a partial write."""
        payload = json.dumps({'generation': generation,
                              'members': list(members),
                              'proposed_by': self.host_id})
        path = self._gen_path(generation)
        tmp = '{}.tmp.{}'.format(path, os.getpid())
        try:
            with open(tmp, 'w') as f:
                f.write(payload)
            try:
                os.link(tmp, path)
                return True
            except OSError as e:
                if getattr(e, 'errno', None) not in (errno.EPERM, errno.ENOSYS,
                                                     errno.EOPNOTSUPP):
                    return False
        except OSError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # hard links unsupported (some FUSE object-store mounts): fall back to
        # O_EXCL + write — not atomic, but readers skip a torn file and pick
        # it up complete on a later poll
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False
        try:
            os.write(fd, payload.encode('utf-8'))
        finally:
            os.close(fd)
        return True

    # -- membership / resharding poll -------------------------------------

    def poll(self, epoch=None, force=False):
        """Refresh the membership + scoreboard view (rate-limited to one
        filesystem scan per ``poll_s``); advance the generation when the
        alive set drifted from the current generation's member set."""
        now = time.time()
        if not force and (now - self._last_scan) < self.poll_s:
            return
        self._last_scan = now

        infos = self.registry.scan(now=now)
        alive = set(m.host for m in infos if m.alive)
        alive.add(self.host_id)     # our own lease is renewed by our thread
        alive = tuple(sorted(alive))
        expired = tuple(sorted(m.host for m in infos if m.expired))

        for host in expired:
            if host not in self._counted_expired:
                self._counted_expired.add(host)
                obs.count('elastic_lease_expirations')
        for host in alive:
            if host in self._counted_expired:
                self._counted_expired.discard(host)   # rejoined
        self._last_alive = alive

        current, members = self._read_current_generation()
        if alive and members != alive:
            with obs.stage('reshard', cat='elastic'):
                self._propose_generation(current + 1, alive)
                current, members = self._read_current_generation()

        if current > self._generation and members:
            self._generation = current
            self._members = members
            obs.count('reshard_generations')
            obs.gauge_set('elastic_generation', current)
            obs.gauge_set('elastic_member_count', len(members))

        if epoch is not None:
            self._refresh_epoch(epoch, alive)

    def _refresh_epoch(self, epoch, alive):
        with self._lock:
            # consumer threads retire stale epochs (del) under the lock; an
            # unlocked get here races the dict resize. The state dict itself
            # stays valid once fetched — per-epoch state is only ever dropped,
            # never rebound.
            state = self._epoch_state.get(epoch)
        if state is None:
            return
        done = set()
        try:
            for name in self._retry.call(os.listdir, self._done_dir(epoch)):
                if name.isdigit():
                    done.add(int(name))
        except OSError:
            pass
        deferred, dead_inflight = set(), set()
        try:
            names = self._retry.call(os.listdir, self._inflight_dir(epoch))
        except OSError:
            names = []
        for name in sorted(names):
            if not name.endswith('.json'):
                continue
            host = name[:-len('.json')]
            if host == self.host_id:
                continue
            try:
                data = self._retry.call(
                    self._read_json, os.path.join(self._inflight_dir(epoch), name))
            except (OSError, ValueError):
                # unreadable peer inflight: assume it pins its items (the
                # conservative direction — never adopt on an I/O hiccup)
                continue
            items = set(int(i) for i in data.get('items') or ())
            if host in alive:
                deferred |= items
            else:
                dead_inflight |= items
        with self._lock:
            state['done'] |= done
            state['deferred'] = deferred - state['done']
            state['dead_inflight'] = dead_inflight - state['done']
            pending_commits = sorted(state['commit_retry'] - state['done'])
        for item in pending_commits:
            # markers that could not be created when the item was delivered
            # (persistent fs error): the item is still ours, keep trying —
            # commit() re-resolves won/exists/error each attempt
            self.commit(epoch, item)

    # -- per-epoch scoreboard ----------------------------------------------

    def _epoch_dir(self, epoch):
        return os.path.join(self._epochs_dir, '{:06d}'.format(epoch))

    def _done_dir(self, epoch):
        return os.path.join(self._epoch_dir(epoch), 'done')

    def _inflight_dir(self, epoch):
        return os.path.join(self._epoch_dir(epoch), 'inflight')

    def _inflight_path(self, epoch):
        return os.path.join(self._inflight_dir(epoch),
                            self.host_id + '.json')

    def begin_epoch(self, epoch):
        self._retry.call(os.makedirs, self._done_dir(epoch), exist_ok=True)
        self._retry.call(os.makedirs, self._inflight_dir(epoch), exist_ok=True)
        with self._lock:
            self._epoch_state.setdefault(epoch, {
                'done': set(), 'deferred': set(), 'dead_inflight': set(),
                'ventilated': set(), 'inflight': set(), 'handed_off': set(),
                'commit_retry': set()})
        # bounded memory: forget scoreboards of long-finished epochs
        with self._lock:
            stale = sorted(self._epoch_state)[:-4]
            for e in stale:
                del self._epoch_state[e]
        self.poll(epoch=epoch, force=True)

    def shard_map(self, epoch):
        key = (self._generation, epoch)
        cached = self._maps.get(key)
        if cached is None:
            cached = ShardMap(self._generation, self._members, self.num_items,
                              self.seed, epoch, shuffle=self.shuffle)
            self._maps = {key: cached}   # only the live generation matters
        return cached

    def claimable_items(self, epoch):
        """Row groups this host should ventilate next, in global emission
        order: owned under the current map, not committed, not pinned by a
        live peer's in-flight claim, not already ventilated locally."""
        if not self._members or self.host_id not in self._members:
            return []       # not (yet) part of the current generation
        smap = self.shard_map(epoch)
        with self._lock:
            state = self._epoch_state[epoch]
            blocked = state['done'] | state['deferred'] | state['ventilated']
        return [item for item in smap.owned_items(self.host_id)
                if item not in blocked]

    def note_ventilated(self, epoch, item):
        """Record a local claim just before dispatching ``item`` to the
        pool: the in-flight file is the claim other hosts honor."""
        with self._lock:
            state = self._epoch_state[epoch]
            state['ventilated'].add(item)
            state['inflight'].add(item)
            handed_off = (item in state['dead_inflight']
                          and item not in state['handed_off'])
            if handed_off:
                state['handed_off'].add(item)
            inflight = sorted(state['inflight'])
        if handed_off:
            obs.count('rowgroups_handed_off')
        self._write_inflight(epoch, inflight)

    def _write_inflight(self, epoch, items):
        payload = json.dumps({'host': self.host_id,
                              'generation': self._generation,
                              'items': items})
        try:
            _atomic_write(self._inflight_path(epoch), payload, self._retry)
        except OSError:
            pass    # a lost claim write only risks duplicate *reads*, never
                    # duplicate commits — the done marker stays exclusive

    def is_done(self, epoch, item):
        with self._lock:
            return item in self._epoch_state[epoch]['done']

    def _create_marker(self, epoch, item):
        """Try to create ``item``'s O_EXCL marker: ``'won'`` (this host's
        marker), ``'exists'`` (a peer's), or ``'error'`` (the marker is
        verifiably NOT on disk — the item must stay uncommitted)."""
        path = os.path.join(self._done_dir(epoch), '{:08d}'.format(item))

        def create_marker():
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return 'exists'
            os.close(fd)
            return 'won'

        try:
            return self._retry.call(create_marker)
        except OSError:
            return 'error'

    def commit(self, epoch, item):
        """Try to win ``item``'s commit marker. True when this host's
        delivery is THE delivery; False when a peer already committed it —
        or when the marker could not be created at all (then the item stays
        uncommitted locally and the marker is retried on later polls:
        counting it done with no marker on disk would let this host finish
        an epoch its peers can never see complete)."""
        outcome = self._create_marker(epoch, item)
        with self._lock:
            state = self._epoch_state.get(epoch)
            inflight = None
            if state is not None:
                if outcome == 'error':
                    state['commit_retry'].add(item)
                else:
                    state['done'].add(item)
                    state['inflight'].discard(item)
                    state['commit_retry'].discard(item)
                    inflight = sorted(state['inflight'])
        won = outcome == 'won'
        if won:
            obs.count('elastic_commits')
            self._append_commit(epoch, item)
        if inflight is not None:
            self._write_inflight(epoch, inflight)
        return won

    def _append_commit(self, epoch, item):
        smap = self.shard_map(epoch)
        line = json.dumps({'epoch': epoch, 'item': item,
                           'rank': smap.rank(item),
                           'generation': self._generation,
                           'host': self.host_id}) + '\n'
        try:
            with open(self._commit_log, 'a') as f:
                f.write(line)
                f.flush()
        except OSError:
            pass    # the audit log is diagnostic; markers are the truth

    def epoch_complete(self, epoch):
        with self._lock:
            return len(self._epoch_state[epoch]['done']) >= self.num_items

    def undone_items(self, epoch):
        """Cluster-wide uncommitted row groups (the portable checkpoint
        cursor: any single host's snapshot covers the whole pod)."""
        with self._lock:
            state = self._epoch_state.get(epoch)
            done = set(state['done']) if state is not None else set()
        return [i for i in range(self.num_items) if i not in done]

    # -- introspection -----------------------------------------------------

    @property
    def generation(self):
        return self._generation

    @property
    def members(self):
        return self._members

    def status(self):
        return {'host': self.host_id, 'generation': self._generation,
                'members': list(self._members),
                'alive': list(self._last_alive)}


class ElasticVentilator(object):
    """Drop-in for :class:`~petastorm_tpu_torch.workers.ConcurrentVentilator`
    that ventilates only the row groups this host owns under the
    coordinator's live shard map.

    The same pool-facing contract: tagged ``_seq`` dispatch under a minted
    trace, ``processed_item`` releases the in-flight budget once per item,
    ``mark_delivered`` fires on final delivery; here it also tries to win the
    item's global commit marker, which feeds the exactly-once scoreboard. The
    commit happens AFTER the rows were yielded, so a lost race after a false
    lease expiry means the rows went out twice pod-wide (the module
    docstring; ``lease_s`` bounds that window). The pools call
    ``processed_item`` before the delivery callback: the budget and the
    commit are kept apart, so each delivered item commits once on every
    pool. ``set_max_queue_size`` retargets the budget for the autotuner.
    """

    def __init__(self, ventilate_fn, items_to_ventilate, coordinator, iterations=1,
                 max_ventilation_queue_size=None):
        if iterations is not None and (not isinstance(iterations, int) or iterations < 1):
            raise ValueError('iterations must be a positive integer or None, got {!r}'.format(
                iterations))
        if coordinator.num_items != len(items_to_ventilate):
            raise ValueError('coordinator covers {} items but {} were given'.format(
                coordinator.num_items, len(items_to_ventilate)))
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._coord = coordinator
        self._iterations = iterations
        self._max_q = (max_ventilation_queue_size if max_ventilation_queue_size is not None
                       else max(1, len(self._items)))
        #: the trace-id namespace of this ventilator's items ('<ns>:<seq>')
        self.trace_ns = os.urandom(4).hex()
        # every field below is guarded by _cv's lock
        self._cv = threading.Condition()
        self._in_flight = 0
        self._seq = 0
        self._undelivered = OrderedDict()   # seq -> (epoch, item)
        self._epoch_base = 0
        self._next_epoch = 0
        self._current_epoch = 0
        self._epochs_remaining = iterations
        self._stop_requested = False
        self._completed = len(self._items) == 0
        self._thread = None

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Ventilator already started')
        if self.completed():
            return
        self._coord.start()
        self._thread = threading.Thread(target=self._ventilate_loop, daemon=True,
                                        name='pstpu-torch-elastic-ventilator')
        self._thread.start()

    def processed_item(self, seq=None):
        """Called by the pool once per ventilated item that finished."""
        with self._cv:
            self._in_flight -= 1
            self._cv.notify()

    def mark_delivered(self, seq):
        """The item ventilated with ``_seq == seq`` was fully delivered: try
        to commit it. Idempotent; ``None`` and unknown seqs are ignored."""
        if seq is None:
            return
        with self._cv:
            info = self._undelivered.pop(seq, None)
        if info is not None:
            self._coord.commit(*info)

    def state_dict(self):
        """The CLUSTER-wide uncommitted row groups of the current epoch (any
        one host's snapshot covers the pod) and the epochs left after it.
        ``rng_state`` is None: the elastic shuffle is a pure function of
        ``(seed, epoch)``, so there is no RNG stream to carry."""
        with self._cv:
            epoch = self._current_epoch
            remaining = self._epochs_remaining
        return {'replay_indices': sorted(self._coord.undone_items(epoch)),
                'iterations_remaining': remaining,
                'rng_state': None}

    def set_max_queue_size(self, n):
        """Set the in-flight item budget at run time (the autotuner's knob)."""
        with self._cv:
            self._max_q = max(1, int(n))
            self._cv.notify_all()

    def completed(self):
        """True when no more items will ever be ventilated."""
        with self._cv:
            return self._completed

    def reset(self):
        """Run the requested iterations again. Epoch numbers keep advancing
        across resets: the scoreboard is per epoch, so a reset must not
        collide with epochs already committed."""
        if not self.completed():
            raise RuntimeError('Cannot reset ventilator while ventilation is still in progress')
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        with self._cv:
            self._stop_requested = False
            self._completed = len(self._items) == 0
            self._epoch_base = self._next_epoch
            self._epochs_remaining = self._iterations
            self._in_flight = 0
            self._undelivered.clear()
        self.start()

    def stop(self):
        """Stop ventilating and leave the pod: the lease is removed, so the
        peers re-partition this host's share at their next poll."""
        with self._cv:
            self._stop_requested = True
            self._cv.notify_all()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join()
        with self._cv:
            self._completed = True
        self._coord.close()

    # -- the feeding loop --------------------------------------------------

    def _stopping(self):
        with self._cv:
            return self._stop_requested

    def _ventilate_loop(self):
        try:
            epochs = (itertools.count() if self._iterations is None
                      else range(self._iterations))
            for epoch_in_run in epochs:
                if self._stopping():
                    break
                with self._cv:
                    epoch = self._epoch_base + epoch_in_run
                    self._current_epoch = epoch
                    self._next_epoch = epoch + 1
                    self._epochs_remaining = (None if self._iterations is None
                                              else self._iterations - epoch_in_run - 1)
                self._run_epoch(epoch)
        except Exception:  # noqa: BLE001 - see below
            # a dead feed thread must not leave consumers blocked forever on
            # a queue that will never fill: mark the ventilation complete so
            # the reader drains and stops, and leave the cause in the log
            logger.exception('elastic ventilator feed thread died; marking ventilation '
                             'complete')
            obs.count('elastic_ventilator_errors')
        finally:
            with self._cv:
                self._completed = True

    def _run_epoch(self, epoch):
        coord = self._coord
        coord.begin_epoch(epoch)
        while not self._stopping():
            coord.poll(epoch=epoch)
            if coord.epoch_complete(epoch):
                return
            claimable = coord.claimable_items(epoch)
            if not claimable:
                # nothing to do here: peers are finishing their share, or
                # in-flight groups are pinned by live leases
                self._stop_wait(coord.poll_s)
                continue
            item = claimable[0]
            with self._cv:
                while self._in_flight >= self._max_q and not self._stop_requested:
                    self._cv.wait(timeout=0.1)
                if self._stop_requested:
                    return
                self._in_flight += 1
                seq = self._seq
                self._seq += 1
                self._undelivered[seq] = (epoch, item)
            if coord.is_done(epoch, item):
                # a peer committed it while this host waited on the budget
                with self._cv:
                    self._undelivered.pop(seq, None)
                    self._in_flight -= 1
                    self._cv.notify()
                continue
            coord.note_ventilated(epoch, item)
            # the item's trace: the ventilate span is the root's first child,
            # and the pool's ventilate captures the context
            with obs.mint_trace(self.trace_ns, seq):
                with obs.stage('ventilate', cat='ventilator'):
                    self._ventilate_fn(**dict(self._items[item], _seq=seq))

    def _stop_wait(self, seconds):
        deadline = time.monotonic() + seconds
        with self._cv:
            while not self._stop_requested:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._cv.wait(timeout=min(remaining, 0.1))


__all__ = ['ElasticCoordinator', 'ElasticVentilator']
