"""Ventilator: feeds work items into a pool with a bounded in-flight count.

Trimmed twin of ``ConcurrentVentilator`` and ``FairShareVentilator`` in
``petastorm_tpu/workers/ventilator.py``. The per-epoch reshuffle is the same
``np.random.default_rng(seed).permutation`` draw, so a seed gives the JAX
package's row-group order.

Read-position checkpoints: with ``tag_items`` every ventilated item carries a
``_seq`` kwarg, the ventilator keeps the items not yet *delivered* to the
consumer (the results reader calls :meth:`ConcurrentVentilator.mark_delivered`
when an item's last row is yielded), and :meth:`ConcurrentVentilator.state_dict`
/ ``resume_state`` capture and restore the position: undelivered items and
the unventilated tail of the current epoch replay first, then the remaining
epochs continue from the saved RNG state. The states are the JAX package's
plain dicts, so either package resumes the other's.

The serve daemon's :class:`FairShareVentilator` multiplexes many tenants'
item streams onto one pool by weighted round-robin, with a per-tenant
in-flight budget; for the same tenants, weights, budgets and completions it
dispatches the JAX package's sequence.

Telemetry: each dispatch is a ``ventilate`` stage; a tagged item's dispatch
runs inside :func:`~petastorm_tpu_torch.observability.mint_trace` keyed on
``(trace_ns, _seq)``, so the pool captures the item's trace context as it
ventilates. :meth:`ConcurrentVentilator.set_max_queue_size` is the
autotuner's in-flight budget.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch import observability as obs


class VentilatorBase(object):
    """What a pool calls on the ventilator it was started with."""

    def start(self):
        raise NotImplementedError

    def processed_item(self):
        raise NotImplementedError

    def completed(self):
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError


class ConcurrentVentilator(VentilatorBase):
    """Ventilates ``items_to_ventilate`` (kwargs dicts for ``ventilate_fn``)
    from a background thread.

    :param iterations: passes over the items; ``None`` = infinite
    :param max_ventilation_queue_size: max in-flight (ventilated - processed) items
    :param randomize_item_order: reshuffle item order before each epoch
    :param random_seed: seed of the reshuffle RNG (``None`` = nondeterministic)
    :param tag_items: ventilate each item with a ``_seq`` kwarg and track its
        delivery, for checkpoints (the pools pop ``_seq``; plain callables
        need not understand it, so it is off by default)
    :param resume_state: a dict from :meth:`state_dict` (needs
        ``tag_items``); ``iterations`` is then ignored: the saved replay
        indices are ventilated first, in their order, then the saved number
        of remaining epochs with the saved RNG state. ``items_to_ventilate``
        must be the list the state was taken over.
    """

    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 max_ventilation_queue_size=None, randomize_item_order=False, random_seed=None,
                 tag_items=False, resume_state=None):
        if iterations is not None and (not isinstance(iterations, int) or iterations < 1):
            raise ValueError('iterations must be a positive integer or None, got {!r}'.format(iterations))
        if resume_state is not None and not tag_items:
            raise ValueError('resume_state requires tag_items=True')
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._requested_iterations = iterations
        self._tag_items = tag_items
        self._randomize_item_order = randomize_item_order
        self._rng = np.random.default_rng(random_seed)
        if resume_state is not None:
            self._replay_indices = list(resume_state['replay_indices'])
            bad = [i for i in self._replay_indices if not 0 <= i < len(self._items)]
            if bad:
                raise ValueError('resume_state replay indices {} out of range for {} work '
                                 'items'.format(bad, len(self._items)))
            self._iterations_remaining = resume_state['iterations_remaining']
            if resume_state.get('rng_state') is not None:
                self._rng.bit_generator.state = resume_state['rng_state']
        else:
            self._replay_indices = None
            self._iterations_remaining = iterations
        self._max_in_flight = (max_ventilation_queue_size if max_ventilation_queue_size is not None
                               else max(1, len(self._items)))
        self._in_flight = 0
        # every field below is guarded by _cv's lock; items are tracked by
        # their index into the item list, so states stay small and picklable
        # whatever the items hold (a predicate may be a lambda)
        self._cv = threading.Condition()
        self._seq = 0
        self._undelivered = OrderedDict()  # seq -> item index: ventilated, not delivered
        self._epoch_indices = []           # the current pass's item indices, in order
        self._epoch_pos = 0                # next position of _epoch_indices to ventilate
        self._epochs_after_current = self._iterations_remaining
        self._stop_requested = False
        self._completed = not self._items and not self._replay_indices
        self._thread = None
        #: the trace-id namespace of this ventilator's items ('<ns>:<seq>')
        self.trace_ns = os.urandom(4).hex()

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Ventilator already started')
        if self.completed():
            return
        self._thread = threading.Thread(target=self._ventilate_loop, daemon=True,
                                        name='pstpu-torch-ventilator')
        self._thread.start()

    def processed_item(self, seq=None):
        """Called by the pool exactly once per ventilated item that finished
        (``seq``: the item's ``_seq``, which this ventilator's global budget
        does not need)."""
        with self._cv:
            self._in_flight -= 1
            self._cv.notify()

    def mark_delivered(self, seq):
        """The item ventilated with ``_seq == seq`` was fully delivered (its
        last row yielded, or it produced none). Idempotent; ``None`` and
        unknown seqs are ignored."""
        if seq is None:
            return
        with self._cv:
            self._undelivered.pop(seq, None)

    def item_of_seq(self, seq):
        """The index of the item ventilated with ``_seq == seq`` while it is
        not delivered, else None."""
        with self._cv:
            return self._undelivered.get(seq)

    def state_dict(self):
        """The read position as a picklable dict: resuming from it ventilates
        every item not fully delivered now (in-flight row groups are re-read
        whole), then the unventilated tail of the current epoch, then the
        remaining epochs with the RNG state restored."""
        if not self._tag_items:
            raise RuntimeError('state_dict() requires tag_items=True (delivery is not tracked '
                               'otherwise, so the read position is unknown)')
        with self._cv:
            replay = list(self._undelivered.values()) + self._epoch_indices[self._epoch_pos:]
            return {'replay_indices': replay,
                    'iterations_remaining': self._epochs_after_current,
                    'rng_state': self._rng.bit_generator.state}

    def set_max_queue_size(self, n):
        """Set the in-flight item budget at run time (the autotuner follows
        the pool's size with it). A smaller budget cancels nothing: the
        thread waits until completions bring the in-flight count under it."""
        with self._cv:
            self._max_in_flight = max(1, int(n))
            self._cv.notify_all()

    def upcoming_items(self, max_items):
        """A read-only peek at the next (up to ``max_items``) items this
        ventilator will emit: the unventilated head of the current pass, in
        its exact shuffled order. The chunk prefetcher
        (:mod:`petastorm_tpu_torch.chunkstore.prefetch`) fetches remote
        column chunks ahead of the workers from it. Items already ventilated
        are not included; between passes the list is empty until the
        feeding thread lays out the next pass."""
        with self._cv:
            indices = self._epoch_indices[self._epoch_pos:self._epoch_pos + max_items]
            return [self._items[i] for i in indices]

    def completed(self):
        """True when no more items will ever be ventilated."""
        with self._cv:
            return self._completed

    def reset(self):
        """Ventilate the requested number of iterations again. Only valid
        after the previous run completed."""
        if not self.completed():
            raise RuntimeError('Cannot reset ventilator while ventilation is still in progress')
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        with self._cv:
            self._replay_indices = None
            self._completed = not self._items
            self._stop_requested = False
            self._iterations_remaining = self._requested_iterations
            self._in_flight = 0
            self._undelivered.clear()
            self._epoch_indices = []
            self._epoch_pos = 0
            self._epochs_after_current = self._requested_iterations
        self.start()

    def stop(self):
        with self._cv:
            self._stop_requested = True
            self._cv.notify_all()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join()
        with self._cv:
            self._completed = True

    def _lay_out_pass(self, first_pass):
        """Under the lock: the next pass's item indices and whether it counts
        as an epoch, or None when no pass is left. A resumed run's first pass
        replays the saved items in their order and consumes no epoch (it is
        the rest of the interrupted one)."""
        if first_pass and self._replay_indices is not None:
            indices, counted = list(self._replay_indices), False
        else:
            if self._iterations_remaining is not None and self._iterations_remaining <= 0:
                return None
            indices, counted = list(range(len(self._items))), True
            if self._randomize_item_order:
                indices = [int(i) for i in self._rng.permutation(len(self._items))]
        self._epoch_indices = indices  # noqa: PT100 - the only caller, _ventilate_loop, holds _cv
        self._epoch_pos = 0  # noqa: PT100 - the only caller, _ventilate_loop, holds _cv
        self._epochs_after_current = (self._iterations_remaining - 1  # noqa: PT100 - caller holds _cv
                                      if counted and self._iterations_remaining is not None
                                      else self._iterations_remaining)
        return indices, counted

    def _ventilate_loop(self):
        first_pass = True
        while True:
            with self._cv:
                if self._stop_requested:
                    break
                laid_out = self._lay_out_pass(first_pass)
            if laid_out is None:
                break
            first_pass = False
            indices, counted = laid_out
            for index in indices:
                with self._cv:
                    while self._in_flight >= self._max_in_flight and not self._stop_requested:
                        self._cv.wait(timeout=0.1)
                    if self._stop_requested:
                        return
                    self._in_flight += 1
                    self._epoch_pos += 1
                    seq = None
                    if self._tag_items:
                        seq = self._seq
                        self._seq += 1
                        self._undelivered[seq] = index
                item = self._items[index]
                if self._tag_items:
                    # the item's trace: the ventilate span is the root's first
                    # child, and the pool's ventilate captures the context
                    with obs.mint_trace(self.trace_ns, seq):
                        with obs.stage('ventilate', cat='ventilator'):
                            self._ventilate_fn(**dict(item, _seq=seq))
                else:
                    with obs.stage('ventilate', cat='ventilator'):
                        self._ventilate_fn(**item)
            with self._cv:
                if counted and self._iterations_remaining is not None:
                    self._iterations_remaining -= 1
        with self._cv:
            self._completed = True


class _TenantQueue(object):
    """One tenant's item stream inside a :class:`FairShareVentilator`: its
    items, remaining epochs, weight, in-flight budget and counters. Mutated
    under the ventilator's condition lock only."""

    __slots__ = ('tenant_id', 'items', 'iterations_remaining', 'weight',
                 'max_in_flight', 'in_flight', 'dispatched', 'completed',
                 'epoch_indices', 'epoch_pos', 'rng', 'shuffle', 'credits',
                 'finished', 'removed')

    def __init__(self, tenant_id, items, iterations, weight, max_in_flight, shuffle, seed):
        self.tenant_id = tenant_id
        self.items = list(items)
        self.iterations_remaining = iterations
        self.weight = max(1, int(weight))
        self.max_in_flight = max(1, int(max_in_flight))
        self.in_flight = 0
        self.dispatched = 0
        self.completed = 0
        self.epoch_indices = []
        self.epoch_pos = 0
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.credits = 0
        self.finished = not self.items or iterations == 0
        self.removed = False

    def _lay_out_epoch(self):
        """Start the next epoch's order, or mark the stream finished."""
        if self.iterations_remaining is not None:
            if self.iterations_remaining <= 0:
                self.finished = True
                return False
            self.iterations_remaining -= 1
        order = list(range(len(self.items)))
        if self.shuffle:
            order = [int(i) for i in self.rng.permutation(len(order))]
        self.epoch_indices = order
        self.epoch_pos = 0
        return True

    def next_item(self):
        """The next item to dispatch, or None when the stream is exhausted
        (the scheduler checks the in-flight budget)."""
        if self.finished:
            return None
        if self.epoch_pos >= len(self.epoch_indices):
            if not self._lay_out_epoch():
                return None
        item = self.items[self.epoch_indices[self.epoch_pos]]
        self.epoch_pos += 1
        return item

    def exhausted(self):
        """No further dispatch will ever happen for this tenant."""
        if self.removed:
            return True
        if not self.finished:
            if self.epoch_pos < len(self.epoch_indices):
                return False
            if self.iterations_remaining is None or self.iterations_remaining > 0:
                return False
        return True

    def stats(self):
        return {'weight': self.weight, 'max_in_flight': self.max_in_flight,
                'in_flight': self.in_flight, 'dispatched': self.dispatched,
                'completed': self.completed, 'finished': self.finished,
                'removed': self.removed}


class FairShareVentilator(VentilatorBase):
    """Multiplexes many tenants' item streams onto one pool with weighted
    fair-share scheduling: the serve daemon's broker half.

    Each tenant registers its items, an epoch count, a ``weight`` and a
    ``max_in_flight`` budget (admission control: a tenant never holds more
    pool slots than its budget, however fast it drains). Dispatch is
    starvation-free weighted round-robin: each cycle refills every eligible
    tenant's credits to its weight, then drains them in rotation, so a
    weight-2 tenant gets two dispatches to a weight-1 tenant's one, and a
    tenant with credits, backlog and budget is never skipped.

    Every dispatch carries a globally unique ``_seq``; the pool reports
    completions through :meth:`processed_item` (``seq``), which releases the
    owning tenant's budget and fires ``on_tenant_done(tenant_id)`` once, when
    the last in-flight item of its last epoch completes. The ventilator is
    long-lived: it completes only when stopped; tenants attach and detach at
    run time, and a removed tenant's in-flight items drain with no done
    callback.
    """

    def __init__(self, ventilate_fn, on_tenant_done=None):
        self._ventilate_fn = ventilate_fn
        self._on_tenant_done = on_tenant_done
        #: the trace-id namespace of the dispatches ('<ns>:<seq>'); the
        #: daemon hands it to its clients, which derive each frame's trace
        #: root from the seq in the ring header
        self.trace_ns = os.urandom(4).hex()
        self._cv = threading.Condition()
        self._tenants = {}          # tenant_id -> _TenantQueue
        self._order = []            # round-robin order of tenant ids
        self._final_stats = {}      # drained tenants' last counters (bounded)
        self._seq = 0
        self._seq_tenant = {}       # seq -> tenant_id of live dispatches
        self._stop_requested = False
        self._completed = False
        self._thread = None

    # -- tenants ---------------------------------------------------------------

    def add_tenant(self, tenant_id, items, iterations=1, weight=1, max_in_flight=2,
                   shuffle=False, seed=None):
        """Register a tenant's stream; dispatching starts on the feeding
        thread's next cycle. Safe mid-run."""
        if iterations is not None and (not isinstance(iterations, int) or iterations < 0):
            raise ValueError('iterations must be a non-negative int or None')
        with self._cv:
            if tenant_id in self._tenants:
                raise ValueError('tenant {!r} already registered'.format(tenant_id))
            tq = _TenantQueue(tenant_id, items, iterations, weight, max_in_flight, shuffle,
                              seed)
            if not tq.finished:
                self._tenants[tenant_id] = tq
                self._order.append(tenant_id)
            self._cv.notify_all()
        if tq.finished:
            # no items or no epochs: the stream ends at once
            self._fire_done(tenant_id)

    def remove_tenant(self, tenant_id):
        """Stop feeding a tenant. Its in-flight items drain (their
        completions release pool budget); no done callback fires."""
        with self._cv:
            tq = self._tenants.get(tenant_id)
            if tq is None:
                return False
            tq.removed = True
            tq.finished = True
            if tq.in_flight == 0:
                self._forget(tenant_id)
            self._cv.notify_all()
        return True

    def _forget(self, tenant_id):
        """Under the lock: drop a drained tenant, keeping its final counters
        for the diagnostics (a finished stream's fair-share occupancy stays
        readable)."""
        tq = self._tenants.pop(tenant_id, None)  # noqa: PT100 - every caller holds _cv
        if tq is not None:
            self._final_stats[tenant_id] = tq.stats()  # noqa: PT100 - caller holds _cv
            while len(self._final_stats) > 64:  # bounded history
                self._final_stats.pop(next(iter(self._final_stats)))  # noqa: PT100 - caller holds _cv
        if tenant_id in self._order:
            self._order.remove(tenant_id)  # noqa: PT100 - every caller holds _cv

    def tenant_stats(self):
        """Per-tenant scheduling counters: the live tenants and the final
        counters of recently drained ones."""
        with self._cv:
            out = dict(self._final_stats)
            out.update({tid: tq.stats() for tid, tq in self._tenants.items()})
            return out

    def set_tenant_weight(self, tenant_id, weight):
        """Retune a tenant's share at run time (from the next credit
        refill). True when the tenant is still registered."""
        with self._cv:
            tq = self._tenants.get(tenant_id)
            if tq is None:
                return False
            tq.weight = max(1, int(weight))
            return True

    def tenant_of_seq(self, seq):
        """The owning tenant of a live dispatch seq (None once completed)."""
        with self._cv:
            return self._seq_tenant.get(seq)

    # -- the pool's side ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Ventilator already started')
        self._thread = threading.Thread(target=self._ventilate_loop, daemon=True,
                                        name='pstpu-torch-fairshare-ventilator')
        self._thread.start()

    def processed_item(self, seq=None):
        """The pool's completion callback: releases the owning tenant's
        budget and fires ``on_tenant_done`` when its stream drained."""
        done_tenant = None
        with self._cv:
            tenant_id = self._seq_tenant.pop(seq, None)
            tq = self._tenants.get(tenant_id) if tenant_id is not None else None
            if tq is not None:
                tq.in_flight -= 1
                tq.completed += 1
                if tq.exhausted() and tq.in_flight == 0:
                    if not tq.removed:
                        done_tenant = tenant_id
                    self._forget(tenant_id)
            self._cv.notify_all()
        if done_tenant is not None:
            self._fire_done(done_tenant)

    def _fire_done(self, tenant_id):
        if self._on_tenant_done is not None:
            self._on_tenant_done(tenant_id)

    def upcoming_items(self, max_items):
        """A read-only peek at the next items across tenants, for the chunk
        prefetcher: each live tenant's unventilated head, interleaved in
        round-robin order."""
        with self._cv:
            heads = []
            for tid in self._order:
                tq = self._tenants[tid]
                if tq.finished:
                    continue
                idxs = tq.epoch_indices[tq.epoch_pos:tq.epoch_pos + max_items]
                heads.append([tq.items[i] for i in idxs])
            out = []
            for layer in zip(*heads) if heads else ():
                out.extend(layer)
                if len(out) >= max_items:
                    break
            return out[:max_items]

    def completed(self):
        """Only a stop completes this ventilator."""
        with self._cv:
            return self._completed

    def stop(self):
        with self._cv:
            self._stop_requested = True
            self._cv.notify_all()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join()
        with self._cv:
            self._completed = True

    # -- the scheduler -----------------------------------------------------------

    def _pick_next(self):
        """Under the lock: the next ``(tenant, item, seq)`` by weighted
        round-robin, or None when nothing is eligible. Credits refill when
        every backlogged tenant is out of them, so weights shape the shares
        without starving anyone."""
        for refill in (False, True):
            if refill:
                eligible = [self._tenants[tid] for tid in self._order
                            if not self._tenants[tid].finished
                            and self._tenants[tid].in_flight < self._tenants[tid].max_in_flight]
                if not eligible:
                    return None
                for tq in eligible:
                    tq.credits = tq.weight
            for tid in list(self._order):
                tq = self._tenants[tid]
                if tq.finished or tq.credits <= 0 or tq.in_flight >= tq.max_in_flight:
                    continue
                item = tq.next_item()
                if item is None:
                    continue
                tq.credits -= 1
                tq.in_flight += 1
                tq.dispatched += 1
                seq = self._seq
                self._seq += 1
                self._seq_tenant[seq] = tid  # noqa: PT100 - _pick_next runs under _cv
                # rotate: equal-credit tenants alternate instead of one
                # draining its whole credit run
                self._order.remove(tid)  # noqa: PT100 - _pick_next runs under _cv
                self._order.append(tid)  # noqa: PT100 - _pick_next runs under _cv
                return tq, item, seq
        return None

    def _ventilate_loop(self):
        while True:
            with self._cv:
                while not self._stop_requested:
                    picked = self._pick_next()
                    if picked is not None:
                        break
                    self._cv.wait(timeout=0.1)
                if self._stop_requested:
                    return
                _tq, item, seq = picked
            # the seq is unique across tenants, so '<ns>:<seq>' names the item
            with obs.mint_trace(self.trace_ns, seq):
                with obs.stage('ventilate', cat='ventilator'):
                    self._ventilate_fn(**dict(item, _seq=seq))
