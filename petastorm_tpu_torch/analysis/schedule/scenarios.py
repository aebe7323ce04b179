"""Deterministic-schedule scenarios over the port's thread-plane components.

Twin of ``petastorm_tpu/analysis/schedule/scenarios.py``: the same
workloads and invariants, driving the port's classes
(:mod:`petastorm_tpu_torch.workers.ventilator`,
:mod:`petastorm_tpu_torch.shuffling_buffer`,
:mod:`petastorm_tpu_torch.native.lifetime`,
:mod:`petastorm_tpu_torch.autotune.controller`). The seeded-defect fixtures
are the JAX package's code, so both explorers give them the same schedules.

Each scenario is ``fn(sched)``: it constructs its component **inside the
run** (so the component's primitives are the scheduled kind), registers the
objects whose attributes the vector-clock tracker should watch
(:meth:`Scheduler.track`), drives a real multi-threaded workload to
completion, and asserts the component's own invariants.  The explorer then
hammers the scenario with hundreds of schedules; any race, deadlock, or
broken invariant fails with a replayable schedule string.

Two registries:

* :data:`SCENARIOS` — the real components; tier-1 requires every one to
  survive exploration (the soundness direction).
* :data:`DEFECT_SCENARIOS` — seeded-defect fixtures (a torn counter, an
  ABBA deadlock, the pre-fix ventilator flag protocol); the explorer must
  *catch* each one (the teeth direction).  They are reachable from
  the CLI's ``explore`` only by explicit name.

Scenario-design rules (docs/analysis.md "reading a schedule trace"):

* never spin on an unsynchronized flag — every wait goes through a patched
  ``Condition``/``Event`` so the scheduler sees the dependency (an
  un-instrumented spin loop trips the stall watchdog);
* handshakes use *untimed* waits (the scheduler proves they are woken);
  component-internal polls keep their timed waits, which the scheduler
  models as timeouts it may fire at will;
* keep workloads small: exploration runs hundreds of schedules in tier-1.
"""

from __future__ import annotations

import threading


# -- seeded-defect fixtures ---------------------------------------------------

class TornCounter(object):
    """Deliberate data race: ``bump_unsafe`` does a read-modify-write of
    ``value`` with no lock while ``bump_safe`` mutates it under one.  The
    vector-clock tracker must flag value's write/write pair on every
    schedule — this is the explorer's teeth test."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def bump_safe(self):
        with self._lock:
            self.value = self.value + 1

    def bump_unsafe(self):
        self.value = self.value + 1


class SafeCounter(object):
    """Race-free twin of :class:`TornCounter`: every access holds the lock.
    Must survive 500+ schedules without a single report (soundness)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def bump(self):
        with self._lock:
            self.value = self.value + 1

    def read(self):
        with self._lock:
            return self.value


class _PreFixFlags(object):
    """The ConcurrentVentilator flag protocol *before* its fix: the
    worker loop reads ``_stop_requested``/writes ``_completed`` bare while
    ``stop()`` writes/reads them bare from another thread.  Kept as a
    fixture so the regression test proves the explorer catches exactly the
    defect class that was fixed in ``workers/ventilator.py`` (both
    packages' ventilators hold ``_cv`` for both flags)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._stop_requested = False
        self._completed = False

    def loop(self):
        while not self._stop_requested:       # bare read — the defect
            with self._cv:
                self._cv.wait(timeout=0.1)
        self._completed = True                # bare write — the defect

    def stop(self):
        self._stop_requested = True           # bare write — the defect
        with self._cv:
            self._cv.notify_all()


def torn_counter(sched):
    counter = sched.track(TornCounter(), name='TornCounter')
    t1 = threading.Thread(target=counter.bump_safe, name='safe')
    t2 = threading.Thread(target=counter.bump_unsafe, name='unsafe')
    t1.start()
    t2.start()
    t1.join()
    t2.join()


def safe_counter(sched):
    counter = sched.track(SafeCounter(), name='SafeCounter')
    threads = [threading.Thread(target=counter.bump, name='bump-%d' % i)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.read() == 2


def abba_deadlock(sched):
    """Classic lock-order inversion; some schedules deadlock (the detector
    must say so, with both threads' blocked resources)."""
    a = threading.Lock()
    b = threading.Lock()

    def one():
        with a:
            with b:
                pass

    def two():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=one, name='ab')
    t2 = threading.Thread(target=two, name='ba')
    t1.start()
    t2.start()
    t1.join()
    t2.join()


def prefix_ventilator_flags(sched):
    comp = sched.track(_PreFixFlags(), name='PreFixFlags')
    worker = threading.Thread(target=comp.loop, name='worker')
    worker.start()
    comp.stop()
    worker.join()


# -- real-component scenarios -------------------------------------------------

def concurrent_ventilator(sched):
    """Two seeded epochs over three items through a real
    :class:`~petastorm_tpu_torch.workers.ventilator.ConcurrentVentilator` with a
    tight in-flight budget, a checkpoint snapshot mid-stream, and a
    consumer thread doing delivery + completion callbacks."""
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

    got = []
    cv = threading.Condition()

    def ventilate(_seq=None, **item):
        with cv:
            got.append(_seq)
            cv.notify_all()

    vent = ConcurrentVentilator(ventilate, [{'i': k} for k in range(3)],
                                iterations=2, max_ventilation_queue_size=2,
                                randomize_item_order=True, random_seed=7,
                                tag_items=True)
    sched.track(vent, name='ConcurrentVentilator')
    vent.start()
    expected = 6
    for n in range(expected):
        with cv:
            while not got:
                cv.wait()
            seq = got.pop(0)
        vent.mark_delivered(seq)
        vent.processed_item(seq)
        if n == 2:
            state = vent.state_dict()
            assert isinstance(state['replay_indices'], list)
    vent.stop()
    assert vent.completed()


def fair_share_ventilator(sched):
    """Two tenants (weights 2:1, per-tenant budget 1) through a real
    :class:`~petastorm_tpu_torch.workers.ventilator.FairShareVentilator`;
    completion callbacks must fire exactly once per tenant."""
    from petastorm_tpu_torch.workers.ventilator import FairShareVentilator

    got = []
    done = []
    cv = threading.Condition()

    def ventilate(_seq=None, **item):
        with cv:
            got.append(_seq)
            cv.notify_all()

    fsv = FairShareVentilator(ventilate, on_tenant_done=done.append)
    sched.track(fsv, name='FairShareVentilator')
    fsv.add_tenant('a', [{'x': 1}, {'x': 2}], iterations=1, weight=2,
                   max_in_flight=1)
    fsv.add_tenant('b', [{'y': 1}], iterations=1, weight=1, max_in_flight=1)
    for tq in list(fsv._tenants.values()):
        sched.track(tq, name='TenantQueue:{}'.format(tq.tenant_id))
    fsv.start()
    for _ in range(3):
        with cv:
            while not got:
                cv.wait()
            seq = got.pop(0)
        fsv.processed_item(seq)
    fsv.stop()
    assert sorted(done) == ['a', 'b'], done
    stats = fsv.tenant_stats()
    assert stats['a']['completed'] == 2 and stats['b']['completed'] == 1


def shuffling_buffer(sched):
    """Producer/consumer over a real
    :class:`~petastorm_tpu_torch.shuffling_buffer.RandomShufflingBuffer` under the
    loader's serialization contract (one shared condition lock) — proves the
    documented usage pattern is race-free."""
    from petastorm_tpu_torch.shuffling_buffer import RandomShufflingBuffer

    buf = sched.track(RandomShufflingBuffer(4, 1, extra_capacity=100, seed=3),
                      name='RandomShufflingBuffer')
    cv = threading.Condition()

    def producer():
        for chunk in ([0, 1, 2], [3, 4], [5]):
            with cv:
                buf.add_many(chunk)
                cv.notify_all()
        with cv:
            buf.finish()
            cv.notify_all()

    t = threading.Thread(target=producer, name='producer')
    t.start()
    retrieved = []
    while True:
        with cv:
            while not buf.can_retrieve():
                if buf._done_adding and buf.size == 0:
                    break
                cv.wait()
            if not buf.can_retrieve():
                break
            retrieved.append(buf.retrieve())
    t.join()
    assert sorted(retrieved) == list(range(6)), retrieved


def slot_registry(sched):
    """Borrow/reclaim churn on a real
    :class:`~petastorm_tpu_torch.native.lifetime.SlotRegistry`: two borrower
    threads plus a reclaimer racing ``try_reclaim`` against the drops; the
    release callback must fire exactly once and counters must balance."""
    from petastorm_tpu_torch.native.lifetime import SlotRegistry

    registry = sched.track(SlotRegistry(), name='SlotRegistry')
    released = []
    release_ev = threading.Event()

    def on_release():
        released.append(1)
        release_ev.set()

    slot = registry.open_slot(on_release=on_release, label='scenario-slot')
    sched.track(slot, name='Slot')
    slot.retain()                     # main's borrow, held across the run
    held = threading.Event()
    go = threading.Event()

    def borrower():
        slot.retain()
        held.set()
        go.wait()
        slot.drop()

    def reclaimer():
        slot.try_reclaim()            # may be refused (borrows live)
        release_ev.wait()             # proven released by the last drop
        counters = registry.counters()
        assert counters['lifetime_live_borrows'] == 0, counters

    b = threading.Thread(target=borrower, name='borrower')
    r = threading.Thread(target=reclaimer, name='reclaimer')
    b.start()
    r.start()
    held.wait()
    slot.seal()
    slot.drop()
    go.set()
    b.join()
    r.join()
    assert released == [1], released
    assert registry.live_borrows() == 0


class _SlotPool(object):
    """Duck-typed worker pool for the autotune actuator path: just the
    surface :class:`~petastorm_tpu_torch.autotune.controller.Autotuner` actuates
    (``workers_count`` + grow/retire), state under its own lock."""

    def __init__(self, workers=2):
        self._lock = threading.Lock()
        self.workers_count = workers

    def add_worker_slot(self):
        with self._lock:
            self.workers_count += 1
            return self.workers_count

    def retire_worker_slot(self):
        with self._lock:
            self.workers_count -= 1
            return self.workers_count


def autotune_actuator(sched):
    """Autotuner actuation
    (``pool.add_worker_slot`` then ``ventilator.set_max_queue_size``)
    running concurrently with the ventilator's feeding thread and the
    consumer's completion callbacks."""
    from petastorm_tpu_torch.autotune.controller import Autotuner, AutotuneConfig
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

    got = []
    cv = threading.Condition()

    def ventilate(_seq=None, **item):
        with cv:
            got.append(_seq)
            cv.notify_all()

    pool = sched.track(_SlotPool(workers=2), name='SlotPool')
    vent = ConcurrentVentilator(ventilate, [{'i': k} for k in range(3)],
                                iterations=1, max_ventilation_queue_size=1,
                                tag_items=True)
    sched.track(vent, name='ConcurrentVentilator')
    tuner = Autotuner(AutotuneConfig(interval_s=0.5, min_workers=1,
                                     max_workers=8),
                      pool=pool, ventilator=vent)
    sched.track(tuner, name='Autotuner')
    report = {'bottleneck': 'decode', 'stages': {'decode': 8.0, 'read': 2.0},
              'reader_wait_fraction': 0.6, 'wait_proxy': 0.6}
    window = {'window_s': 1.0, 'rows_per_s': 100.0}
    records = []

    def controller():
        # two grow actuations with hysteresis-clearing timestamps; each one
        # bumps the pool then retargets the ventilator's in-flight budget
        records.append(tuner._grow_workers(report, window, now=100.0))
        records.append(tuner._grow_workers(report, window, now=200.0))

    vent.start()
    actuator = threading.Thread(target=controller, name='actuator')
    actuator.start()
    for _ in range(3):
        with cv:
            while not got:
                cv.wait()
            seq = got.pop(0)
        vent.mark_delivered(seq)
        vent.processed_item(seq)
    actuator.join()
    vent.stop()
    assert pool.workers_count == 4, pool.workers_count
    assert records[0] is not None and records[1] is not None
    assert len(tuner.decision_records()) == 2


#: real components — tier-1 requires every entry to pass exploration
SCENARIOS = {
    'concurrent_ventilator': concurrent_ventilator,
    'fair_share_ventilator': fair_share_ventilator,
    'shuffling_buffer': shuffling_buffer,
    'slot_registry': slot_registry,
    'autotune_actuator': autotune_actuator,
}

#: seeded defects — the explorer must catch every entry
DEFECT_SCENARIOS = {
    'torn_counter': torn_counter,
    'safe_counter': safe_counter,   # the race-free twin (soundness control)
    'abba_deadlock': abba_deadlock,
    'prefix_ventilator_flags': prefix_ventilator_flags,
}


def lookup(name):
    """Resolve a scenario by name across both registries."""
    fn = SCENARIOS.get(name) or DEFECT_SCENARIOS.get(name)
    if fn is None:
        raise KeyError(name)
    return fn


__all__ = ['DEFECT_SCENARIOS', 'SCENARIOS', 'SafeCounter', 'TornCounter',
           'abba_deadlock', 'autotune_actuator', 'concurrent_ventilator',
           'fair_share_ventilator', 'lookup', 'prefix_ventilator_flags',
           'safe_counter', 'shuffling_buffer', 'slot_registry',
           'torn_counter']
