"""Deterministic interleaving scheduler: twin of
``petastorm_tpu/analysis/schedule/scheduler.py`` for the port's thread plane
(the static half, rules PT1300-PT1303, is the JAX package's linter, which
lints this package too).

Loom-style model checking for the Python plane: while a :class:`Scheduler`
run is active, ``threading.Lock/RLock/Condition/Event/Thread`` are
monkeypatched so that **exactly one thread runs at a time** and every
synchronization operation is a *scheduling point* where the controller picks
which thread runs next.  The choice sequence — the *schedule* — is the
complete description of the interleaving:

* schedules are **recorded** (``RunResult.schedule`` is a comma-separated
  list of thread indices) and **replayable byte-for-byte**
  (:class:`ReplayStrategy`, or ``PSTPU_SCHEDULE=`` through the explorer);
* a seeded :class:`RandomStrategy` makes exploration reproducible;
* a **vector-clock tracker** (:meth:`Scheduler.track`) flags attribute
  write/write and write/read pairs on designated objects with no
  happens-before edge — a genuine data-race detector, not a failure-biased
  stress test;
* **deadlocks** are detected exactly (no runnable thread, unfinished
  threads remain) and reported with each thread's blocked resource.

The choices, the clocks and the reports are the JAX scheduler's, so the same
scenario code explored with the same seed gives the same schedule strings in
both packages.

Timed waits (``Condition.wait(timeout=...)``, ``Event.wait(timeout)``,
``lock.acquire(timeout=...)``, ``Thread.join(timeout)``) are modeled as
*timed-runnable*: the thread may be scheduled while its resource is still
unavailable, and doing so means **the timeout fired**.  No real clock is
consulted, so every run is deterministic and timeout paths are explorable
like any other interleaving.

Happens-before edges tracked by the vector clocks:

* lock release -> (next) acquire of the same lock
* ``Condition.notify`` -> the woken waiter
* ``Event.set`` -> a successful ``Event.wait``
* ``Thread.start`` -> the child's first step
* thread exit -> a successful ``Thread.join``

Scope and caveats (docs/analysis.md "reading a schedule trace"):

* Only threads created *during the run* (through the patched
  ``threading.Thread``) are scheduled.  Scenario code must create its
  components inside the run so their primitives are the scheduled kind.
* Scheduled primitives degrade gracefully after the run: a ``SchedLock``
  that leaks into post-run code falls back to a real lock, so e.g. metrics
  counters created mid-run keep working.
* Real (unpatched) locks taken by library code are invisible; that is safe
  as long as no code holds one across a scheduling point — true for the
  port's import-time singletons (the observability registry, the trace ring,
  the flight recorder), whose critical sections contain no patched
  operations.
* The originals are captured when this module is imported: import it while
  no scheduler (this package's or the JAX package's) has ``threading``
  patched, and never run the two packages' schedulers at once (each holds
  its own run mutex).
"""

from __future__ import annotations

import os
import random
import sys
import threading as _threading
import traceback

#: captured originals — the scheduler's own machinery must keep working
#: while the ``threading`` module attributes are patched
_real_Lock = _threading.Lock
_real_RLock = _threading.RLock
_real_Condition = _threading.Condition
_real_Event = _threading.Event
_real_Thread = _threading.Thread
_real_current_thread = _threading.current_thread
_real_get_ident = _threading.get_ident
_real_Semaphore = _threading.Semaphore

#: one run at a time per process (the patches are process-global)
_RUN_MUTEX = _real_Lock()

#: the active scheduler (None outside a run)
_CURRENT = None


def current_scheduler():
    """The active :class:`Scheduler`, or None outside a run."""
    return _CURRENT


class SchedulerError(Exception):
    """Misuse of the scheduler (not a finding about the component)."""


class ScheduleDivergence(SchedulerError):
    """A replayed schedule named a thread that is not runnable at that
    step — the code under test changed since the schedule was recorded."""


class _AbortRun(BaseException):
    """Unwinds scheduled threads when a run is torn down.  BaseException so
    component-level ``except Exception`` blocks cannot swallow it."""


class Race(object):
    """One detected data race (a pair of conflicting accesses with no
    happens-before edge)."""

    __slots__ = ('kind', 'obj', 'attr', 'first', 'second', 'step')

    def __init__(self, kind, obj, attr, first, second, step):
        self.kind = kind          # 'write/write' or 'write/read'
        self.obj = obj            # tracked object label
        self.attr = attr
        self.first = first        # thread name of the earlier access
        self.second = second      # thread name of the later access
        self.step = step

    def key(self):
        return (self.kind, self.obj, self.attr)

    def describe(self):
        return ('{} race on {}.{}: {!r} and {!r} accessed it with no '
                'happens-before edge (detected at step {})'.format(
                    self.kind, self.obj, self.attr, self.first, self.second,
                    self.step))

    def __repr__(self):
        return 'Race({})'.format(self.describe())


class RunResult(object):
    """Outcome of one scheduled run."""

    __slots__ = ('schedule', 'steps', 'races', 'deadlock', 'errors',
                 'steps_exhausted', 'divergence', 'stalled')

    def __init__(self, schedule, steps, races, deadlock, errors,
                 steps_exhausted, divergence, stalled):
        self.schedule = schedule          # 'i,j,k,...' — the replay string
        self.steps = steps
        self.races = races                # [Race]
        self.deadlock = deadlock          # None or a description string
        self.errors = errors              # [(thread_name, repr, traceback)]
        self.steps_exhausted = steps_exhausted
        self.divergence = divergence
        self.stalled = stalled            # a thread ran without yielding

    @property
    def ok(self):
        return (not self.races and self.deadlock is None and not self.errors
                and not self.inconclusive)

    @property
    def inconclusive(self):
        """The run neither passed nor failed the component: the budget ran
        out or the schedule no longer applies."""
        return self.steps_exhausted or self.divergence or self.stalled

    def describe(self):
        lines = []
        for r in self.races:
            lines.append(r.describe())
        if self.deadlock:
            lines.append('deadlock: {}'.format(self.deadlock))
        for name, err, _tb in self.errors:
            lines.append('thread {!r} raised: {}'.format(name, err))
        if self.steps_exhausted:
            lines.append('inconclusive: step budget exhausted ({} steps)'
                         .format(self.steps))
        if self.divergence:
            lines.append('inconclusive: replayed schedule diverged')
        if self.stalled:
            lines.append('inconclusive: a thread ran without reaching a '
                         'scheduling point (un-instrumented spin loop?)')
        if not lines:
            lines.append('ok')
        lines.append('schedule: {}'.format(self.schedule))
        return '\n'.join(lines)


# -- scheduling strategies ----------------------------------------------------

def _default_pick(runnable, prev):
    """The non-preempting default: keep running the previous thread when it
    can make real progress; otherwise the lowest-index thread that can.
    Threads whose only move is firing a wait timeout come last, so the
    default schedule never spins a polling loop while others could run."""
    progress = [t for t in runnable
                if t.status != 'timed' or t.resource is None
                or t.resource.ready(t)]
    pool = progress or runnable
    for t in pool:
        if t.index == prev:
            return t
    return min(pool, key=lambda t: t.index)


class RandomStrategy(object):
    """Uniformly random choice among runnable threads, from a seeded RNG —
    the exploration workhorse.  Same seed + same component = same schedule."""

    def __init__(self, seed):
        self.seed = seed
        self._rng = random.Random(seed)

    def choose(self, runnable, prev):
        return runnable[self._rng.randrange(len(runnable))]


class ReplayStrategy(object):
    """Byte-for-byte replay of a recorded schedule; raises
    :class:`ScheduleDivergence` if a recorded choice is not runnable.  Past
    the end of the recording, falls back to the deterministic default."""

    def __init__(self, schedule):
        self._schedule = list(schedule)
        self._i = 0

    def choose(self, runnable, prev):
        if self._i < len(self._schedule):
            want = self._schedule[self._i]
            self._i += 1
            for t in runnable:
                if t.index == want:
                    return t
            raise ScheduleDivergence(
                'schedule step {} wants thread {} but runnable set is {}'
                .format(self._i - 1, want,
                        sorted(t.index for t in runnable)))
        return _default_pick(runnable, prev)


class PrefixStrategy(object):
    """Forced choice prefix, then the non-preempting default — the unit of
    bounded-preemption DFS (each DFS node is a prefix)."""

    def __init__(self, prefix):
        self._prefix = tuple(prefix)
        self._i = 0

    def choose(self, runnable, prev):
        if self._i < len(self._prefix):
            want = self._prefix[self._i]
            self._i += 1
            for t in runnable:
                if t.index == want:
                    return t
            raise ScheduleDivergence(
                'DFS prefix step {} wants thread {} but runnable set is {}'
                .format(self._i - 1, want,
                        sorted(t.index for t in runnable)))
        return _default_pick(runnable, prev)


def parse_schedule(text):
    """Parse a ``'0,1,1,0'`` schedule string (the :data:`PSTPU_SCHEDULE`
    format) into a list of thread indices."""
    try:
        return [int(tok) for tok in text.split(',') if tok.strip() != '']
    except ValueError:
        raise SchedulerError('malformed schedule string: {!r}'.format(text))


# -- thread state -------------------------------------------------------------

class _TState(object):
    """Controller-side state of one scheduled thread."""

    __slots__ = ('index', 'name', 'gate', 'status', 'resource', 'clock',
                 'final_clock', 'handle', 'aborting', 'in_access')

    def __init__(self, index, name, handle):
        self.index = index
        self.name = name
        self.gate = _real_Semaphore(0)
        self.status = 'runnable'   # runnable | blocked | timed | finished
        self.resource = None       # what a blocked/timed thread waits for
        self.clock = {index: 1}    # vector clock
        self.final_clock = None
        self.handle = handle       # the SchedThread facade
        self.aborting = False
        self.in_access = False     # re-entrancy guard for attr tracking

    def tick(self):
        self.clock[self.index] = self.clock.get(self.index, 0) + 1

    def join_clock(self, other):
        for k, v in other.items():
            if v > self.clock.get(k, 0):
                self.clock[k] = v

    def ordered_before(self, owner_index, epoch):
        """True when an access by thread ``owner_index`` at ``epoch``
        happens-before this thread's current point."""
        return epoch <= self.clock.get(owner_index, 0)


def _export_clock(state):
    """Snapshot ``state``'s clock for a sync object and advance the epoch
    (the standard release protocol)."""
    snap = dict(state.clock)
    state.tick()
    return snap


def _join_into(target, clock):
    for k, v in clock.items():
        if v > target.get(k, 0):
            target[k] = v


# -- scheduled primitives -----------------------------------------------------

class _SchedLockBase(object):
    """Shared machinery of the scheduled Lock/RLock.  Outside an active run
    (or from an unmanaged thread) every operation degrades to a private real
    lock, so primitives created mid-run stay usable afterwards."""

    _REENTRANT = False

    def __init__(self, sched, name=None):
        self._sched = sched
        self._name = name or '{}#{}'.format(type(self).__name__,
                                            sched._next_serial())
        self._owner = None
        self._count = 0
        self._clock = {}
        self._fallback = _real_RLock() if self._REENTRANT else _real_Lock()

    def _state(self):
        sched = self._sched
        if sched is None or not sched._active or sched is not _CURRENT:
            return None
        return sched._state_for_current()

    def ready(self, state):
        return self._owner is None or (self._REENTRANT
                                       and self._owner is state)

    def acquire(self, blocking=True, timeout=-1):
        st = self._state()
        if st is None:
            if timeout is not None and timeout > 0:
                return self._fallback.acquire(blocking, timeout)
            return self._fallback.acquire(blocking)
        sched = self._sched
        if st.aborting:
            self._owner, self._count = st, 1
            return True
        sched._yield(st)  # the decision point *before* the attempt
        while True:
            if self._owner is None:
                self._owner, self._count = st, 1
                st.join_clock(self._clock)
                return True
            if self._REENTRANT and self._owner is st:
                self._count += 1
                return True
            if not blocking:
                return False
            timed = timeout is not None and timeout > 0
            sched._block(st, self, timed)
            if st.aborting:
                self._owner, self._count = st, 1
                return True
            if not self.ready(st):
                if timed:
                    return False  # scheduled while unavailable = timeout fired
                continue

    def release(self):
        st = self._state()
        if st is None:
            return self._fallback.release()
        if self._owner is not st:
            raise RuntimeError('release of un-acquired {}'.format(self._name))
        self._count -= 1
        if self._count > 0:
            return
        _join_into(self._clock, st.clock)
        st.tick()
        self._owner = None
        if not st.aborting:
            self._sched._yield(st)  # let a waiter grab it right here

    def locked(self):
        if self._state() is None:
            # approximation for the fallback path (matches Lock.locked())
            if self._fallback.acquire(False):
                self._fallback.release()
                return False
            return True
        return self._owner is not None

    # Condition plumbing (mirrors CPython's _release_save/_acquire_restore)
    def _release_save(self):
        st = self._sched._state_for_current()
        count = self._count
        _join_into(self._clock, st.clock)
        st.tick()
        self._owner = None
        self._count = 0
        return count

    def _acquire_restore(self, count):
        self.acquire()
        self._count = count

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.release()
        return False

    def __repr__(self):
        return '<{} owner={}>'.format(
            self._name, self._owner.name if self._owner else None)


class SchedLock(_SchedLockBase):
    _REENTRANT = False


class SchedRLock(_SchedLockBase):
    _REENTRANT = True


class _CondWaiter(object):
    """One parked ``Condition.wait`` — the blocked thread's resource."""

    __slots__ = ('state', 'notified', 'wake_clock')

    def __init__(self, state):
        self.state = state
        self.notified = False
        self.wake_clock = None

    def ready(self, state):
        return self.notified


class SchedCondition(object):
    """Scheduled ``threading.Condition``.  Waits park the thread (releasing
    the lock fully, RLock count preserved); ``notify`` hands the notifier's
    clock to the woken waiter, and timed waits may fire their timeout
    whenever the scheduler picks the waiter while it is un-notified."""

    def __init__(self, sched, lock=None):
        self._sched = sched
        self._lock = lock if lock is not None else SchedRLock(sched)
        self._waiters = []
        self.acquire = self._lock.acquire
        self.release = self._lock.release

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self._lock.release()
        return False

    def _owned_state(self):
        st = self._sched._state_for_current() if self._sched._active else None
        if st is None:
            raise SchedulerError(
                'Condition used from an unmanaged thread during a run')
        if self._lock._owner is not st:
            raise RuntimeError('cannot wait on un-acquired lock')
        return st

    def wait(self, timeout=None):
        st = self._owned_state()
        if st.aborting:
            return False
        waiter = _CondWaiter(st)
        self._waiters.append(waiter)
        saved = self._lock._release_save()
        self._sched._block(st, waiter, timed=timeout is not None)
        if not waiter.notified:
            try:
                self._waiters.remove(waiter)  # the timeout fired
            except ValueError:
                pass
        self._lock._acquire_restore(saved)
        if waiter.wake_clock is not None:
            st.join_clock(waiter.wake_clock)
        return waiter.notified

    def wait_for(self, predicate, timeout=None):
        result = predicate()
        while not result:
            if not self.wait(timeout):
                return predicate()
            result = predicate()
        return result

    def notify(self, n=1):
        st = self._owned_state()
        woken = 0
        snap = None
        while self._waiters and woken < n:
            waiter = self._waiters.pop(0)  # FIFO — deterministic wake order
            waiter.notified = True
            if snap is None:
                snap = dict(st.clock)
            waiter.wake_clock = snap
            woken += 1
        if woken:
            st.tick()

    def notify_all(self):
        self.notify(len(self._waiters))

    notifyAll = notify_all


class _EventWait(object):
    __slots__ = ('event',)

    def __init__(self, event):
        self.event = event

    def ready(self, state):
        return self.event._flag


class SchedEvent(object):
    """Scheduled ``threading.Event``.  ``set -> successful wait`` is a
    happens-before edge; a timed wait scheduled while unset = timeout."""

    def __init__(self, sched):
        self._sched = sched
        self._flag = False
        self._clock = {}
        self._name = 'Event#{}'.format(sched._next_serial())

    def is_set(self):
        return self._flag

    isSet = is_set

    def set(self):
        sched = self._sched
        st = sched._state_for_current() if sched._active else None
        if st is None:
            self._flag = True
            return
        _join_into(self._clock, st.clock)
        st.tick()
        self._flag = True
        if not st.aborting:
            sched._yield(st)

    def clear(self):
        self._flag = False

    def wait(self, timeout=None):
        sched = self._sched
        st = sched._state_for_current() if sched._active else None
        if st is None:
            raise SchedulerError(
                'Event.wait from an unmanaged thread during a run')
        if st.aborting:
            return self._flag
        sched._yield(st)
        if self._flag:
            st.join_clock(self._clock)
            return True
        sched._block(st, _EventWait(self), timed=timeout is not None)
        if self._flag:
            st.join_clock(self._clock)
            return True
        return False  # the timeout fired


class _JoinWait(object):
    __slots__ = ('target',)

    def __init__(self, target):
        self.target = target

    def ready(self, state):
        return self.target.status == 'finished'


class SchedThread(object):
    """Scheduled stand-in for ``threading.Thread`` (the composition API:
    ``Thread(target=...)``; subclassing is not supported — none of the
    scheduled components subclass Thread)."""

    def __init__(self, group=None, target=None, name=None, args=(),
                 kwargs=None, daemon=None):
        sched = _CURRENT
        if sched is None or not sched._active:
            raise SchedulerError('SchedThread created outside an active run')
        self._sched = sched
        self._target = target
        self._args = tuple(args)
        self._kwargs = dict(kwargs or {})
        self.name = name or 'Thread-{}'.format(sched._next_serial())
        self.daemon = True if daemon is None else daemon
        self._state = None

    def start(self):
        if self._state is not None:
            raise RuntimeError('threads can only be started once')
        self._sched._spawn(self)

    def run(self):
        if self._target is not None:
            self._target(*self._args, **self._kwargs)

    def join(self, timeout=None):
        self._sched._join_thread(self, timeout)

    def is_alive(self):
        return self._state is not None and self._state.status != 'finished'

    @property
    def ident(self):
        return None if self._state is None else self._state.index

    def __repr__(self):
        return '<SchedThread {} idx={}>'.format(
            self.name, None if self._state is None else self._state.index)


# -- tracked-attribute bookkeeping --------------------------------------------

_SYNC_TYPES_CACHE = None


def _sync_types():
    global _SYNC_TYPES_CACHE
    if _SYNC_TYPES_CACHE is None:
        _SYNC_TYPES_CACHE = (
            SchedLock, SchedRLock, SchedCondition, SchedEvent, SchedThread,
            type(_real_Lock()), type(_real_RLock()), _real_Condition,
            type(_real_Event()), _real_Thread,
        )
    return _SYNC_TYPES_CACHE


class _TrackInfo(object):
    __slots__ = ('label', 'names', 'obj')

    def __init__(self, label, names, obj):
        self.label = label
        self.names = names
        self.obj = obj   # strong ref: keeps id(obj) stable for the run


def _data_attr_names(obj):
    """The instance's *data* attribute names at track time: ``__dict__``
    keys plus every ``__slots__`` entry in the MRO, minus sync primitives,
    callables and dunders.  Components define all state in ``__init__``, so
    the snapshot is complete by the time a scenario calls ``track()``."""
    names = set()
    d = getattr(type(obj), '__dict__', {})
    inst = object.__getattribute__(obj, '__dict__') if hasattr(obj, '__dict__') else {}
    names.update(inst.keys())
    for klass in type(obj).__mro__:
        names.update(getattr(klass, '__slots__', ()) or ())
    keep = set()
    for name in names:
        if name.startswith('__'):
            continue
        try:
            value = object.__getattribute__(obj, name)
        except AttributeError:
            continue
        if isinstance(value, _sync_types()) or callable(value):
            continue
        keep.add(name)
    return keep


# -- the scheduler ------------------------------------------------------------

class Scheduler(object):
    """One deterministic run: patches ``threading``, runs the scenario as
    thread 0, and schedules every spawned thread one step at a time.

    :param strategy: a choice strategy (:class:`RandomStrategy`,
        :class:`ReplayStrategy`, :class:`PrefixStrategy`); default is the
        deterministic non-preempting policy.
    :param max_steps: hard cap on scheduling decisions (livelock backstop);
        exceeding it makes the run *inconclusive*, not failed.
    :param step_timeout: real-time watchdog per step — fires only when a
        scheduled thread runs without ever reaching a scheduling point
        (an un-instrumented spin loop), which is a scenario bug.
    """

    def __init__(self, strategy=None, max_steps=20000, step_timeout=30.0):
        self._strategy = strategy
        self._threads = []
        self._ctl = _real_Semaphore(0)
        self._by_ident = {}
        self._trace = []
        self._decisions = []   # (runnable index tuple, chosen, prev)
        self.races = []
        self._race_keys = set()
        self.errors = []
        self.deadlock = None
        self.steps = 0
        self.max_steps = max_steps
        self.step_timeout = step_timeout
        self._steps_exhausted = False
        self._divergence = False
        self._stalled = False
        self._abort = False
        self._active = False
        self._serial = 0
        self._last_chosen = None
        self._tracked = {}
        self._access = {}          # (id(obj), attr) -> {'w': ..., 'r': {...}}
        self._patched_classes = {}
        self._saved_threading = None

    # -- public helpers for scenarios ----------------------------------------

    def track(self, obj, name=None, atomic=()):
        """Register ``obj`` for vector-clock race detection.  Every data
        attribute present at track time is watched; ``atomic`` names an
        allowlist of attributes exempted by design (documented GIL-atomic
        signal flags — each exemption should cite why)."""
        cls = type(obj)
        self._instrument_class(cls)
        names = _data_attr_names(obj) - set(atomic)
        label = name or cls.__name__
        self._tracked[id(obj)] = _TrackInfo(label, frozenset(names), obj)
        return obj

    def yield_now(self):
        """Explicit scheduling point, for scenario loops with no patched
        operation of their own."""
        st = self._state_for_current()
        if st is not None and not st.aborting:
            self._yield(st)

    # -- run ------------------------------------------------------------------

    def run(self, fn):
        """Execute ``fn`` as scheduled thread 0 ('main') and schedule it plus
        everything it spawns to completion.  Returns a :class:`RunResult`."""
        global _CURRENT
        if self._active:
            raise SchedulerError('Scheduler.run is not reentrant')
        if self._strategy is None:
            self._strategy = PrefixStrategy(())
        _RUN_MUTEX.acquire()
        try:
            self._install_patches()
            _CURRENT = self
            self._active = True
            root = SchedThread(target=fn, name='main')
            self._spawn(root, parent=None)
            self._controller()
        finally:
            self._active = False
            _CURRENT = None
            self._restore_patches()
            _RUN_MUTEX.release()
        return RunResult(
            schedule=','.join(str(i) for i in self._trace),
            steps=self.steps,
            races=list(self.races),
            deadlock=self.deadlock,
            errors=list(self.errors),
            steps_exhausted=self._steps_exhausted,
            divergence=self._divergence,
            stalled=self._stalled,
        )

    @property
    def decisions(self):
        """Per-step (runnable index tuple, chosen index, previous index) —
        the bounded-preemption explorer's branching data."""
        return list(self._decisions)

    # -- controller -----------------------------------------------------------

    def _controller(self):
        while True:
            unfinished = [t for t in self._threads if t.status != 'finished']
            if not unfinished:
                return
            if self.errors:
                self._abort_run(unfinished)
                return
            runnable = [t for t in unfinished if self._runnable(t)]
            if not runnable:
                self.deadlock = '; '.join(
                    'thread {} ({!r}) blocked on {!r}'.format(
                        t.index, t.name, t.resource)
                    for t in unfinished)
                self._abort_run(unfinished)
                return
            if self.steps >= self.max_steps:
                self._steps_exhausted = True
                self._abort_run(unfinished)
                return
            try:
                chosen = self._strategy.choose(runnable, self._last_chosen)
            except ScheduleDivergence:
                self._divergence = True
                self._abort_run(unfinished)
                return
            self._decisions.append((tuple(t.index for t in runnable),
                                    chosen.index, self._last_chosen))
            self._trace.append(chosen.index)
            self._last_chosen = chosen.index
            self.steps += 1
            if not self._step(chosen):
                return

    def _runnable(self, t):
        if t.status == 'runnable':
            return True
        if t.status == 'timed':
            return True  # scheduling an unavailable timed wait = timeout
        if t.status == 'blocked':
            return t.resource is not None and t.resource.ready(t)
        return False

    def _step(self, t):
        t.gate.release()
        if not self._ctl.acquire(timeout=self.step_timeout):
            self._stalled = True
            self.errors.append((t.name,
                                'no scheduling point reached within {}s'
                                .format(self.step_timeout), ''))
            return False
        return True

    def _abort_run(self, unfinished):
        """Unwind every live thread: wake it so its next scheduling point
        raises :class:`_AbortRun`, which ``_thread_main`` absorbs."""
        self._abort = True
        for _round in range(len(self._threads) * 4 + 8):
            live = [t for t in self._threads if t.status != 'finished']
            if not live:
                return
            for t in live:
                t.gate.release()
            for t in live:
                if not self._ctl.acquire(timeout=self.step_timeout):
                    self._stalled = True
                    return  # leaked daemon thread; surfaced as inconclusive

    # -- thread plumbing ------------------------------------------------------

    def _next_serial(self):
        self._serial += 1
        return self._serial

    def _state_for_current(self):
        return self._by_ident.get(_real_get_ident())

    def _require_state(self):
        st = self._state_for_current()
        if st is None:
            raise SchedulerError(
                'scheduled primitive used from an unmanaged thread')
        return st

    def _spawn(self, handle, parent='caller'):
        if parent == 'caller':
            parent = self._require_state()
        index = len(self._threads)
        state = _TState(index, handle.name, handle)
        handle._state = state
        if parent is not None:
            state.join_clock(parent.clock)
            parent.tick()
        self._threads.append(state)
        real = _real_Thread(target=self._thread_main, args=(state, handle),
                            daemon=True,
                            name='pstpu-sched-{}'.format(handle.name))
        real.start()
        if parent is not None and not parent.aborting:
            self._yield(parent)  # thread creation is a scheduling point

    def _thread_main(self, state, handle):
        self._by_ident[_real_get_ident()] = state
        state.gate.acquire()   # wait to be scheduled the first time
        state.status = 'running'
        try:
            if self._abort:
                raise _AbortRun()
            handle.run()
        except _AbortRun:
            pass
        except BaseException as e:  # noqa: BLE001 - every scenario failure must reach the report
            if not self._abort:
                self.errors.append((state.name, repr(e),
                                    traceback.format_exc()))
        finally:
            state.final_clock = dict(state.clock)
            state.status = 'finished'
            self._ctl.release()

    def _join_thread(self, handle, timeout):
        st = self._require_state()
        if st.aborting:
            return
        target = handle._state
        if target is None:
            raise RuntimeError('cannot join thread before it is started')
        self._yield(st)
        while target.status != 'finished':
            self._block(st, _JoinWait(target), timed=timeout is not None)
            if st.aborting:
                return
            if target.status != 'finished' and timeout is not None:
                return  # the join timeout fired
        st.join_clock(target.final_clock)

    # -- scheduling points ----------------------------------------------------

    def _yield(self, state, status='runnable', resource=None):
        """Park the calling thread and hand control to the controller; the
        thread resumes when the controller next schedules it."""
        if self._abort and not state.aborting:
            state.aborting = True
            raise _AbortRun()
        if state.aborting:
            return
        state.status = status
        state.resource = resource
        self._ctl.release()
        state.gate.acquire()
        state.status = 'running'
        state.resource = None
        if self._abort and not state.aborting:
            state.aborting = True
            raise _AbortRun()

    def _block(self, state, resource, timed):
        self._yield(state, status='timed' if timed else 'blocked',
                    resource=resource)

    # -- attribute tracking ---------------------------------------------------

    def _instrument_class(self, cls):
        if cls in self._patched_classes:
            return
        orig_set = cls.__setattr__
        orig_get = cls.__getattribute__

        def tracked_setattr(obj, name, value, _orig=orig_set):
            sched = _CURRENT
            if sched is not None:
                sched._on_access(obj, name, True)
            _orig(obj, name, value)

        def tracked_getattribute(obj, name, _orig=orig_get):
            sched = _CURRENT
            if sched is not None:
                sched._on_access(obj, name, False)
            return _orig(obj, name)

        cls.__setattr__ = tracked_setattr
        cls.__getattribute__ = tracked_getattribute
        self._patched_classes[cls] = (orig_set, orig_get)

    def _on_access(self, obj, attr, is_write):
        if not self._active or self._abort:
            return
        info = self._tracked.get(id(obj))
        if info is None or attr not in info.names:
            return
        st = self._state_for_current()
        if st is None or st.aborting or st.in_access:
            return
        st.in_access = True
        try:
            if is_write:
                # a tracked write is a scheduling point: the explorer can
                # interleave other threads right before the store lands
                st.in_access = False
                self._yield(st)
                st.in_access = True
            self._race_check(info, obj, attr, st, is_write)
        finally:
            st.in_access = False

    def _race_check(self, info, obj, attr, st, is_write):
        cell = self._access.get((id(obj), attr))
        if cell is None:
            cell = self._access[(id(obj), attr)] = {'w': None, 'r': {}}
        write = cell['w']
        if write is not None:
            w_state, w_epoch = write
            if w_state is not st and not st.ordered_before(w_state.index,
                                                           w_epoch):
                kind = 'write/write' if is_write else 'write/read'
                self._report_race(kind, info.label, attr, w_state, st)
        if is_write:
            for r_state, r_epoch in cell['r'].items():
                if r_state is not st and not st.ordered_before(r_state.index,
                                                              r_epoch):
                    self._report_race('write/read', info.label, attr,
                                      r_state, st)
            cell['w'] = (st, st.clock[st.index])
            cell['r'] = {}
        else:
            cell['r'][st] = st.clock[st.index]

    def _report_race(self, kind, label, attr, first, second):
        race = Race(kind, label, attr, first.name, second.name, self.steps)
        if race.key() not in self._race_keys:
            self._race_keys.add(race.key())
            self.races.append(race)

    # -- patching -------------------------------------------------------------

    def _install_patches(self):
        self._saved_threading = {
            name: getattr(_threading, name)
            for name in ('Lock', 'RLock', 'Condition', 'Event', 'Thread',
                         'current_thread')
        }
        _threading.Lock = _lock_factory
        _threading.RLock = _rlock_factory
        _threading.Condition = _condition_factory
        _threading.Event = _event_factory
        _threading.Thread = _thread_factory
        _threading.current_thread = _current_thread

    def _restore_patches(self):
        if self._saved_threading:
            for name, value in self._saved_threading.items():
                setattr(_threading, name, value)
            self._saved_threading = None
        for cls, (orig_set, orig_get) in self._patched_classes.items():
            cls.__setattr__ = orig_set
            cls.__getattribute__ = orig_get
        self._patched_classes.clear()


# -- patched threading factories ----------------------------------------------

def _caller_is_threading():
    """True when a patched factory is being invoked from ``threading.py``
    itself.  CPython's primitives compose through module globals (a
    ``Semaphore`` builds a ``Condition``, a ``Thread`` builds ``Event``\\ s),
    so stdlib internals must always get the *real* classes — only component
    code gets the scheduled kind."""
    try:
        frame = sys._getframe(1)
    except ValueError:
        return False
    # Walk past this module's own helper/factory frames to the true caller.
    while frame is not None \
            and frame.f_globals.get('__name__') == __name__:
        frame = frame.f_back
    return frame is not None \
        and frame.f_globals.get('__name__') == 'threading'


def _in_run():
    if _caller_is_threading():
        return None
    sched = _CURRENT
    if sched is not None and sched._active \
            and sched._state_for_current() is not None:
        return sched
    return None


def _lock_factory():
    sched = _in_run()
    return SchedLock(sched) if sched is not None else _real_Lock()


def _rlock_factory():
    sched = _in_run()
    return SchedRLock(sched) if sched is not None else _real_RLock()


def _condition_factory(lock=None):
    sched = _in_run()
    if sched is not None:
        return SchedCondition(sched, lock)
    return _real_Condition(lock)


def _event_factory():
    sched = _in_run()
    return SchedEvent(sched) if sched is not None else _real_Event()


def _thread_factory(group=None, target=None, name=None, args=(), kwargs=None,
                    daemon=None):
    sched = _in_run()
    if sched is not None:
        return SchedThread(group=group, target=target, name=name, args=args,
                           kwargs=kwargs, daemon=daemon)
    return _real_Thread(group=group, target=target, name=name, args=args,
                        kwargs=kwargs, daemon=daemon)


def _current_thread():
    if _caller_is_threading():
        return _real_current_thread()
    sched = _CURRENT
    if sched is not None and sched._active:
        st = sched._state_for_current()
        if st is not None:
            return st.handle
    return _real_current_thread()


#: env var the explorer consults for byte-for-byte replay
SCHEDULE_ENV = 'PSTPU_SCHEDULE'


def schedule_from_env(environ=os.environ):
    """The ``PSTPU_SCHEDULE`` replay schedule, parsed, or None."""
    raw = environ.get(SCHEDULE_ENV)
    if not raw:
        return None
    return parse_schedule(raw)


__all__ = [
    'PrefixStrategy', 'Race', 'RandomStrategy', 'ReplayStrategy', 'RunResult',
    'SCHEDULE_ENV', 'SchedCondition', 'SchedEvent', 'SchedLock', 'SchedRLock',
    'SchedThread', 'ScheduleDivergence', 'Scheduler', 'SchedulerError',
    'current_scheduler', 'parse_schedule', 'schedule_from_env',
]
