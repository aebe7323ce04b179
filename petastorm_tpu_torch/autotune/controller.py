"""The feedback controller: windowed stall evidence in, bounded knob moves out.

Twin of ``petastorm_tpu/autotune/controller.py``: the same decisions and
decision records for the same evidence windows.

The control loop (one :meth:`Autotuner.tick` per ``interval_s``):

1. snapshot diagnostics into the :class:`HistoryRecorder`;
2. compute the tick-to-tick **window delta** and its windowed stall report —
   attribution of the *last interval's* wait, not the run's cumulative total;
3. decide (:meth:`Autotuner.evaluate`): a stalled window names its bottleneck
   and the bottleneck names the knob — grow the worker pool, shrink the
   shuffle buffer; a persistently calm pipeline gives a grown worker slot
   back (the JAX package's chunk-prefetch knob waits for the chunk cache,
   which is not ported);
4. act, **always** through code that (a) clamps the target into the
   config's explicit ``[min, max]``, (b) runs inside a
   ``decision_span`` so the change lands in the trace ring as an
   ``autotune.decision`` event, and (c) appends a structured record — with
   the evidence window attached — to :attr:`Autotuner.decisions` and the
   JSONL :class:`DecisionLog`.

Safety comes from three layers of hysteresis:
a per-knob cooldown between moves, a longer cooldown before *reversing* a
knob's direction, and a freeze after repeated reversals — alternating
bottlenecks therefore cannot thrash a knob. Worker-pool moves are additionally safe by
construction: growth spawns a fresh supervised slot, shrink retires an idle
slot through the same death-handling path a crash takes, so every item is still
delivered exactly once across every resize.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.observability import history as _history
from petastorm_tpu_torch.observability import trace as _trace

logger = logging.getLogger(__name__)

#: stall-report bottlenecks answered by growing the worker pool
_WORKER_BOTTLENECKS = frozenset({
    'worker.decode', 'worker.fused_decode', 'worker.transform',
    'worker.read_io', 'pool.unattributed'})


def clamp(value, lo, hi):
    """Bound a knob target into ``[lo, hi]`` — the ONE clamp every knob write
    must pass through."""
    if lo is not None and value < lo:
        return lo
    if hi is not None and value > hi:
        return hi
    return value


class decision_span(object):
    """Context manager recording one ``autotune.decision`` Chrome-trace event.

    Unlike :func:`petastorm_tpu_torch.observability.span`, the event records at
    EVERY telemetry level: decisions are rare (hysteresis bounds them to at
    most one per knob per cooldown) and each one must stay explainable in an
    exported trace even when per-stage spans are off. ``note()`` adds fields
    (e.g. the post-clamp target) before the span closes.
    """

    __slots__ = ('args', '_wall0', '_t0')

    def __init__(self, **args):
        self.args = args

    def note(self, **kwargs):
        self.args.update(kwargs)

    def __enter__(self):
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        _trace.record_span('autotune.decision', 'autotune', self._wall0,
                           time.perf_counter() - self._t0, dict(self.args))
        return False


class DecisionLog(object):
    """Append-only JSONL decision log (one structured record per knob change;
    the JAX package's schema). Best-effort: an unwritable path degrades
    to in-memory decisions with one warning, never a failed pipeline."""

    def __init__(self, path):
        self.path = path
        self._warned = False

    def append(self, record):
        try:
            with open(self.path, 'a') as f:
                f.write(json.dumps(record) + '\n')
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning('autotune decision log %s unwritable (%s); '
                               'decisions stay in memory only', self.path, e)


class AutotuneConfig(object):
    """Bounds, cadence and hysteresis of the feedback controller.

    Every knob has an explicit ``[min, max]``; the controller can never move
    outside them. ``None`` cooldowns derive from ``interval_s``.

    :param interval_s: evaluation cadence (also the history snapshot cadence)
    :param history_capacity: snapshots retained for windows/offline save
    :param stall_threshold: windowed ``reader_wait_fraction`` at/above which
        the window counts as stalled and the bottleneck knob may move
    :param low_water: windowed wait fraction at/below which the window counts
        as calm (a run of ``shrink_after_windows`` calm windows lets a grown
        worker slot retire)
    :param min_workers/max_workers: worker-pool bounds (``max_workers=None``
        defaults to ``min(2 * cpu_count, 16)`` at attach time)
    :param min_shuffle_capacity: floor for shuffle-buffer shrinks (growing
        re-uses the loader's configured capacity as the ceiling)
    :param cooldown_s: min seconds between moves of one knob (default
        ``2 * interval_s``)
    :param reverse_cooldown_s: min seconds before a knob may move in the
        OPPOSITE direction of its last move (default ``6 * interval_s``)
    :param freeze_s: knob freeze after two direction reversals (default
        ``20 * interval_s``)
    :param shrink_after_windows: consecutive calm windows before a worker
        slot retires
    :param shrink_workers: allow giving grown slots back (False = grow-only)
    :param decision_log: JSONL path for the structured decision log (None =
        in-memory ``Autotuner.decisions`` only)
    :param rollback: A/B-check every knob move — the first full evidence
        window after a move is compared against the move's own evidence
        window via :func:`observability.history.detect_regression`; on a
        detected regression the knob is reverted and frozen, recorded as a
        ``rollback`` decision
    :param rollback_throughput_ratio/rollback_stall_rise: the
        :func:`~petastorm_tpu_torch.observability.history.detect_regression`
        thresholds the A/B check uses
    """

    def __init__(self, interval_s=2.0, history_capacity=_history.DEFAULT_CAPACITY,
                 stall_threshold=0.15, low_water=0.02,
                 min_workers=1, max_workers=None,
                 min_shuffle_capacity=2,
                 cooldown_s=None, reverse_cooldown_s=None, freeze_s=None,
                 shrink_after_windows=5, shrink_workers=True,
                 decision_log=None, rollback=True,
                 rollback_throughput_ratio=0.7, rollback_stall_rise=0.15):
        if interval_s <= 0:
            raise ValueError('interval_s must be > 0')
        if not 0.0 <= low_water < stall_threshold <= 1.0:
            raise ValueError('need 0 <= low_water < stall_threshold <= 1, got '
                             '{} / {}'.format(low_water, stall_threshold))
        if min_workers < 1:
            raise ValueError('min_workers must be >= 1')
        if max_workers is not None and max_workers < min_workers:
            raise ValueError('max_workers ({}) < min_workers ({})'.format(
                max_workers, min_workers))
        if shrink_after_windows < 1:
            raise ValueError('shrink_after_windows must be >= 1')
        if not 0.0 < rollback_throughput_ratio <= 1.0:
            raise ValueError('rollback_throughput_ratio must be in (0, 1]')
        if rollback_stall_rise < 0.0:
            raise ValueError('rollback_stall_rise must be >= 0')
        self.interval_s = interval_s
        self.history_capacity = history_capacity
        self.stall_threshold = stall_threshold
        self.low_water = low_water
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.min_shuffle_capacity = min_shuffle_capacity
        self.cooldown_s = cooldown_s if cooldown_s is not None else 2 * interval_s
        self.reverse_cooldown_s = (reverse_cooldown_s if reverse_cooldown_s is not None
                                   else 6 * interval_s)
        self.freeze_s = freeze_s if freeze_s is not None else 20 * interval_s
        self.shrink_after_windows = shrink_after_windows
        self.shrink_workers = shrink_workers
        self.decision_log = decision_log
        self.rollback = rollback
        self.rollback_throughput_ratio = rollback_throughput_ratio
        self.rollback_stall_rise = rollback_stall_rise

    def resolved_max_workers(self):
        if self.max_workers is not None:
            return self.max_workers
        return max(self.min_workers, min(2 * (os.cpu_count() or 1), 16))

    def __repr__(self):
        return ('AutotuneConfig(interval_s={}, stall_threshold={}, '
                'max_workers={}, decision_log={!r})'.format(
                    self.interval_s, self.stall_threshold,
                    self.max_workers, self.decision_log))


def resolve_autotune(autotune):
    """Normalize the ``make_reader`` kwarg: falsy -> None (off), ``True`` ->
    defaults, an :class:`AutotuneConfig` -> itself."""
    if not autotune:
        return None
    if autotune is True:
        return AutotuneConfig()
    if isinstance(autotune, AutotuneConfig):
        return autotune
    raise ValueError('autotune must be False/None, True, or an AutotuneConfig, '
                     'got {!r}'.format(autotune))


class _KnobState(object):
    """Per-knob hysteresis bookkeeping."""

    __slots__ = ('last_t', 'last_direction', 'reversals', 'frozen_until')

    def __init__(self):
        self.last_t = None
        self.last_direction = None
        self.reversals = 0
        self.frozen_until = 0.0


class Autotuner(object):
    """The closed loop: owns a :class:`HistoryRecorder` over the reader (or,
    once attached, the loader) diagnostics and a control thread ticking every
    ``config.interval_s``. All targets are duck-typed, so an offline replay
    can drive the identical decision path against simulated knobs:

    :param pool: needs ``workers_count`` and (for the knob to be live)
        ``add_worker_slot``/``retire_worker_slot``
    :param ventilator: optional; its in-flight budget follows pool growth
    :param diagnostics_fn: evidence source (``Reader.diagnostics`` by default;
        :meth:`attach_loader` rebinds it to the loader, which adds the
        consumer-side ``reader_wait_*`` signal)
    """

    def __init__(self, config, pool=None, ventilator=None, diagnostics_fn=None, loader=None):
        self.config = config
        self._pool = pool
        self._ventilator = ventilator
        self._loader = loader
        self._diagnostics_fn = diagnostics_fn
        self.history = _history.HistoryRecorder(
            self._diagnostics, interval_s=config.interval_s,
            capacity=config.history_capacity)
        self.decisions = []
        self._decisions_lock = threading.Lock()
        self._log = DecisionLog(config.decision_log) if config.decision_log else None
        self._knobs = {}
        self._calm_windows = 0
        self._grown_slots = 0  # net slots this controller added (shrink floor)
        self._pending_ab = None  # last knob move awaiting its A/B window
        self._stop_event = threading.Event()
        self._thread = None

    # -- wiring --------------------------------------------------------------

    def _diagnostics(self):
        if self._loader is not None:
            return self._loader.diagnostics
        if self._diagnostics_fn is not None:
            return self._diagnostics_fn()
        return {}

    def attach_loader(self, loader):
        """Called by :class:`~petastorm_tpu_torch.torch.loader.TorchDataLoader` when it
        wraps an autotuned reader: the loader's diagnostics carry the
        consumer-side wait signal, and its shuffle buffer becomes tunable."""
        self._loader = loader

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Autotuner already started')
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pstpu-autotune')
        self._thread.start()
        return self

    def _loop(self):
        self.history.record_now()
        while not self._stop_event.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the tuner is advisory: a decision error must never kill the pipeline
                logger.warning('autotune tick failed: %s', e)

    def stop(self):
        self._stop_event.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
            self._thread = None

    def join(self):
        self.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        return False

    # -- the loop body -------------------------------------------------------

    def tick(self, now=None):
        """One control evaluation: snapshot, window, decide, act. Returns the
        decision record (or None). Public so tests and an offline replay can
        drive the loop without the thread."""
        self.history.record_now()
        window = self.history.window_last()
        if window is None or window['window_s'] < 0.25 * self.config.interval_s:
            return None
        return self.evaluate(window, now=now)

    def evaluate(self, window, now=None):
        """Pure-ish decision step over one evidence window (actuation happens
        through the attached knob targets)."""
        now = now if now is not None else time.monotonic()
        report = _history.windowed_stall_report(window)
        # A/B check first: the window that just closed is the evidence for the
        # PREVIOUS move — a detected regression reverts + freezes that knob
        # before any new move is considered
        if self._pending_ab is not None:
            pending, self._pending_ab = self._pending_ab, None
            if self.config.rollback:
                regression = _history.detect_regression(
                    pending['window'], window,
                    throughput_ratio=self.config.rollback_throughput_ratio,
                    stall_rise=self.config.rollback_stall_rise)
                if regression is not None:
                    record = self._rollback(pending, regression, report,
                                            window, now)
                    if record is not None:
                        return record
        wait_frac = report.get('reader_wait_fraction') or 0.0
        if wait_frac >= self.config.stall_threshold:
            self._calm_windows = 0
            return self._on_stalled(report, window, now)
        if wait_frac <= self.config.low_water:
            self._calm_windows += 1
            if (self.config.shrink_workers
                    and self._calm_windows >= self.config.shrink_after_windows):
                self._calm_windows = 0
                return self._shrink_workers(report, window, now)
        else:
            self._calm_windows = 0
        return None

    def _on_stalled(self, report, window, now):
        bottleneck = report.get('bottleneck')
        if bottleneck in _WORKER_BOTTLENECKS:
            return self._grow_workers(report, window, now)
        if bottleneck == 'consumer.assembly':
            return self._shrink_shuffle(report, window, now)
        return None

    # -- hysteresis ----------------------------------------------------------

    def _knob_state(self, name):
        state = self._knobs.get(name)
        if state is None:
            state = self._knobs[name] = _KnobState()
        return state

    def _allow(self, name, direction, now):
        """The oscillation guard: cooldown, reverse-cooldown, reversal freeze."""
        cfg = self.config
        state = self._knob_state(name)
        if now < state.frozen_until:
            return False
        if state.last_t is not None and now - state.last_t < cfg.cooldown_s:
            return False
        if state.last_direction is not None and direction != state.last_direction:
            if now - state.last_t < cfg.reverse_cooldown_s:
                return False
            state.reversals += 1
            if state.reversals >= 2:
                state.frozen_until = now + cfg.freeze_s
                state.reversals = 0
                logger.warning('autotune: knob %r reversed direction twice; '
                               'frozen for %.1fs (oscillation guard)',
                               name, cfg.freeze_s)
                return False
        return True

    def _mark(self, name, direction, now):
        state = self._knob_state(name)
        state.last_t = now
        state.last_direction = direction

    # -- actions -------------------------------------------------------------
    # Every actuator call in this package must sit inside a decision_span and
    # take a clamp()-ed target: the span + log record make
    # each change explainable, the clamp makes the bounds unbreakable.

    def _record(self, knob, action, before, after, reason, report, window,
                clamped, regression=None):
        record = {
            'ts': round(time.time(), 3),
            'knob': knob, 'action': action,
            'from': before, 'to': after, 'clamped': bool(clamped),
            'reason': reason,
            'window': {
                'span_s': window.get('window_s'),
                'reader_wait_fraction': report.get('reader_wait_fraction'),
                'wait_proxy': report.get('wait_proxy'),
                'bottleneck': report.get('bottleneck'),
                'rows_per_s': window.get('rows_per_s'),
                'stages': report.get('stages'),
            },
        }
        if regression is not None:
            record['regression'] = regression
        if action != 'rollback':
            # arm the A/B check: the NEXT full window is this move's verdict
            # (a rollback is the verdict itself — it never re-arms)
            self._pending_ab = {'record': record, 'window': window}
        with self._decisions_lock:
            self.decisions.append(record)
            if len(self.decisions) > 1000:
                del self.decisions[:-1000]
        if self._log is not None:
            self._log.append(record)
        obs.count('autotune_decisions_total')
        logger.info('autotune: %s %s %s -> %s (%s)', action, knob, before,
                    after, reason)
        return record

    def _grow_workers(self, report, window, now):
        pool = self._pool
        if pool is None or not hasattr(pool, 'add_worker_slot'):
            return None
        before = pool.workers_count
        hi = self.config.resolved_max_workers()
        target = clamp(before + 1, self.config.min_workers, hi)
        if target <= before or not self._allow('workers', 'grow', now):
            return None
        reason = 'bottleneck {} at {:.0%} of windowed wait'.format(
            report.get('bottleneck'), self._bottleneck_share(report))
        with decision_span(knob='workers', action='grow', before=before,
                           target=target, reason=reason) as span:
            pool.add_worker_slot()
            after = pool.workers_count
            span.note(after=after)
            if self._ventilator is not None \
                    and hasattr(self._ventilator, 'set_max_queue_size'):
                # the in-flight budget tracks the pool size, as at construction
                self._ventilator.set_max_queue_size(after + 2)
        self._mark('workers', 'grow', now)
        self._grown_slots += 1
        return self._record('workers', 'grow', before, after, reason, report,
                            window, clamped=target != before + 1)

    def _shrink_workers(self, report, window, now):
        pool = self._pool
        if pool is None or not hasattr(pool, 'retire_worker_slot'):
            return None
        before = pool.workers_count
        if self._grown_slots <= 0:
            return None  # never shrink below what the user configured
        target = clamp(before - 1, self.config.min_workers, None)
        if target >= before or not self._allow('workers', 'shrink', now):
            return None
        reason = 'calm pipeline ({} consecutive windows <= {:.0%} wait)'.format(
            self.config.shrink_after_windows, self.config.low_water)
        with decision_span(knob='workers', action='shrink', before=before,
                           target=target, reason=reason) as span:
            pool.retire_worker_slot()
            after = pool.workers_count
            span.note(after=after)
            if self._ventilator is not None \
                    and hasattr(self._ventilator, 'set_max_queue_size'):
                self._ventilator.set_max_queue_size(after + 2)
        if after >= before:
            return None  # every slot was busy: the pool declined this tick
        self._mark('workers', 'shrink', now)
        self._grown_slots -= 1
        return self._record('workers', 'shrink', before, after, reason, report,
                            window, clamped=target != before - 1)

    def _shrink_shuffle(self, report, window, now):
        loader = self._loader
        if loader is None or not hasattr(loader, 'set_shuffle_capacity'):
            return None
        before = getattr(loader, 'shuffle_capacity', 0)
        if before <= 0:
            return None  # no shuffling buffer in play
        target = clamp(before // 2, self.config.min_shuffle_capacity, None)
        if target >= before or not self._allow('shuffle_capacity', 'shrink', now):
            return None
        reason = ('consumer-side assembly bound: shrinking the shuffle buffer '
                  'reduces per-emit gather work')
        with decision_span(knob='shuffle_capacity', action='shrink',
                           before=before, target=target, reason=reason):
            loader.set_shuffle_capacity(target)
        self._mark('shuffle_capacity', 'shrink', now)
        return self._record('shuffle_capacity', 'shrink', before, target,
                            reason, report, window,
                            clamped=target != before // 2)

    def _rollback(self, pending, regression, report, window, now):
        """Revert the knob move in ``pending`` (its A/B window regressed) and
        freeze the knob so the controller does not immediately retry the move
        it just proved harmful. Recorded as a ``rollback`` decision carrying
        the regression evidence (ROADMAP follow-up: autotune regression
        rollback)."""
        rec = pending['record']
        knob, moved = rec['knob'], rec['action']
        reason = 'regression after {} {} ({}): reverting to {}'.format(
            moved, knob, regression.get('kind'), rec['from'])
        before = after = None
        if knob == 'workers':
            pool = self._pool
            if pool is None:
                return None
            before = pool.workers_count
            with decision_span(knob=knob, action='rollback', before=before,
                               target=rec['from'], reason=reason) as span:
                if moved == 'grow' and hasattr(pool, 'retire_worker_slot') \
                        and before > rec['from']:
                    pool.retire_worker_slot()
                    self._grown_slots = max(0, self._grown_slots - 1)
                elif moved == 'shrink' and hasattr(pool, 'add_worker_slot') \
                        and before < rec['from']:
                    pool.add_worker_slot()
                    self._grown_slots += 1
                after = pool.workers_count
                span.note(after=after)
                if self._ventilator is not None \
                        and hasattr(self._ventilator, 'set_max_queue_size'):
                    self._ventilator.set_max_queue_size(after + 2)
        elif knob == 'shuffle_capacity':
            loader = self._loader
            if loader is None or not hasattr(loader, 'set_shuffle_capacity'):
                return None
            before = getattr(loader, 'shuffle_capacity', 0)
            target = clamp(rec['from'], self.config.min_shuffle_capacity, None)
            with decision_span(knob=knob, action='rollback', before=before,
                               target=target, reason=reason):
                loader.set_shuffle_capacity(target)
            after = target
        else:
            return None
        if after == before:
            return None  # nothing to revert (pool declined / already there)
        state = self._knob_state(knob)
        state.last_t = now
        state.last_direction = None  # the reverted move does not count
        state.frozen_until = now + self.config.freeze_s
        logger.warning('autotune: %s move of %r regressed (%s); reverted and '
                       'frozen for %.1fs', moved, knob, regression.get('kind'),
                       self.config.freeze_s)
        return self._record(knob, 'rollback', before, after, reason, report,
                            window, clamped=False, regression=regression)

    @staticmethod
    def _bottleneck_share(report):
        stages = report.get('stages') or {}
        bottleneck = report.get('bottleneck')
        total = sum(stages.values())
        if not total or bottleneck not in stages:
            return 0.0
        return stages[bottleneck] / total

    # -- surfaces ------------------------------------------------------------

    def decision_records(self):
        with self._decisions_lock:
            return list(self.decisions)

    def proposal(self):
        """Current knob values as a config proposal (an offline replay's
        output; live tuners report the values they steered to)."""
        out = {}
        if self._pool is not None and hasattr(self._pool, 'workers_count'):
            out['workers_count'] = self._pool.workers_count
        if self._loader is not None and hasattr(self._loader, 'shuffle_capacity'):
            out['shuffling_queue_capacity'] = self._loader.shuffle_capacity
        return out
