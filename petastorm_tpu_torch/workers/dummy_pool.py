"""Dummy pool: synchronous execution on the CONSUMER thread.

Trimmed twin of ``petastorm_tpu/workers/dummy_pool.py``. ``ventilate`` only
enqueues; ``worker.process`` runs inside :meth:`get_results` on the caller's
thread, in ventilation order, which makes the output order a pure function of
the ventilator's seed (what the parity tests compare). Item failures follow
the same ``on_error``/``max_item_retries`` policy as the other pools
(``workers/supervision.py``), so a pipeline behaves the same when dropped
onto this pool for debugging.

Checkpoint plumbing, as the JAX pool's: ``ventilate`` keeps the ventilator's
``_seq`` tag with the item, :attr:`DummyPool.last_result_seq` names the item
whose payload :meth:`DummyPool.get_results` returned last, and a delivered
item's completion enters the results queue behind its payloads, where
``done_callback(seq)`` fires as it is consumed; a failed or quarantined item
completes undelivered.

Supervision under test: ``faults.on_item`` runs before every item (an
injected kill or segfault degrades to an error here), and the opt-in
protocol monitor (``protocol_monitor=``, ``PSTPU_PROTOCOL_MONITOR``) sees
every dispatch, publish, requeue, completion and the drain. The worker runs
on the consumer thread, so a payload enters the results deque before its
item's completion: the monitor's delivery event fires at publish time.

Telemetry: :meth:`DummyPool.get_results` is the ``pool_wait`` stage; it runs
the worker on this thread, so it contains the worker's stage timers, which
the stall report's proportional split expects. The item's trace context
rides the pending tuple and the payload (:attr:`DummyPool.last_result_trace`).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

from petastorm_tpu_torch import faults, observability as obs
from petastorm_tpu_torch.errors import EmptyResultError
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry
from petastorm_tpu_torch.workers.protocol import MSG_DATA, MSG_DONE, DispatchIds
from petastorm_tpu_torch.workers.supervision import (ErrorPolicy, attach_remote_context,
                                                     format_exception_tb, quarantine_record)

logger = logging.getLogger(__name__)


class DummyPool(object):
    def __init__(self, on_error='raise', max_item_retries=None, protocol_monitor=None):
        self.workers_count = 1
        # (MSG_DATA, seq, payload, trace context) | (MSG_DONE, seq, None, None)
        self._results = deque()
        # (dispatch id, args, kwargs, failed attempts, trace context); _seq rides kwargs
        self._pending = deque()
        self._lock = threading.Lock()
        # serializes worker.process against join()'s worker.shutdown: the
        # thread running the worker (a loader's pump, as in diagnose
        # --watch) may be inside native code over mapped pages while
        # another thread tears the pool down; shutting the worker under its
        # feet is a segfault, not an exception
        self._exec_lock = threading.Lock()
        self._worker = None
        self._ventilator = None
        self._policy = ErrorPolicy.resolve(on_error, max_item_retries)
        self._dispatch_ids = DispatchIds()
        self._published = False
        self._current_dispatch = None
        self._current_seq = None
        self._current_trace = None
        self._ventilated_items = 0
        self._completed_items = 0
        self._items_requeued = 0
        self._quarantined = []
        #: seq of the item whose payload get_results returned last
        self.last_result_seq = None
        #: callable(seq) fired when a delivered item's completion is consumed
        self.done_callback = None
        #: virtual-root trace context of the item whose payload get_results
        #: returned last (None below the spans level)
        self.last_result_trace = None
        self._stopped = False
        #: the opt-in protocol conformance monitor (docs/protocol.md), or None
        self.protocol_monitor = None
        if protocol_monitor or (protocol_monitor is None and
                                os.environ.get('PSTPU_PROTOCOL_MONITOR', '') not in ('', '0')):
            from petastorm_tpu_torch.analysis.protocol.monitor import monitor_from_env
            self.protocol_monitor = monitor_from_env(protocol_monitor, 'dummy-pool')

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._worker is not None:
            raise RuntimeError('Pool already started')
        flight = blackbox.maybe_enable('consumer')
        if flight is not None:
            flight.register_lock('dummy_pool.lock', self._lock)
            flight.watch('pool_completed', lambda: self._completed_items)
        with self._exec_lock:
            self._worker = worker_class(0, self._publish, worker_setup_args)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def _publish(self, data):
        self._published = True
        if self.protocol_monitor is not None and self._current_dispatch is not None:
            self.protocol_monitor.on_message('data', self._current_dispatch, live=True)
        self._results.append((MSG_DATA, self._current_seq, data, self._current_trace))

    def ventilate(self, *args, **kwargs):
        # the ventilator's mint block is active here: the item's context
        # rides the pending tuple
        ctx = obs.current_trace()
        with self._lock:
            self._ventilated_items += 1
            d = self._dispatch_ids.next()
            if self.protocol_monitor is not None:
                self.protocol_monitor.on_dispatch(d, kwargs.get('_seq'))
            self._pending.append((d, args, kwargs, 0, ctx))

    def _process_one(self):
        """Run one pending item on this thread; False when none is queued."""
        with self._lock:
            if not self._pending or self._worker is None:
                return False
            d, args, orig_kwargs, attempts, ctx = self._pending.popleft()
        kwargs = dict(orig_kwargs)
        self._current_seq = kwargs.pop('_seq', None)
        self._current_dispatch = d
        self._current_trace = ctx
        self._published = False
        try:
            with self._exec_lock:
                worker = self._worker
                if worker is None:
                    return False  # joined meanwhile: nothing is left to run
                faults.on_item(kwargs)
                with obs.use_trace(ctx):
                    worker.process(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - routed through the error policy
            outcome = self._handle_item_failure(exc, d, args, orig_kwargs, attempts + 1)
            if outcome is None:
                return True  # requeued: not complete yet
            self._complete(d, delivered=outcome)
        else:
            self._results.append((MSG_DONE, self._current_seq, None, None))
            self._complete(d, delivered=True)
        return True

    def _complete(self, d, delivered):
        with self._lock:
            self._completed_items += 1
            if self.protocol_monitor is not None:
                self.protocol_monitor.on_complete(d, delivered)
        if self._ventilator is not None:
            self._ventilator.processed_item(self._current_seq)

    def _handle_item_failure(self, exc, d, args, kwargs, attempts):
        """Apply the policy. Returns None when the item was requeued, else
        whether it completes delivered. Under ``'raise'`` the exception
        propagates (the item counts complete, undelivered)."""
        seq = self._current_seq
        if self._published and self._policy.on_error != 'raise':
            # its rows are already delivered: a re-run would deliver them twice
            logger.warning('Item seq=%s failed AFTER publishing; completing the item rather '
                           'than re-running it: %s', seq, exc)
            self._results.append((MSG_DONE, seq, None, None))
            return True
        if self._policy.should_retry_error(attempts):
            logger.warning('Item seq=%s failed (attempt %d/%d); requeueing: %s', seq, attempts,
                           self._policy.max_item_retries + 1, exc)
            with self._lock:
                nd = self._dispatch_ids.next()
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_requeue(d, nd)
                # a retry keeps the item's trace context
                self._pending.append((nd, args, kwargs, attempts, self._current_trace))
                self._items_requeued += 1
            obs.count('items_requeued')
            return None
        if self._policy.quarantines():
            record = quarantine_record(seq, attempts, 'error', error=exc,
                                       tb=format_exception_tb(exc), worker_id=0,
                                       item={'args': args, 'kwargs': kwargs})
            with self._lock:
                self._quarantined.append(record)
            obs.count('items_quarantined')
            logger.error('Quarantining item seq=%s after %d failed attempts: %s', seq, attempts,
                         record['error'])
            return False
        self._complete(d, delivered=False)
        if self._ventilator is not None:
            self._ventilator.stop()
        raise attach_remote_context(exc, format_exception_tb(exc), worker_id=0, seq=seq)

    def _pop_ready(self):
        """Pop queued entries until a payload; completions met on the way
        fire ``done_callback``. The payload, or None when the queue ran dry."""
        while self._results:
            kind, seq, payload, ctx = self._results.popleft()
            if kind == MSG_DATA:
                self.last_result_seq = seq
                self.last_result_trace = obs.root_of(ctx)
                return payload
            if seq is not None and self.done_callback is not None:
                self.done_callback(seq)
        return None

    def get_results(self):
        # the worker runs on this thread inside the wait: the pool-wait timer
        # contains the worker's stage timers
        with obs.stage('pool_wait', cat='pool') as sp:
            payload = self._get_results()
            sp.link(self.last_result_trace)
            return payload

    def _get_results(self):
        while True:
            payload = self._pop_ready()
            if payload is not None:
                return payload
            if self._process_one():
                continue
            if self._ventilator is None or self._ventilator.completed():
                # re-check: the ventilator may have enqueued between the
                # emptiness check and completed() flipping true
                if self._process_one():
                    continue
                payload = self._pop_ready()
                if payload is not None:
                    return payload
                if self.protocol_monitor is not None and not self._stopped:
                    # after stop() the pending queue was dropped on purpose,
                    # so the drain is no convergence claim
                    with self._lock:
                        ventilated, completed = self._ventilated_items, self._completed_items
                    self.protocol_monitor.on_drained(ventilated, completed)
                raise EmptyResultError()
            time.sleep(0.0001)

    def stop(self):
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()
        with self._lock:
            self._pending.clear()

    def join(self):
        with self._exec_lock:
            # a thread mid-process finishes its item before the worker's
            # files and mappings are torn down
            if self._worker is not None:
                self._worker.shutdown()
                self._worker = None

    @property
    def quarantined_items(self):
        """Records of the items quarantined under ``on_error='skip'``."""
        with self._lock:
            return list(self._quarantined)

    @property
    def diagnostics(self):
        """The pool diagnostics every pool type reports with the same keys."""
        with self._lock:
            out = {'workers_count': self.workers_count,
                   'items_ventilated': self._ventilated_items,
                   'items_completed': self._completed_items,
                   'items_in_flight': self._ventilated_items - self._completed_items,
                   'results_queue_depth': len(self._results),
                   'worker_restarts': 0,
                   'items_requeued': self._items_requeued,
                   'items_quarantined': len(self._quarantined)}
        out.update(lifetime_registry().counters())
        return out

    def telemetry_snapshots(self):
        """The worker's metrics live in this process's registry already."""
        return []
