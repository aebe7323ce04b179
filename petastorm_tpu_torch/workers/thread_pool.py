"""Thread pool: N daemon worker threads with a bounded results queue.

Trimmed twin of ``petastorm_tpu/workers/thread_pool.py``. Item failures
follow the pool-independent ``on_error``/``max_item_retries`` policy
(``workers/supervision.py``): ``'raise'`` forwards the first error to the
consumer thread with the worker-side traceback attached, ``'retry'``
re-enqueues the item up to the budget, ``'skip'`` quarantines it after the
budget so the epoch completes. An item that fails after it published is
completed as delivered, never re-run (that would deliver its rows twice).
Threads cannot die the way processes can, so there is no heartbeat or
respawn here. The autotuner's worker knob is :meth:`ThreadPool.add_worker_slot`
/ :meth:`ThreadPool.retire_worker_slot`: a retire rides the task queue as a
sentinel, so the thread finishes its item first.

Supervision under test: ``faults.on_item`` runs before every item (an
injected kill or segfault degrades to an error in a thread), and the opt-in
protocol monitor (``protocol_monitor=``, ``PSTPU_PROTOCOL_MONITOR``) sees
every dispatch, requeue, consumed message (each carries its dispatch id) and
completion, and the drain.

Telemetry: :meth:`ThreadPool.get_results` is the ``pool_wait`` stage the
stall report splits the loader's wait against; the item's trace context
rides the task tuple to its worker thread and back with the payload
(:attr:`ThreadPool.last_result_trace`); the workers' stage timers land in
this process's registry, so :meth:`ThreadPool.telemetry_snapshots` is empty.

Checkpoint plumbing, as the JAX pool's: ``ventilate`` pops the ventilator's
``_seq`` tag, :attr:`ThreadPool.last_result_seq` names the item whose payload
:meth:`ThreadPool.get_results` returned last, and ``done_callback(seq)``
fires when an item's completion is consumed, if it was delivered (a failed
or quarantined item completes undelivered, so a checkpoint re-reads it).
"""

from __future__ import annotations

import logging
import os
import queue
import sys
import threading

from petastorm_tpu_torch import faults, observability as obs
from petastorm_tpu_torch.errors import EmptyResultError
from petastorm_tpu_torch.observability import blackbox
from petastorm_tpu_torch.native.lifetime import registry as lifetime_registry
from petastorm_tpu_torch.workers.protocol import MSG_DATA, MSG_DONE, MSG_ERROR, DispatchIds
from petastorm_tpu_torch.workers.supervision import (ErrorPolicy, attach_remote_context,
                                                     format_exception_tb, quarantine_record)

logger = logging.getLogger(__name__)


class _Stopping(Exception):
    """Raised inside a worker by ``publish`` when the pool is stopping."""


#: task-queue sentinel retiring one worker thread
_RETIRE = object()


class ThreadPool(object):
    def __init__(self, workers_count, results_queue_size=50, on_error='raise',
                 max_item_retries=None, protocol_monitor=None):
        self._workers_count = workers_count
        self._next_worker_id = workers_count  # ids of slots grown at run time
        self._worker_class = self._worker_setup_args = None
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._task_queue = queue.Queue()
        self._stop_event = threading.Event()
        self._threads = []
        self._ventilator = None
        self._policy = ErrorPolicy.resolve(on_error, max_item_retries)
        self._counter_lock = threading.Lock()
        self._dispatch_ids = DispatchIds()
        self._ventilated_items = 0
        self._completed_items = 0
        self._items_requeued = 0
        self._quarantined = []
        self._tls = threading.local()  # per worker thread: the item's seq, whether it published
        #: seq of the item whose payload get_results returned last
        self.last_result_seq = None
        #: callable(seq) fired when a delivered item's completion is consumed
        self.done_callback = None
        #: virtual-root trace context of the item whose payload get_results
        #: returned last (None below the spans level)
        self.last_result_trace = None
        #: the opt-in protocol conformance monitor (docs/protocol.md), or None
        self.protocol_monitor = None
        if protocol_monitor or (protocol_monitor is None and
                                os.environ.get('PSTPU_PROTOCOL_MONITOR', '') not in ('', '0')):
            from petastorm_tpu_torch.analysis.protocol.monitor import monitor_from_env
            self.protocol_monitor = monitor_from_env(protocol_monitor, 'thread-pool')

    @property
    def workers_count(self):
        return self._workers_count

    def _start_thread(self, worker_id):
        worker = self._worker_class(worker_id, self._publish, self._worker_setup_args)
        thread = threading.Thread(target=self._worker_loop, args=(worker,), daemon=True,
                                  name='pstpu-torch-worker-{}'.format(worker_id))
        thread.start()
        self._threads.append(thread)

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._threads:
            raise RuntimeError('Pool already started')
        # the flight recorder: threads share the consumer's process, so one
        # recorder covers the pool and the consumer
        flight = blackbox.maybe_enable('consumer')
        if flight is not None:
            flight.register_lock('thread_pool.counter_lock', self._counter_lock)
            flight.watch('pool_completed', lambda: self._completed_items)
        # kept for slots grown at run time
        self._worker_class, self._worker_setup_args = worker_class, worker_setup_args
        for worker_id in range(self._workers_count):
            self._start_thread(worker_id)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def add_worker_slot(self):
        """Start one more worker thread; it takes items from the shared task
        queue like the others. Returns the new ``workers_count``."""
        if not self._threads:
            raise RuntimeError('Pool not started')
        with self._counter_lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            self._workers_count += 1
        self._start_thread(worker_id)
        logger.info('thread pool grew to %d workers', self._workers_count)
        return self._workers_count

    def retire_worker_slot(self):
        """Retire one worker thread (never below 1). The retire rides the
        task queue as a sentinel, so the exiting thread finishes its current
        item first and no item is abandoned. Returns the new
        ``workers_count``."""
        with self._counter_lock:
            if self._workers_count <= 1:
                return self._workers_count
            self._workers_count -= 1
        self._task_queue.put(_RETIRE)
        logger.info('thread pool retiring one worker (target %d)', self._workers_count)
        return self._workers_count

    def ventilate(self, *args, **kwargs):
        seq = kwargs.pop('_seq', None)
        # called inside the ventilator's mint block: the active context is
        # this item's, and it rides the task tuple
        ctx = obs.current_trace()
        with self._counter_lock:
            self._ventilated_items += 1
            d = self._dispatch_ids.next()
            if self.protocol_monitor is not None:
                # under the lock: concurrent ventilates report ids in order
                self.protocol_monitor.on_dispatch(d, seq)
        self._task_queue.put((d, seq, args, kwargs, 0, ctx))

    def get_results(self):
        """Block until a result is available; raise :class:`EmptyResultError`
        when all ventilated items are processed and no more will come, or
        once the pool was stopped and its queued results are drained (a
        stopped pool's unfinished items never complete, so a consumer thread
        still waiting here would wait forever). Timed as the ``pool_wait``
        stage."""
        with obs.stage('pool_wait', cat='pool') as sp:
            payload = self._get_results()
            # the item is known only once its payload arrives: the wait span
            # joins its tree afterwards
            sp.link(self.last_result_trace)
            return payload

    def _get_results(self):
        while True:
            try:
                kind, seq, payload, d, ctx = self._results_queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop_event.is_set():
                    raise EmptyResultError()
                if self._all_done():
                    if self.protocol_monitor is not None:
                        with self._counter_lock:
                            ventilated, completed = (self._ventilated_items,
                                                     self._completed_items)
                        self.protocol_monitor.on_drained(ventilated, completed)
                    raise EmptyResultError()
                continue
            if kind == MSG_DATA:
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_message('data', d, live=True)
                self.last_result_seq = seq
                self.last_result_trace = obs.root_of(ctx)
                return payload
            if kind == MSG_DONE:
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_message('done', d, live=True)
                # the payload is the delivered flag
                with self._counter_lock:
                    self._completed_items += 1
                    if self.protocol_monitor is not None:
                        self.protocol_monitor.on_complete(d, delivered=bool(payload))
                if self._ventilator is not None:
                    self._ventilator.processed_item(seq)
                if payload and seq is not None and self.done_callback is not None:
                    self.done_callback(seq)
            else:
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_message('error', d, live=True)
                raise payload

    def _all_done(self):
        # completed() is read BEFORE the counters: once it is true the
        # ventilated count is final, so the counter read cannot be stale
        if self._ventilator is not None and not self._ventilator.completed():
            return False
        with self._counter_lock:
            outstanding = self._ventilated_items > self._completed_items
        return not outstanding and self._results_queue.empty()

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()

    def join(self):
        if not self._stop_event.is_set():
            raise RuntimeError('join() must be called after stop()')
        for thread in self._threads:
            while thread.is_alive():
                # drain so workers blocked on a full results queue can exit
                try:
                    while True:
                        self._results_queue.get(block=False)
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)
        self._threads = []
        # a put already under way when stop() was set can land after a
        # thread's last drain: drop what the exited workers left, so no
        # payload (nor the borrow it holds) outlives the pool
        try:
            while True:
                self._results_queue.get(block=False)
        except queue.Empty:
            pass

    @property
    def quarantined_items(self):
        """Records of the items quarantined under ``on_error='skip'``."""
        with self._counter_lock:
            return list(self._quarantined)

    @property
    def diagnostics(self):
        """The pool diagnostics every pool type reports with the same keys;
        ``worker_restarts`` is always 0 here (threads fail by exception)."""
        with self._counter_lock:
            out = {'workers_count': self._workers_count,
                   'items_ventilated': self._ventilated_items,
                   'items_completed': self._completed_items,
                   'items_in_flight': self._ventilated_items - self._completed_items,
                   'results_queue_depth': self._results_queue.qsize(),
                   'worker_restarts': 0,
                   'items_requeued': self._items_requeued,
                   'items_quarantined': len(self._quarantined)}
        out.update(lifetime_registry().counters())
        return out

    def telemetry_snapshots(self):
        """The workers' metrics live in this process's registry already."""
        return []

    def _publish(self, data):
        self._tls.published = True
        self._put((MSG_DATA, self._tls.seq, data, self._tls.dispatch, self._tls.trace))

    def _put(self, record):
        """Bounded put that gives up when the pool stops, so a worker never
        deadlocks against a full results queue."""
        while not self._stop_event.is_set():
            try:
                self._results_queue.put(record, timeout=0.05)
                return
            except queue.Full:
                continue
        raise _Stopping()

    def _handle_item_failure(self, worker, d, seq, args, kwargs, attempts, ctx):
        """Apply the policy to the item that just raised (``attempts``
        counts this failure), on the worker thread."""
        exc = sys.exc_info()[1]
        if getattr(self._tls, 'published', False) and self._policy.on_error != 'raise':
            # its rows are in the results queue: a re-run would deliver them
            # twice, so the item completes as delivered
            logger.warning('Worker %d failed on item seq=%s AFTER publishing; completing the '
                           'item rather than re-running it: %s', worker.worker_id, seq, exc)
            self._put((MSG_DONE, seq, True, d, None))
            return
        if self._policy.should_retry_error(attempts):
            logger.warning('Worker %d failed on item seq=%s (attempt %d/%d); requeueing: %s',
                           worker.worker_id, seq, attempts,
                           self._policy.max_item_retries + 1, exc)
            with self._counter_lock:
                self._items_requeued += 1
                nd = self._dispatch_ids.next()
                if self.protocol_monitor is not None:
                    self.protocol_monitor.on_requeue(d, nd)
            obs.count('items_requeued')
            # a retry keeps the item's trace context: one item, one tree
            self._task_queue.put((nd, seq, args, kwargs, attempts, ctx))
            return
        if self._policy.quarantines():
            record = quarantine_record(seq, attempts, 'error', error=exc,
                                       tb=format_exception_tb(exc), worker_id=worker.worker_id,
                                       item={'args': args, 'kwargs': kwargs})
            with self._counter_lock:
                self._quarantined.append(record)
            obs.count('items_quarantined')
            logger.error('Quarantining item seq=%s after %d failed attempts: %s', seq, attempts,
                         record['error'])
            # completes undelivered: a checkpoint re-reads it
            self._put((MSG_DONE, seq, False, d, None))
            return
        attach_remote_context(exc, format_exception_tb(exc), worker_id=worker.worker_id, seq=seq)
        self._put((MSG_ERROR, None, exc, d, None))
        self._put((MSG_DONE, seq, False, d, None))

    def _worker_loop(self, worker):
        try:
            while not self._stop_event.is_set():
                try:
                    task = self._task_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if task is _RETIRE:
                    return  # a retired slot (worker.shutdown in finally)
                d, seq, args, kwargs, attempts, ctx = task
                self._tls.seq = seq
                self._tls.dispatch = d
                self._tls.published = False
                self._tls.trace = ctx
                try:
                    try:
                        faults.on_item(kwargs)
                        # the worker's stages open under the item's context
                        with obs.use_trace(ctx):
                            worker.process(*args, **kwargs)
                    except _Stopping:
                        raise
                    except Exception:  # noqa: BLE001 - routed through the error policy
                        self._handle_item_failure(worker, d, seq, args, kwargs, attempts + 1,
                                                  ctx)
                    else:
                        self._put((MSG_DONE, seq, True, d, None))
                except _Stopping:
                    return
        finally:
            worker.shutdown()
