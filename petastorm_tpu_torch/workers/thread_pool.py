"""Thread pool: N daemon worker threads with a bounded results queue.

Trimmed twin of ``petastorm_tpu/workers/thread_pool.py``: the first worker
error is re-raised on the consumer thread (the JAX package's
``on_error='raise'``). Retry/skip policies, slot grow/retire and the
protocol monitor are not ported yet.
"""

from __future__ import annotations

import queue
import threading

from petastorm_tpu_torch.errors import EmptyResultError

_DATA, _DONE, _ERROR = 'data', 'done', 'error'


class _Stopping(Exception):
    """Raised inside a worker by ``publish`` when the pool is stopping."""


class ThreadPool(object):
    def __init__(self, workers_count, results_queue_size=50):
        self.workers_count = workers_count
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._task_queue = queue.Queue()
        self._stop_event = threading.Event()
        self._threads = []
        self._ventilator = None
        self._counter_lock = threading.Lock()
        self._ventilated_items = 0
        self._completed_items = 0

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._threads:
            raise RuntimeError('Pool already started')
        for worker_id in range(self.workers_count):
            worker = worker_class(worker_id, self._publish, worker_setup_args)
            thread = threading.Thread(target=self._worker_loop, args=(worker,), daemon=True,
                                      name='pstpu-torch-worker-{}'.format(worker_id))
            thread.start()
            self._threads.append(thread)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def ventilate(self, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        self._task_queue.put(kwargs)

    def get_results(self):
        """Block until a result is available; raise :class:`EmptyResultError`
        when all ventilated items are processed and no more will come."""
        while True:
            try:
                kind, payload = self._results_queue.get(timeout=0.05)
            except queue.Empty:
                if self._all_done():
                    raise EmptyResultError()
                continue
            if kind == _DATA:
                return payload
            if kind == _DONE:
                with self._counter_lock:
                    self._completed_items += 1
                if self._ventilator is not None:
                    self._ventilator.processed_item()
            else:
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

    def _publish(self, data):
        self._put((_DATA, data))

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

    def _worker_loop(self, worker):
        try:
            while not self._stop_event.is_set():
                try:
                    kwargs = self._task_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    try:
                        worker.process(**kwargs)
                    except _Stopping:
                        raise
                    except Exception as exc:  # noqa: BLE001 - re-raised on the consumer thread
                        self._put((_ERROR, exc))
                    self._put((_DONE, None))
                except _Stopping:
                    return
        finally:
            worker.shutdown()
