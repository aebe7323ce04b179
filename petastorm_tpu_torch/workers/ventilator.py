"""Ventilator: feeds work items into a pool with a bounded in-flight count.

Trimmed twin of ``ConcurrentVentilator`` in
``petastorm_tpu/workers/ventilator.py``. The per-epoch reshuffle is the same
``np.random.default_rng(seed).permutation`` draw, so a seed gives the JAX
package's row-group order. Checkpoint tagging and resume are not ported yet.
"""

from __future__ import annotations

import threading

import numpy as np


class ConcurrentVentilator(object):
    """Ventilates ``items_to_ventilate`` (kwargs dicts for ``ventilate_fn``)
    from a background thread.

    :param iterations: passes over the items; ``None`` = infinite
    :param max_ventilation_queue_size: max in-flight (ventilated - processed) items
    :param randomize_item_order: reshuffle item order before each epoch
    :param random_seed: seed of the reshuffle RNG (``None`` = nondeterministic)
    """

    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 max_ventilation_queue_size=None, randomize_item_order=False, random_seed=None):
        if iterations is not None and (not isinstance(iterations, int) or iterations < 1):
            raise ValueError('iterations must be a positive integer or None, got {!r}'.format(iterations))
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._iterations_remaining = iterations
        self._randomize_item_order = randomize_item_order
        self._rng = np.random.default_rng(random_seed)
        self._max_in_flight = (max_ventilation_queue_size if max_ventilation_queue_size is not None
                               else max(1, len(self._items)))
        self._in_flight = 0
        self._cv = threading.Condition()
        self._stop_requested = False
        self._completed = not self._items
        self._thread = None

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Ventilator already started')
        if self.completed():
            return
        self._thread = threading.Thread(target=self._ventilate_loop, daemon=True,
                                        name='pstpu-torch-ventilator')
        self._thread.start()

    def processed_item(self):
        """Called by the pool once per ventilated item that finished."""
        with self._cv:
            self._in_flight -= 1
            self._cv.notify()

    def completed(self):
        """True when no more items will ever be ventilated."""
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

    def _ventilate_loop(self):
        while True:
            with self._cv:
                if self._stop_requested:
                    break
                if self._iterations_remaining is not None and self._iterations_remaining <= 0:
                    break
                order = range(len(self._items))
                if self._randomize_item_order:
                    order = [int(i) for i in self._rng.permutation(len(self._items))]
            for index in order:
                with self._cv:
                    while self._in_flight >= self._max_in_flight and not self._stop_requested:
                        self._cv.wait(timeout=0.1)
                    if self._stop_requested:
                        return
                    self._in_flight += 1
                self._ventilate_fn(**self._items[index])
            with self._cv:
                if self._iterations_remaining is not None:
                    self._iterations_remaining -= 1
        with self._cv:
            self._completed = True
