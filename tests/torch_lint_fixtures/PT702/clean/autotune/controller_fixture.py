def grow(self):
    with decision_span(knob='workers'):
        self._pool.add_worker_slot()
