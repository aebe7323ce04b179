def grow(self):
    self._pool.add_worker_slot()
