"""Fixed-size rebatching of columnar reader output.

Twin of ``petastorm_tpu/rebatch.py``: ``make_batch_reader(batch_size=N)`` and
``make_reader(output='columnar', batch_size=N)`` yield batches of exactly
``N`` rows (the last one shorter, unless ``drop_last``) instead of one batch
per row group. The block buffer is :class:`~petastorm_tpu_torch.columnar.BatchingColumnQueue`;
this module owns the results reader that pumps the pool through it.
"""

from __future__ import annotations

from petastorm_tpu_torch.columnar import BatchingColumnQueue
from petastorm_tpu_torch.errors import EmptyResultError


class RebatchingResultsQueueReader(object):
    """Consumer side that emits namedtuples of exactly ``batch_size`` rows.

    Checkpoints: an item is delivered only when its last row drains into a
    yielded batch; an item that published no row is delivered by its
    completion. Rows dropped by ``drop_last`` are not delivered, so a state
    taken after the drop re-reads their row groups."""

    batched_output = True

    def __init__(self, schema, batch_size, drop_last=False):
        self._schema = schema
        self._queue = BatchingColumnQueue(batch_size)
        self._drop_last = drop_last
        self._exhausted = False
        self._open_seqs = set()  # items with rows still in the queue
        self.delivered_callback = None

    def on_item_done(self, seq):
        """An item with rows still queued is delivered when they drain; one
        never seen (it published no row) is delivered now."""
        if seq not in self._open_seqs and self.delivered_callback is not None:
            self.delivered_callback(seq)

    def _mark_drained(self):
        for seq in self._queue.pop_drained_tags():
            self._open_seqs.discard(seq)
            if self.delivered_callback is not None:
                self.delivered_callback(seq)

    def read_next(self, pool):
        while self._queue.empty():
            if self._exhausted:
                # the pool ended the pass: flush the short batch, or drop it
                remainder = self._queue.drain()
                if self._drop_last:
                    remainder = None
                    for seq in self._queue.pop_drained_tags():
                        self._open_seqs.discard(seq)
                else:
                    self._mark_drained()
                self._exhausted = False  # re-armed for reset()
                if remainder is None:
                    raise EmptyResultError()
                return self._schema.make_namedtuple(**remainder)
            try:
                batch = pool.get_results()
            except EmptyResultError:
                self._exhausted = True
                continue
            seq = getattr(pool, 'last_result_seq', None)
            if seq is not None:
                self._open_seqs.add(seq)
            self._queue.put(batch, tag=seq)
        out = self._queue.get()
        self._mark_drained()
        return self._schema.make_namedtuple(**out)
