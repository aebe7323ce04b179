"""Clean twin: the borrow is copied into owned bytes before it is queued —
the wire payload no longer aliases the producer's slot."""


def forward_batch(ring, out_queue):
    view = ring.try_read_zero_copy()
    out_queue.put(bytes(view))
