"""A borrow crossing a process boundary uncopied: the queued bytes alias the
producer-owned ring slot, which is reclaimed on the producer's schedule — the
receiver sees torn data (or a guard fault) with no local cause."""


def forward_batch(ring, out_queue):
    view = ring.try_read_zero_copy()
    out_queue.put(view)
