"""Seeded use-after-release, the static view: the consumer parks a borrowed
ring view on ``self``, so it outlives the frame while the slot registry knows
nothing about it — the next release reclaims the slot and the parked view
reads recycled bytes. The runtime twin of this exact defect is provoked under
the PROT_NONE guard in tests/test_sanitized_native.py."""


class StashingConsumer(object):
    def __init__(self):
        self._last_view = None

    def poll(self, ring):
        view = ring.try_read_zero_copy()
        self._last_view = view  # kept past the slot's release
        return bytes(view)
