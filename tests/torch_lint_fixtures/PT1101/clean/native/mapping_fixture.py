"""Clean twin: the hand-off is declared with a ``:borrows:`` section, so the
obligation is visible at every call site's definition (docs/analysis.md)."""

import numpy as np


def map_shard(path):
    """The whole shard as one flat byte view.

    :borrows: the returned memmap aliases the file; keep it (or any array
        built over it) no longer than the shard stays on disk.
    """
    return np.memmap(path, dtype=np.uint8, mode='r')
