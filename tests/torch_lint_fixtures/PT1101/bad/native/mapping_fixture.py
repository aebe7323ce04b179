"""A borrow-returning function with no ``:borrows:`` docstring section: the
caller inherits the mapping's lifetime obligation without any visible
contract at the definition."""

import numpy as np


def map_shard(path):
    """The whole shard as one flat byte view."""
    return np.memmap(path, dtype=np.uint8, mode='r')
