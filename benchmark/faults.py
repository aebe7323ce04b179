"""Faults planted in the program under test, for the benchmark's own checks
that ``correct`` comes out false (``benchmark/tests/test_bench_runs.py``,
``benchmark/calibrate.py``). A benchmark run plants none.

Each is a context manager that patches the program in this process. A model
kind (``benchmark/models/<model>.py``) brings the faults of its own in its
``FAULTS`` (a step that returns its state unchanged, a loss over half the
batch, a field of its batches altered); this module adds the one every kind
can have:

- ``dropped_rows``: the rows of the first row group (ids under 64) are
  staged under other rows' ids, so they are never seen.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` while the context lasts (an attribute
    ``obj`` inherits is inherited again after it)."""
    own = name in vars(obj)
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, saved)
        else:
            delattr(obj, name)


def altered(field, change):
    """Every batch's ``field`` changed on the host just before the infeed
    stages it: ``change(values)`` edits a copy of the batch's array in
    place."""
    from petastorm_tpu_torch.torch import infeed

    stage = infeed._stage_local

    def alter(batch, device, stream=None):
        batch = dict(batch)
        values = np.array(batch[field])
        change(values)
        batch[field] = values
        return stage(batch, device, stream=stream)

    return patched(infeed, '_stage_local', alter)


def _drop_first_group(row_ids):
    row_ids[row_ids < 64] += 64


FAULTS = {'dropped_rows': lambda: altered('row_id', _drop_first_group)}


def names(kind):
    """The faults a run of model kind ``kind`` can have."""
    return sorted(set(FAULTS) | set(kind.FAULTS))


def planted(name, kind):
    """The context manager that plants fault ``name`` in a run of model
    kind ``kind``."""
    return dict(FAULTS, **kind.FAULTS)[name]()
