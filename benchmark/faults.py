"""Faults planted in the program under test, for the benchmark's own checks
that ``correct`` comes out false (``benchmark/tests/test_bench_faults.py``,
``benchmark/calibrate.py``). A benchmark run plants none.

Each is a context manager that patches the program in this process:

- ``frozen_step``: the optimizer's update does nothing, so a step returns
  its state unchanged;
- ``half_batch``: the loss is the mean over the first half of the batch;
- ``altered_pixel``: one pixel of every batch is changed on the host, just
  before the infeed stages it;
- ``altered_label``: one label of every batch is changed there;
- ``dropped_rows``: the rows of the first row group (ids under 64) are
  staged under other rows' ids, so they are never seen.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _frozen_step():
    import torch

    return _patched(torch.optim.SGD, 'step', lambda self, closure=None: None)


def _half_batch():
    from petastorm_tpu_torch.models import train

    objective = train.classification_objective

    def half(logits, labels):
        keep = logits.shape[0] // 2
        return objective(logits[:keep], labels[:keep])

    return _patched(train, 'classification_objective', half)


def _altered(field):
    from petastorm_tpu_torch.torch import infeed

    stage = infeed._stage_local

    def alter(batch, device, stream=None):
        batch = dict(batch)
        values = np.array(batch[field])
        if field == 'row_id':
            values[values < 64] += 64
        else:
            flat = values.reshape(-1)
            modulus = 256 if field == 'image' else 1000
            flat[0] = (int(flat[0]) + (128 if field == 'image' else 1)) % modulus
        batch[field] = values
        return stage(batch, device, stream=stream)

    return _patched(infeed, '_stage_local', alter)


FAULTS = {
    'frozen_step': _frozen_step,
    'half_batch': _half_batch,
    'altered_pixel': lambda: _altered('image'),
    'altered_label': lambda: _altered('label'),
    'dropped_rows': lambda: _altered('row_id'),
}


def planted(name):
    """The context manager that plants fault ``name``."""
    return FAULTS[name]()
