"""Stub workers and transforms for the pool tests (twin of
``petastorm_tpu/test_util/stub_workers.py``). They live in the package, not
in a test module, so spawned worker processes unpickle them without
importing the test module (and with it torch and JAX)."""

from __future__ import annotations

import os
import sys

import numpy as np

from petastorm_tpu_torch.workers.worker_base import WorkerBase


def _first_time(state_dir, name):
    """True the first time ``name`` is claimed under ``state_dir``, in any
    process (an ``O_EXCL`` flag file)."""
    try:
        fd = os.open(os.path.join(state_dir, name), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


class IdentityWorker(WorkerBase):
    """Publishes each ventilated value unchanged."""

    def process(self, value):
        self.publish(value)


class ExceptionEveryNWorker(WorkerBase):
    """Raises on every item whose value % n == 0; ``args`` is n."""

    def process(self, value):
        if value % (self.args or 5) == 0:
            raise ValueError('stub failure on {}'.format(value))
        self.publish(value)


class CrashOnceWorker(WorkerBase):
    """SIGKILLs its process the first time it sees ``args['crash_on']``
    (once across respawns, through ``args['state_dir']``); every other item,
    and the retried one, passes through."""

    def process(self, item):
        if item == self.args['crash_on'] and _first_time(self.args['state_dir'], 'crashed'):
            os.kill(os.getpid(), 9)
        self.publish(item)


class HardExitWorker(WorkerBase):
    """Exits its process (no exception forwarded) on every item equal to
    ``args['crash_on']``; other items pass through."""

    def process(self, item):
        if item == self.args['crash_on']:
            os._exit(13)
        self.publish([item])


class PublishThenErrorWorker(WorkerBase):
    """Publishes its item, then raises, on the first attempt of each item in
    ``args['fail_on']``: an item that fails after it published must not be
    re-run (its rows would arrive twice)."""

    def process(self, item):
        self.publish(item)
        if item in self.args.get('fail_on', ()) and _first_time(
                self.args['state_dir'], 'pub_err_{}'.format(item)):
            raise ValueError('post-publish failure on {}'.format(item))


class NumpyBatchWorker(WorkerBase):
    """Publishes one deterministic column block of ``n`` rows per item."""

    def process(self, n):
        self.publish({'x': np.arange(n, dtype=np.int64),
                      'y': (np.arange(n, dtype=np.float64) * 0.5).reshape(n, 1),
                      'tag': np.full(n, n % 7, dtype=np.uint8)})


class ProbeWorker(WorkerBase):
    """Publishes what its process sees: whether ``torch`` was imported, the
    pid, and ``PSTPU_IMG_THREADS``."""

    def process(self, item):
        self.publish({'item': item, 'torch_imported': 'torch' in sys.modules,
                      'pid': os.getpid(), 'img_threads': os.environ.get('PSTPU_IMG_THREADS')})


class FailOnLabel(object):
    """A batched ``TransformSpec`` function that raises on the row group
    holding label ``label``: always, or only the first ``times`` times
    (counted through flag files under ``state_dir``, across processes)."""

    def __init__(self, label, times=None, state_dir=None):
        self.label, self.times, self.state_dir = label, times, state_dir

    def __call__(self, block):
        if self.label in block['label']:
            if self.times is None or any(_first_time(self.state_dir, 'fail_{}'.format(k))
                                         for k in range(self.times)):
                raise ValueError('injected failure on label {}'.format(self.label))
        return block
