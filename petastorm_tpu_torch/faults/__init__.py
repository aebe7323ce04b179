"""Seeded fault injection for the storage plane, and host churn for an
elastic pod.

Trimmed twin of ``petastorm_tpu/faults/__init__.py``:

* **storage faults**: :meth:`petastorm_tpu_torch.retry.RetryPolicy.call`
  consults :data:`petastorm_tpu_torch.retry.FAULT_POINT` before every
  attempt; installing a :class:`FaultPlan` with ``storage_fail_first > 0``
  makes the first N retried storage operations of the process raise a
  transient ``OSError(ECONNRESET)``, which drives the backoff path end to
  end. The plan is honoured only for that: its item, segfault and hang
  kinds come with the port of the fault lanes and raise
  :class:`NotImplementedError` when asked for.
* **host churn**: :class:`HostChurnPlan`, :func:`count_committed` and
  :func:`drive_host_churn` kill and join hosts of a pod of
  :mod:`petastorm_tpu_torch.elastic._hostproc` subprocesses
  (``docs/parallelism.md``, "Elastic pod sharding").

Usage::

    from petastorm_tpu_torch import faults
    faults.install(faults.FaultPlan(storage_fail_first=3))
    try:
        ...  # build readers; their first three storage operations fail
    finally:
        faults.uninstall()
"""

from __future__ import annotations

import errno
import logging
import os
import signal
import threading
import time

from petastorm_tpu_torch.errors import PetastormTpuError

logger = logging.getLogger(__name__)


class FaultInjectedError(PetastormTpuError):
    """The deterministic error of an injected item fault (the JAX package's
    item hooks; not ported yet)."""


class FaultPlan(object):
    """Picklable fault schedule, the JAX package's arguments.

    :param storage_fail_first: the first N storage operations of the process
        routed through :meth:`petastorm_tpu_torch.retry.RetryPolicy.call`
        raise a transient ``OSError(ECONNRESET)``.

    The item kinds (``kill_items``, ``error_items``, ``segv_items``,
    ``hang_items``) are not ported yet: a plan that asks for any of them
    raises :class:`NotImplementedError`. Their flags and ``state_dir`` are
    kept, so a plan built for the JAX package constructs here when it asks
    only for storage faults.
    """

    def __init__(self, kill_items=(), kill_once=True, error_items=(),
                 error_times=None, segv_items=(), segv_once=True,
                 hang_items=(), hang_once=True, hang_s=5.0,
                 storage_fail_first=0, state_dir=None):
        asked = [name for name, value in (('kill_items', kill_items),
                                          ('error_items', error_items),
                                          ('segv_items', segv_items),
                                          ('hang_items', hang_items)) if value]
        if asked:
            raise NotImplementedError(
                'FaultPlan({}=...) is not yet ported to petastorm_tpu_torch '
                '(ROADMAP.md, "sanitizer and fault lanes"): only storage_fail_first '
                'is'.format(asked[0]))
        self.kill_items = ()
        self.kill_once = bool(kill_once)
        self.error_items = ()
        self.error_times = error_times
        self.segv_items = ()
        self.segv_once = bool(segv_once)
        self.hang_items = ()
        self.hang_once = bool(hang_once)
        self.hang_s = float(hang_s)
        self.storage_fail_first = int(storage_fail_first)
        self.state_dir = state_dir

    def __repr__(self):
        return ('FaultPlan(kill_items={}, kill_once={}, error_items={}, '
                'error_times={}, segv_items={}, hang_items={}, hang_s={}, '
                'storage_fail_first={})'.format(
                    self.kill_items, self.kill_once, self.error_items,
                    self.error_times, self.segv_items, self.hang_items,
                    self.hang_s, self.storage_fail_first))


#: the process-wide installed plan (None: fault injection off, the
#: production state)
_PLAN = None
_storage_faults_fired = 0
_storage_lock = threading.Lock()


def install(plan):
    """Install ``plan`` process-wide and arm the storage hook. Returns the
    plan. ``install(None)`` is :func:`uninstall`."""
    global _PLAN, _storage_faults_fired
    from petastorm_tpu_torch import retry
    with _storage_lock:
        _PLAN = plan
        _storage_faults_fired = 0
    retry.FAULT_POINT = _storage_fault_point if (
        plan is not None and plan.storage_fail_first > 0) else None
    return plan


def uninstall():
    """Remove the installed plan and disarm every hook."""
    install(None)


def get_plan():
    return _PLAN


def storage_faults_fired():
    """How many storage faults the installed plan has raised so far."""
    with _storage_lock:
        return _storage_faults_fired


def _storage_fault_point():
    """The hook :meth:`RetryPolicy.call` invokes before each attempt."""
    global _storage_faults_fired
    with _storage_lock:
        plan = _PLAN
        if plan is None or _storage_faults_fired >= plan.storage_fail_first:
            return
        _storage_faults_fired += 1
        fired = _storage_faults_fired
    raise OSError(errno.ECONNRESET, 'injected transient storage fault {}/{}'.format(
        fired, plan.storage_fail_first))


# ---------------------------------------------------------------------------
# elastic-pod host churn (docs/parallelism.md, "Elastic pod sharding")
# ---------------------------------------------------------------------------

class HostChurnPlan(object):
    """A deterministic kill/join schedule for an elastic pod of
    ``petastorm_tpu_torch.elastic._hostproc`` subprocesses.

    :param kill_host: host id to SIGKILL (``None`` = no kill)
    :param kill_after_commits: fire the kill once the pod's commit scoreboard
        shows at least this many done markers: "mid-epoch" with a concrete,
        replayable definition
    :param join_host: host id to start right after the kill (``None`` = no
        join); the caller supplies the spawning callable
    """

    def __init__(self, kill_host=None, kill_after_commits=3, join_host=None):
        self.kill_host = kill_host
        self.kill_after_commits = int(kill_after_commits)
        self.join_host = join_host

    def __repr__(self):
        return ('HostChurnPlan(kill_host={!r}, kill_after_commits={}, join_host={!r})'
                .format(self.kill_host, self.kill_after_commits, self.join_host))


def count_committed(coord_dir):
    """The pod-wide committed row-group count: done markers across all
    epochs of an elastic coordination directory."""
    epochs_dir = os.path.join(coord_dir, 'epochs')
    total = 0
    try:
        epochs = os.listdir(epochs_dir)
    except OSError:
        return 0
    for epoch in epochs:
        try:
            total += len(os.listdir(os.path.join(epochs_dir, epoch, 'done')))
        except OSError:
            pass
    return total


def drive_host_churn(coord_dir, procs, plan, spawn_joiner=None, timeout_s=60.0, poll_s=0.05):
    """Run a :class:`HostChurnPlan` against running host subprocesses.

    Watches the pod's commit scoreboard under ``coord_dir``; once
    ``kill_after_commits`` markers exist, SIGKILLs ``procs[plan.kill_host]``
    (real process death: the lease goes stale and nobody cleans up), then
    calls ``spawn_joiner()``, which starts ``plan.join_host`` and returns its
    process (added to ``procs``). Returns a timeline dict to assert over or
    report."""
    deadline = time.monotonic() + timeout_s
    timeline = {'plan': repr(plan), 'killed': None, 'joined': None, 'commits_at_kill': None}
    if plan.kill_host is None and plan.join_host is None:
        return timeline
    while time.monotonic() < deadline:
        committed = count_committed(coord_dir)
        if committed >= plan.kill_after_commits:
            break
        time.sleep(poll_s)
    else:
        raise TimeoutError(
            'pod committed only {} row groups in {}s (wanted {} before the churn event)'.format(
                count_committed(coord_dir), timeout_s, plan.kill_after_commits))
    timeline['commits_at_kill'] = count_committed(coord_dir)
    if plan.kill_host is not None:
        victim = procs[plan.kill_host]
        logger.warning('host churn: SIGKILL %s (pid %s)', plan.kill_host, victim.pid)
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait()
        timeline['killed'] = plan.kill_host
    if plan.join_host is not None and spawn_joiner is not None:
        procs[plan.join_host] = spawn_joiner()
        timeline['joined'] = plan.join_host
    return timeline


__all__ = ['FaultInjectedError', 'FaultPlan', 'HostChurnPlan', 'count_committed',
           'drive_host_churn', 'get_plan', 'install', 'storage_faults_fired', 'uninstall']
