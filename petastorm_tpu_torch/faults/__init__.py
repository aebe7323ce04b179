"""Host churn for an elastic pod: a deterministic kill/join schedule.

Trimmed twin of the host-churn part of ``petastorm_tpu/faults/__init__.py``
(:class:`HostChurnPlan`, :func:`count_committed`, :func:`drive_host_churn`),
driving pods of :mod:`petastorm_tpu_torch.elastic._hostproc` subprocesses
(``docs/parallelism.md``, "Elastic pod sharding"). The seeded fault injection
of the JAX package's ``faults`` (storage, worker and network faults) comes
with the port of the fault lanes.
"""

from __future__ import annotations

import logging
import os
import signal
import time

logger = logging.getLogger(__name__)


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


__all__ = ['HostChurnPlan', 'count_committed', 'drive_host_churn']
