"""Seeded fault injection for the worker and storage planes, and host churn
for an elastic pod.

Twin of ``petastorm_tpu/faults/__init__.py``: faults fire at well-defined
hook points in the real code paths, so what recovers in a chaos run is what
recovers in production.

* **item hooks**: every pool's worker loop calls :func:`on_item` with the
  ventilated kwargs right before ``worker.process``. A :class:`FaultPlan`
  keyed on ``piece_index`` can kill the worker process (``SIGKILL`` or
  ``SIGSEGV`` mid-item, process pools only), wedge it for ``hang_s``, or
  raise :class:`FaultInjectedError` inside decode.
* **storage hook**: :meth:`petastorm_tpu_torch.retry.RetryPolicy.call`
  consults :data:`petastorm_tpu_torch.retry.FAULT_POINT` before every
  attempt; a plan with ``storage_fail_first > 0`` makes the first N retried
  storage operations of each process raise a transient
  ``OSError(ECONNRESET)``.
* **network hooks** (the chunk fabric, ``docs/fabric.md``): a
  :class:`NetFaultPlan` installed with :func:`install_net` refuses the
  fabric client's first connects (:func:`on_net_connect`) and resets,
  truncates, corrupts or stalls the fabric server's first payload sends
  (:func:`net_payload_action`).
* **host churn**: :class:`HostChurnPlan`, :func:`count_committed` and
  :func:`drive_host_churn` kill and join hosts of a pod of
  :mod:`petastorm_tpu_torch.elastic._hostproc` subprocesses
  (``docs/parallelism.md``, "Elastic pod sharding").

Determinism: one-shot faults (``kill_once``, ``segv_once``, ``hang_once``,
``error_times``) coordinate across worker respawns and spawned processes
through sentinel files in ``state_dir`` (``O_CREAT|O_EXCL``: exactly one
attempt wins each shot), so a seeded run replays the same failure schedule.
Plans are picklable and ride the process pool's worker setup args into its
spawned workers.

Usage::

    from petastorm_tpu_torch import faults
    faults.install(faults.FaultPlan(kill_items=(3,), state_dir=tmpdir))
    try:
        ...  # build readers; their workers inherit the plan
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
    """The deterministic error :func:`on_item` raises for ``error_items`` (and
    for ``kill_items``/``segv_items`` outside a spawned worker process, where
    the signal would take down the caller's whole process)."""


class FaultPlan(object):
    """Picklable fault schedule, the JAX package's arguments.

    :param kill_items: piece indices whose processing SIGKILLs the worker
        process mid-item (process pools; degrades to
        :class:`FaultInjectedError` in thread/dummy pools).
    :param kill_once: each ``kill_items`` entry fires on its first attempt
        only, so the requeued attempt succeeds. Requires ``state_dir``.
    :param error_items: piece indices that raise :class:`FaultInjectedError`
        inside the worker.
    :param error_times: fire each ``error_items`` entry only on its first N
        attempts (requires ``state_dir``); ``None`` = every attempt, a
        *poison* item.
    :param segv_items: piece indices whose processing raises ``SIGSEGV`` in
        the worker process mid-item, a stand-in for a native decoder crash:
        unlike SIGKILL it leaves the flight recorder's faulthandler sidecar.
        Process pools only; degrades to :class:`FaultInjectedError`
        elsewhere. One-shot per index (requires ``state_dir``) unless
        ``segv_once=False``.
    :param hang_items: piece indices whose processing wedges for ``hang_s``
        seconds inside a ``fault.fault_hang`` stage before proceeding.
        One-shot per index (requires ``state_dir``) unless
        ``hang_once=False``.
    :param hang_s: how long each ``hang_items`` entry sleeps.
    :param storage_fail_first: the first N storage operations of each
        process routed through
        :meth:`petastorm_tpu_torch.retry.RetryPolicy.call` raise a transient
        ``OSError(ECONNRESET)``.
    :param state_dir: directory for cross-process one-shot coordination files.
    """

    def __init__(self, kill_items=(), kill_once=True, error_items=(),
                 error_times=None, segv_items=(), segv_once=True,
                 hang_items=(), hang_once=True, hang_s=5.0,
                 storage_fail_first=0, state_dir=None):
        self.kill_items = tuple(kill_items)
        self.kill_once = bool(kill_once)
        self.error_items = tuple(error_items)
        self.error_times = error_times
        self.segv_items = tuple(segv_items)
        self.segv_once = bool(segv_once)
        self.hang_items = tuple(hang_items)
        self.hang_once = bool(hang_once)
        self.hang_s = float(hang_s)
        self.storage_fail_first = int(storage_fail_first)
        self.state_dir = state_dir
        if (self.kill_items and self.kill_once) or \
                (self.error_items and self.error_times is not None) or \
                (self.segv_items and self.segv_once) or \
                (self.hang_items and self.hang_once):
            if not state_dir:
                raise ValueError('one-shot faults (kill_once / error_times / '
                                 'segv_once / hang_once) need a state_dir for '
                                 'cross-process coordination')

    def __repr__(self):
        return ('FaultPlan(kill_items={}, kill_once={}, error_items={}, '
                'error_times={}, segv_items={}, hang_items={}, hang_s={}, '
                'storage_fail_first={})'.format(
                    self.kill_items, self.kill_once, self.error_items,
                    self.error_times, self.segv_items, self.hang_items,
                    self.hang_s, self.storage_fail_first))


#: the process-wide installed plan (None: fault injection off, the
#: production state: on_item is one attribute load and a None compare per item)
_PLAN = None
_IN_SPAWNED_WORKER = False
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


def mark_in_spawned_worker():
    """Called by the process pool's worker bootstrap: SIGKILL and SIGSEGV
    faults are honoured only in a spawned worker process (anywhere else they
    would kill the consumer; thread and dummy pools degrade them to raised
    errors)."""
    global _IN_SPAWNED_WORKER
    _IN_SPAWNED_WORKER = True


def _claim_one_shot(state_dir, token):
    """True exactly once per token across all processes sharing state_dir."""
    try:
        fd = os.open(os.path.join(state_dir, token), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    except OSError as e:
        # unusable state dir: fail open (no fault) rather than nondeterminism
        logger.warning('fault state_dir unusable (%s); skipping one-shot fault', e)
        return False
    os.close(fd)
    return True


def on_item(kwargs):
    """Item-level fault hook, called by every pool's worker loop with the
    ventilated kwargs right before ``worker.process``. No-op without an
    installed plan."""
    plan = _PLAN
    if plan is None:
        return
    piece_index = kwargs.get('piece_index')
    if piece_index is None:
        return
    if piece_index in plan.kill_items:
        fire = (not plan.kill_once or
                _claim_one_shot(plan.state_dir, 'kill_{}'.format(piece_index)))
        if fire:
            if _IN_SPAWNED_WORKER:
                logger.warning('fault injection: SIGKILL on piece_index=%s (pid %s)',
                               piece_index, os.getpid())
                os.kill(os.getpid(), signal.SIGKILL)
            raise FaultInjectedError(
                'injected kill on piece_index={} (degraded to an error: not a '
                'spawned worker process)'.format(piece_index))
    if piece_index in plan.segv_items:
        fire = (not plan.segv_once or
                _claim_one_shot(plan.state_dir, 'segv_{}'.format(piece_index)))
        if fire:
            if _IN_SPAWNED_WORKER:
                logger.warning('fault injection: SIGSEGV on piece_index=%s (pid %s)',
                               piece_index, os.getpid())
                # a real signal, not a Python exception: faulthandler (armed
                # by the flight recorder) writes the crash sidecar as it
                # would for a native decoder bug
                os.kill(os.getpid(), signal.SIGSEGV)
            raise FaultInjectedError(
                'injected segfault on piece_index={} (degraded to an error: not '
                'a spawned worker process)'.format(piece_index))
    if piece_index in plan.hang_items:
        fire = (not plan.hang_once or
                _claim_one_shot(plan.state_dir, 'hang_{}'.format(piece_index)))
        if fire:
            from petastorm_tpu_torch import observability as obs
            logger.warning('fault injection: hanging %.1fs on piece_index=%s (pid %s)',
                           plan.hang_s, piece_index, os.getpid())
            # wedge inside a named stage so the watchdog's activity slot
            # shows fault.fault_hang in the stack dump it takes
            with obs.stage('fault_hang', cat='fault'):
                time.sleep(plan.hang_s)
    if piece_index in plan.error_items:
        if plan.error_times is None:
            raise FaultInjectedError('injected poison on piece_index={}'.format(piece_index))
        for shot in range(plan.error_times):
            if _claim_one_shot(plan.state_dir, 'err_{}_{}'.format(piece_index, shot)):
                raise FaultInjectedError(
                    'injected transient error {}/{} on piece_index={}'.format(
                        shot + 1, plan.error_times, piece_index))


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
# network faults for the chunk-transfer fabric (docs/fabric.md)
# ---------------------------------------------------------------------------

class NetFaultPlan(object):
    """Seeded network faults for the peer-to-peer chunk fabric.

    Each budget arms the first N occurrences of its hook point (connect
    attempts for ``refuse_connects``, payload sends for the rest), so a chaos
    run replays the same failure schedule. With a ``state_dir`` the shots
    coordinate across processes through the sentinel files of the item
    faults; without one they count per process.

    :param refuse_connects: first N fabric connect attempts raise
        ``ConnectionRefusedError`` (the peer's port is gone).
    :param reset_payloads: first N payload sends abort mid-transfer with a
        TCP reset after half the body: the receiver sees a torn frame.
    :param truncate_payloads: first N payload sends deliver half the body and
        close cleanly: a truncation the content hash must catch.
    :param corrupt_payloads: first N payload sends flip bytes in the body:
        length-preserving corruption only the hash can catch.
    :param stall_payloads: first N payload sends sleep ``stall_s`` before the
        body: the slow peer the client's deadline must bound.
    :param stall_s: how long each ``stall_payloads`` shot sleeps.
    :param state_dir: directory for cross-process one-shot coordination.
    """

    def __init__(self, refuse_connects=0, reset_payloads=0, truncate_payloads=0,
                 corrupt_payloads=0, stall_payloads=0, stall_s=5.0, state_dir=None):
        self.refuse_connects = int(refuse_connects)
        self.reset_payloads = int(reset_payloads)
        self.truncate_payloads = int(truncate_payloads)
        self.corrupt_payloads = int(corrupt_payloads)
        self.stall_payloads = int(stall_payloads)
        self.stall_s = float(stall_s)
        self.state_dir = state_dir
        self._fired = {}

    def __repr__(self):
        return ('NetFaultPlan(refuse_connects={}, reset_payloads={}, '
                'truncate_payloads={}, corrupt_payloads={}, stall_payloads={}, '
                'stall_s={})'.format(self.refuse_connects, self.reset_payloads,
                                     self.truncate_payloads, self.corrupt_payloads,
                                     self.stall_payloads, self.stall_s))


_NET_PLAN = None
_net_lock = threading.Lock()


def install_net(plan):
    """Install a :class:`NetFaultPlan` process-wide (``None`` disarms)."""
    global _NET_PLAN
    _NET_PLAN = plan
    return plan


def uninstall_net():
    install_net(None)


def get_net_plan():
    return _NET_PLAN


def _claim_counted(plan, kind, budget):
    """True for the first ``budget`` calls with this ``kind``: across
    processes when the plan has a ``state_dir``, per process otherwise (the
    server's handler threads claim under a lock)."""
    if budget <= 0:
        return False
    if plan.state_dir:
        return any(_claim_one_shot(plan.state_dir, 'net_{}_{}'.format(kind, shot))
                   for shot in range(budget))
    with _net_lock:
        fired = plan._fired.get(kind, 0)
        if fired >= budget:
            return False
        plan._fired[kind] = fired + 1
        return True


def on_net_connect():
    """Connect-time hook: the fabric client calls it right before
    ``socket.connect``. No-op without an installed net plan."""
    plan = _NET_PLAN
    if plan is None:
        return
    if _claim_counted(plan, 'refuse', plan.refuse_connects):
        raise ConnectionRefusedError('injected connection refusal (fabric net fault)')


def net_payload_action():
    """Payload-send hook: the fabric server asks it once per payload and
    honours the answer, ``('reset'|'truncate'|'corrupt'|'stall',
    stall_s_or_None)`` or None. At most one action fires per call; a stall
    wins over the destructive actions, so a stalled transfer can be the one
    a chaos driver SIGKILLs mid-flight."""
    plan = _NET_PLAN
    if plan is None:
        return None
    if _claim_counted(plan, 'stall', plan.stall_payloads):
        return ('stall', plan.stall_s)
    for kind, budget in (('reset', plan.reset_payloads),
                         ('truncate', plan.truncate_payloads),
                         ('corrupt', plan.corrupt_payloads)):
        if _claim_counted(plan, kind, budget):
            return (kind, None)
    return None


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


__all__ = ['FaultInjectedError', 'FaultPlan', 'HostChurnPlan', 'NetFaultPlan',
           'count_committed', 'drive_host_churn', 'get_net_plan', 'get_plan', 'install',
           'install_net', 'mark_in_spawned_worker', 'net_payload_action', 'on_item',
           'on_net_connect', 'storage_faults_fired', 'uninstall', 'uninstall_net']
