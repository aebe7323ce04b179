"""Shared-filesystem membership registry with heartbeat leases.

Twin of ``petastorm_tpu/elastic/membership.py``, with the same lease file
names and JSON fields, so hosts of both packages see each other's leases in
one coordination directory.

Each pod host owns one lease file under ``<coord_dir>/members/`` (JSON:
host id, pid, machine, lease duration, renewal timestamp) that a background
heartbeat thread renews atomically (tmp + ``os.rename``). Liveness:

* a **fresh lease** (renewed within ``lease_s``) is alive, unless its
  holder's pid is provably *dead* on this machine (``os.kill(pid, 0)``
  raising, or a zombie in ``/proc``), which marks the host dead at once;
* an **expired lease** is dead. Pid liveness only ever SHORTENS a lease,
  never extends it: a host stalled past ``lease_s`` counts as departed, even
  when its pid still runs (the false-expiry window of
  ``docs/parallelism.md``);
* a **missing lease** means the host left (``leave()`` unlinks it) or never
  joined.

All lease I/O goes through :class:`~petastorm_tpu_torch.retry.RetryPolicy`
(transient-error classification, bounded backoff, the ``FAULT_POINT`` hook),
so a slow or flaky NFS or GCS stat retries instead of looking like a death.
A lease file that exists but cannot be read past the retry budget is
presumed ALIVE: an unreadable lease must never look like a departure.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time

from petastorm_tpu_torch.retry import RetryPolicy, is_transient_io_error


def _machine_id():
    """A stable identity for this machine, for same-host pid shortcuts."""
    try:
        return os.uname().nodename
    except (AttributeError, OSError):
        return 'unknown'


def _pid_alive(pid):
    """Best-effort pid liveness (signal-0 probe + /proc zombie check).

    Mirrors the serve client's handshake: unknown/unsure answers lean
    ALIVE so a permission error never reaps a live host.
    """
    if not pid or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    try:
        with open('/proc/{}/stat'.format(pid), 'r') as f:
            return f.read().rsplit(')', 1)[-1].split()[0] != 'Z'
    except (OSError, IndexError):
        return True


#: retry budget for lease reads/writes — short backoffs: the heartbeat
#: period bounds how long a renewal may take end to end
DEFAULT_LEASE_RETRY = RetryPolicy(max_attempts=4, initial_backoff_s=0.02,
                                  multiplier=2.0, max_backoff_s=0.25,
                                  jitter=0.25, classify=is_transient_io_error)


class MemberInfo(object):
    """One member's decoded lease, plus the liveness verdict. ``notes`` is
    the holder's annotation dict (e.g. its fabric endpoint) — empty when the
    lease predates annotations or could not be read."""

    __slots__ = ('host', 'pid', 'lease_s', 'renewed', 'alive', 'expired',
                 'notes')

    def __init__(self, host, pid, lease_s, renewed, alive, expired, notes=None):
        self.host = host
        self.pid = pid
        self.lease_s = lease_s
        self.renewed = renewed
        self.alive = alive
        self.expired = expired
        self.notes = notes if notes is not None else {}

    def to_dict(self):
        return {'host': self.host, 'pid': self.pid, 'lease_s': self.lease_s,
                'renewed': self.renewed, 'alive': self.alive,
                'expired': self.expired, 'notes': self.notes}


class MembershipRegistry(object):
    """Lease-file membership for one host in one coordination directory.

    :param coord_dir: shared directory all pod hosts can reach
    :param host_id: this host's stable identity (e.g. ``host0``, or the
        value :func:`~petastorm_tpu_torch.elastic.default_host_id` derives)
    :param lease_s: lease duration; a lease not renewed for this long
        marks its holder dead
    :param retry: :class:`RetryPolicy` for lease I/O (default bounded
        short-backoff policy); tests inject flaky-fs faults through the
        policy's ``FAULT_POINT`` hook
    :param annotations: optional JSON-serializable dict carried inside every
        lease renewal (surfaced to peers as :attr:`MemberInfo.notes`) — how a
        host publishes per-host metadata such as its chunk-fabric endpoint
        WITHOUT a second discovery protocol: the annotation lives and dies
        with the lease itself
    """

    def __init__(self, coord_dir, host_id, lease_s=5.0, retry=None,
                 annotations=None):
        if lease_s <= 0:
            raise ValueError('lease_s must be positive, got {!r}'.format(lease_s))
        self.coord_dir = coord_dir
        self.host_id = str(host_id)
        self.lease_s = float(lease_s)
        self.annotations = dict(annotations) if annotations else {}
        self._retry = retry if retry is not None else DEFAULT_LEASE_RETRY
        self._members_dir = os.path.join(coord_dir, 'members')
        self._lease_path = os.path.join(self._members_dir,
                                        self.host_id + '.lease')
        self._heartbeat = None
        self._stop = threading.Event()
        self._joined = False

    # -- lifecycle ---------------------------------------------------------

    def join(self):
        """Write this host's lease and start the heartbeat renewal thread."""
        if self._joined:
            return
        self._retry.call(os.makedirs, self._members_dir, exist_ok=True)
        self._renew()
        self._stop.clear()
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop,
            name='pstpu-elastic-heartbeat-{}'.format(self.host_id),
            daemon=True)
        self._heartbeat.start()
        self._joined = True

    def leave(self):
        """Stop heartbeating and remove the lease (a graceful departure)."""
        self._stop.set()
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=self.lease_s)
            self._heartbeat = None
        if self._joined:
            try:
                self._retry.call(os.unlink, self._lease_path)
            except OSError:
                pass
            self._joined = False

    def __enter__(self):
        self.join()
        return self

    def __exit__(self, *exc):
        self.leave()
        return False

    # -- lease renewal -----------------------------------------------------

    def _renew(self):
        record = {'host': self.host_id, 'pid': os.getpid(),
                  'machine': _machine_id(),
                  'lease_s': self.lease_s,
                  'renewed': time.time()}
        if self.annotations:
            record['notes'] = self.annotations
        payload = json.dumps(record)
        tmp = self._lease_path + '.tmp.{}'.format(os.getpid())

        def write_and_swap():
            with open(tmp, 'w') as f:
                f.write(payload)
            os.rename(tmp, self._lease_path)

        self._retry.call(write_and_swap)

    def _heartbeat_loop(self):
        period = max(self.lease_s / 3.0, 0.02)
        while not self._stop.wait(period):
            try:
                self._renew()
            except OSError:
                # Past the retry budget: keep trying next period. The lease
                # may expire meanwhile, which peers will treat as a death —
                # the conservative outcome for a host that cannot reach the
                # shared filesystem at all.
                continue

    # -- membership reads --------------------------------------------------

    def _read_lease(self, path):
        with open(path, 'r') as f:
            return json.loads(f.read())

    def scan(self, now=None):
        """Decode every lease file into a list of :class:`MemberInfo`.

        Liveness per lease: fresh + same-machine pid provably dead =>
        dead now (the crash shortcut); fresh otherwise => alive; stale =>
        dead (expired) regardless of pid liveness. A
        lease that cannot be read past the retry budget is reported alive
        and unexpired — I/O trouble must never masquerade as a departure.
        """
        now = time.time() if now is None else now
        try:
            names = self._retry.call(os.listdir, self._members_dir)
        except OSError as e:
            if getattr(e, 'errno', None) == errno.ENOENT:
                return []
            raise
        infos = []
        for name in sorted(names):
            if not name.endswith('.lease'):
                continue
            host = name[:-len('.lease')]
            path = os.path.join(self._members_dir, name)
            try:
                data = self._retry.call(self._read_lease, path)
            except (OSError, ValueError):
                if not os.path.exists(path):
                    continue    # unlinked mid-scan: a graceful leave
                infos.append(MemberInfo(host, None, None, None,
                                        alive=True, expired=False))
                continue
            pid = data.get('pid')
            lease_s = float(data.get('lease_s') or self.lease_s)
            renewed = float(data.get('renewed') or 0.0)
            notes = data.get('notes')
            if not isinstance(notes, dict):
                notes = {}
            fresh = (now - renewed) <= lease_s
            if fresh and pid is not None and os.getpid() != pid \
                    and data.get('machine') == _machine_id() \
                    and not _pid_alive(pid):
                # Same-machine shortcut: the holder is visibly dead (e.g.
                # SIGKILLed); no need to wait out the remaining lease time.
                fresh = False
            infos.append(MemberInfo(host, pid, lease_s, renewed,
                                    alive=fresh, expired=not fresh,
                                    notes=notes))
        return infos

    def alive_members(self, now=None):
        """Sorted tuple of host ids whose leases are currently live."""
        return tuple(sorted(m.host for m in self.scan(now=now) if m.alive))

    def expired_members(self, now=None):
        """Sorted tuple of host ids whose leases exist but have expired."""
        return tuple(sorted(m.host for m in self.scan(now=now) if m.expired))


__all__ = ['DEFAULT_LEASE_RETRY', 'MemberInfo', 'MembershipRegistry',
           '_pid_alive']
