"""Crash-persistent flight recorder + hang watchdog + post-mortem analyzer.

Twin of ``petastorm_tpu/observability/blackbox.py`` with the same on-disk
format (magic, version, header offsets, record framing) and the same
``PSTPU_FLIGHT*`` variables, so either package's :func:`load_flight` and
:func:`postmortem_report` read the other's files. The telemetry stack (metrics, spans, stall attribution) is in-memory and
observable only from a *live* process: when a worker SIGSEGVs in a native
kernel or a process is OOM-killed or wedges, every
counter and span ring dies with it. This module is the black box that
survives:

* **Flight file** — a per-process, mmap-backed, fixed-size ring of
  sequence-stamped binary records (periodic counter/gauge snapshots,
  protocol/supervision events, watchdog stack dumps, the last stall
  report). mmap stores land in the kernel page cache, so the recorded
  bytes survive SIGKILL/SIGSEGV *by construction* — no flush path needs
  to run on the way down. The reader is torn-record-tolerant: each record
  carries its sequence number in both header and trailer, and the ring's
  ``oldest``/``write`` offsets are advanced so the readable window only
  ever covers whole records.
* **Crash-cause footer** — ``faulthandler`` is armed on a per-process
  ``.crash`` sidecar file (C-level all-thread stacks on
  SIGSEGV/SIGABRT/SIGBUS/SIGFPE/SIGILL, signals no Python handler can
  survive), Python marker handlers stamp catchable signals (SIGTERM)
  straight into the flight header via a preallocated ``pack_into`` (the
  handler allocates nothing, takes no lock and logs nothing), and an
  ``atexit`` hook writes a clean-shutdown marker — so "crashed" vs
  "exited" vs "killed" is decidable from the file alone.
* **Hang watchdog** — the recorder's background thread doubles as a
  watchdog: when the process's current pipeline stage (the activity slot
  the stage timers maintain) has been open past a stall threshold with no
  progress on any registered progress source, it dumps all-thread Python
  stacks and registered-lock state into the flight file and counts
  ``watchdog_stall_total``.
* **Post-mortem** — :func:`postmortem_report` merges the flight files of
  every process in a run directory (dead or alive) and reconstructs the
  last N seconds: per-process status + crash signal, the stage each
  process died in, a windowed stall report, recent supervision events,
  and a named probable cause. CLI: ``python -m
  petastorm_tpu_torch.observability.blackbox DIR``.

Recording is on by default whenever telemetry is at ``counters`` level
(``PSTPU_FLIGHT=0`` disables; ``PSTPU_FLIGHT_DIR`` relocates the run
directory) and structurally free when off: every hook is one module
attribute load + ``None`` compare.

In a CUDA process: the recorder touches no CUDA state. Its thread reads the
metrics registry and writes the mmap; the activity slot the stage timers
write is a ``pack_into`` on the mmap, so the infeed thread's stages during a
CUDA graph capture (``thread_local`` capture mode) add no CUDA call;
``faulthandler`` and the SIGTERM marker are armed only where their
disposition is still the default, and the ``atexit`` close unmaps a file,
which is safe with a live CUDA context. Spawned process-pool workers enable
their own recorder in the consumer's run directory. The stale-file sweep
removes only files whose owner pid is gone and whose mtime is over six
hours old, so the two packages may share a run directory: neither removes
the other's live files.
"""

from __future__ import annotations

import atexit
import errno
import faulthandler
import json
import mmap
import os
import re
import signal
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback

from petastorm_tpu_torch.observability import metrics as _metrics

# ---------------------------------------------------------------------------
# on-disk format
# ---------------------------------------------------------------------------

MAGIC = b'PSTPUFLT'
VERSION = 1

#: header page size; the ring region starts here
HEADER_SIZE = 4096

#: default ring capacity (bytes of record data, excluding the header page)
DEFAULT_CAPACITY = 256 * 1024

#: record kinds
K_SNAPSHOT = 1   #: periodic flattened counter/gauge snapshot
K_EVENT = 2      #: protocol / supervision event
K_SPAN = 3       #: recent span events (spans level only)
K_STALL = 4      #: a stall report (recorded by the loader on close)
K_WATCHDOG = 5   #: watchdog stack + lock-state dump
K_MARK = 6       #: lifecycle mark (enabled, closing, ...)

KIND_NAMES = {K_SNAPSHOT: 'snapshot', K_EVENT: 'event', K_SPAN: 'span',
              K_STALL: 'stall', K_WATCHDOG: 'watchdog', K_MARK: 'mark'}

# fixed header prefix: magic, version, pid, capacity, start_ts, then the
# mutable fields patched in place at their own offsets below
_HDR = struct.Struct('<8sIIQd')          # 0..32
_OFF_WRITE = 32                          # u64 monotonic write offset
_OFF_SEQ = 40                            # u64 next record sequence
_OFF_OLDEST = 48                         # u64 oldest intact record offset
_OFF_CLEAN = 56                          # u32 clean-shutdown marker
_OFF_CRASH = 60                          # i32 signal + f64 ts (see _FOOTER)
_OFF_LABEL = 72                          # 32s component label
_OFF_HOSTNAME = 104                      # 64s hostname
_OFF_ACTIVITY = 168                      # f64 ts + 128s current stage name

_U64 = struct.Struct('<Q')
_U32 = struct.Struct('<I')
#: crash footer — preallocated so the signal-marker path never allocates a
#: Struct (async-signal safety)
_FOOTER = struct.Struct('<id')
_ACT = struct.Struct('<d128s')

#: per-record framing: u32 payload len, u64 seq, u8 kind, f64 wall ts ...
#: payload ... u64 seq trailer. A record is valid iff both seqs agree.
_REC = struct.Struct('<IQBd')
_REC_TRAILER = struct.Struct('<Q')
_REC_OVERHEAD = _REC.size + _REC_TRAILER.size  # 29 bytes

_LABEL_SANITIZE = re.compile(r'[^A-Za-z0-9_.-]+')

#: flight files older than this whose owner pid is gone are swept at enable
_STALE_SWEEP_AGE_S = 6 * 3600.0


class FlightFileError(Exception):
    """A flight file is missing, truncated, or not a flight file."""


def default_dir():
    """The default run directory (``PSTPU_FLIGHT_DIR`` overrides)."""
    return os.environ.get('PSTPU_FLIGHT_DIR') or os.path.join(
        tempfile.gettempdir(), 'pstpu_flight')


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM
    return True


def _sweep_stale(run_dir):
    """Unlink flight files (and sidecars) whose owner pid is gone and whose
    mtime is old — the default dir is shared across runs and tmpfs never
    reclaims it on its own."""
    now = time.time()
    try:
        entries = os.listdir(run_dir)
    except OSError:
        return
    for name in entries:
        if not (name.startswith('flight-') and
                (name.endswith('.bin') or name.endswith('.crash'))):
            continue
        path = os.path.join(run_dir, name)
        try:
            if now - os.path.getmtime(path) < _STALE_SWEEP_AGE_S:
                continue
            pid_part = name.rsplit('-', 2)[-2] if name.endswith('.bin') \
                else name.rsplit('-', 2)[-2]
            pid = int(pid_part)
            if not _pid_alive(pid):
                os.unlink(path)
        except (OSError, ValueError, IndexError):
            continue


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

class FlightRecorder(object):
    """Per-process mmap-backed flight recorder.

    One instance per process (module-level singleton via :func:`enable`);
    :meth:`record` is thread-safe. The background thread started by
    :meth:`start` is both the snapshot pump (one flattened metrics snapshot
    per ``snapshot_interval_s``) and the hang watchdog.
    """

    def __init__(self, path, capacity=DEFAULT_CAPACITY, label='',
                 snapshot_interval_s=1.0, stall_threshold_s=30.0):
        if capacity < 4096:
            raise ValueError('capacity must be >= 4096 bytes')
        self.path = path
        self.capacity = int(capacity)
        self.label = label
        self.snapshot_interval_s = float(snapshot_interval_s)
        self.stall_threshold_s = float(stall_threshold_s)
        self._lock = threading.Lock()
        self._closed = False
        self._dropped = 0
        # logical (monotonic) byte offsets into the ring; position on disk is
        # HEADER_SIZE + off % capacity
        self._write_off = 0
        self._seq = 0
        self._oldest_off = 0
        self._live = []  # [(start_off, size)] of records inside the window
        # activity slot mirror (the mmap holds the crash-persistent copy)
        self._activity = ''
        self._activity_ts = 0.0
        # watchdog state
        self._watches = {}
        self._watch_sig = None
        self._last_progress_t = time.monotonic()
        self._stall_dumped = False
        self._locks = {}
        # spans-level piggyback: wall ts (us) of the last span already copied
        self._last_span_ts = 0.0
        self._stop_event = threading.Event()
        self._thread = None
        self._crash_file = None  # faulthandler sidecar, kept open for life

        fd = os.open(path, os.O_CREAT | os.O_TRUNC | os.O_RDWR, 0o644)
        try:
            os.ftruncate(fd, HEADER_SIZE + self.capacity)
            self._mm = mmap.mmap(fd, HEADER_SIZE + self.capacity)
        finally:
            os.close(fd)
        _HDR.pack_into(self._mm, 0, MAGIC, VERSION, os.getpid(),
                       self.capacity, time.time())
        label_b = _LABEL_SANITIZE.sub('_', label).encode()[:31]
        self._mm[_OFF_LABEL:_OFF_LABEL + 32] = label_b.ljust(32, b'\x00')
        host_b = socket.gethostname().encode()[:63]
        self._mm[_OFF_HOSTNAME:_OFF_HOSTNAME + 64] = host_b.ljust(64, b'\x00')

    # -- ring writes ---------------------------------------------------------

    def _put(self, off, data):
        """Copy ``data`` into the ring at logical offset ``off`` (wrapping)."""
        i = off % self.capacity
        end = i + len(data)
        if end <= self.capacity:
            self._mm[HEADER_SIZE + i:HEADER_SIZE + end] = data
        else:
            first = self.capacity - i
            self._mm[HEADER_SIZE + i:HEADER_SIZE + self.capacity] = data[:first]
            self._mm[HEADER_SIZE:HEADER_SIZE + len(data) - first] = data[first:]

    def record(self, kind, payload):
        """Append one record (``payload`` is a JSON-serializable dict).
        Oversized payloads are dropped (counted in ``dropped``); a closed
        recorder is a no-op."""
        data = json.dumps(payload, separators=(',', ':'),
                          default=repr).encode('utf-8', 'replace')
        need = _REC_OVERHEAD + len(data)
        with self._lock:
            if self._closed:
                return False
            if need > self.capacity:
                self._dropped += 1
                return False
            start = self._write_off
            new_off = start + need
            # evict whole records the new write will overwrite, and advance
            # the oldest pointer BEFORE the bytes land: a crash mid-write then
            # leaves the readable [oldest, write) window fully intact
            floor = new_off - self.capacity
            while self._live and self._live[0][0] < floor:
                self._live.pop(0)
            self._oldest_off = self._live[0][0] if self._live else start
            _U64.pack_into(self._mm, _OFF_OLDEST, self._oldest_off)
            seq = self._seq
            buf = (_REC.pack(len(data), seq, kind, time.time()) + data +
                   _REC_TRAILER.pack(seq))
            self._put(start, buf)
            self._live.append((start, need))
            self._seq = seq + 1
            self._write_off = new_off
            _U64.pack_into(self._mm, _OFF_SEQ, self._seq)
            # write offset last: it is the reader's valid-end marker
            _U64.pack_into(self._mm, _OFF_WRITE, new_off)
        return True

    @property
    def dropped(self):
        return self._dropped

    # -- activity slot (the "dying stage" field) -----------------------------

    def set_activity(self, name):
        """Overwrite the fixed-size current-activity slot in place. Called on
        every stage enter/exit — a single ``pack_into`` under the GIL, no
        record traffic."""
        self._activity = name
        self._activity_ts = time.time()
        self._stall_dumped = False
        try:
            # deliberately lock-free: a fixed-offset pack_into is atomic
            # enough for a forensic field, and the stage-timer hot path must
            # not contend with record()
            _ACT.pack_into(self._mm, _OFF_ACTIVITY, self._activity_ts,  # noqa: PT1301 - fixed-slot overwrite; hot path stays lock-free
                           name.encode()[:128])
        except (ValueError, TypeError):
            pass

    # -- crash footer (async-signal-safe) ------------------------------------

    def stamp_crash(self, signum):
        """Stamp the crash-cause footer. May run inside a signal handler:
        only preallocated ``pack_into`` stores into the existing mmap — no
        allocation, locks, logging, or imports on this path."""
        try:
            _FOOTER.pack_into(self._mm, _OFF_CRASH, signum, time.time())  # noqa: PT1301 - must be lock-free: runs inside a signal handler (PT704)
        except (ValueError, TypeError):
            pass

    def mark_clean_shutdown(self):
        try:
            _U32.pack_into(self._mm, _OFF_CLEAN, 1)  # noqa: PT1301 - fixed-slot flag; callers hold the close() lock or are single-threaded at exit
        except (ValueError, TypeError):
            pass

    # -- watchdog / snapshot pump --------------------------------------------

    def watch(self, name, fn):
        """Register a progress source (zero-arg callable returning a number or
        any comparable). A change in any source resets the stall timer."""
        with self._lock:
            self._watches[name] = fn

    def unwatch(self, name):
        with self._lock:
            self._watches.pop(name, None)

    def register_lock(self, name, lock):
        """Register a lock whose held-state the watchdog dump reports."""
        with self._lock:
            self._locks[name] = lock

    def unregister_lock(self, name):
        with self._lock:
            self._locks.pop(name, None)

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pstpu-blackbox')
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop_event.wait(self.snapshot_interval_s):
            try:
                self._pump_once()
            except Exception:  # noqa: BLE001 - the black box must never take the process down
                pass

    def _pump_once(self, now=None):
        """One pump tick: metrics snapshot, span piggyback, watchdog check.
        Split out (and ``now``-injectable) for tests."""
        now = time.monotonic() if now is None else now
        if _metrics.counters_on():
            flat = _metrics.flatten_snapshot(_metrics.get_registry().snapshot())
            self.record(K_SNAPSHOT, {'metrics': flat})
            if _metrics.spans_on():
                self._pump_spans()
        self._check_stall(now)

    def _pump_spans(self):
        """Copy trace-ring events newer than the last tick into the flight
        file (bounded tail) so a post-mortem can show a partial span tree."""
        from petastorm_tpu_torch.observability import trace as _trace
        events = _trace.get_ring().snapshot()
        fresh = [e for e in events
                 if isinstance(e, dict) and e.get('ts', 0) > self._last_span_ts]
        if not fresh:
            return
        fresh = fresh[-50:]
        self._last_span_ts = max(e.get('ts', 0) for e in fresh)
        self.record(K_SPAN, {'events': fresh})

    def _progress_signature(self):
        with self._lock:
            watches = list(self._watches.items())
        sig = []
        for name, fn in watches:
            try:
                sig.append((name, fn()))
            except Exception:  # noqa: BLE001 - a torn-down source must not kill the watchdog
                sig.append((name, None))
        return tuple(sig)

    def _check_stall(self, now):
        sig = self._progress_signature()
        if sig != self._watch_sig:
            self._watch_sig = sig
            self._last_progress_t = now
            self._stall_dumped = False
        if not self._activity or self._stall_dumped:
            return
        stage_age = time.time() - self._activity_ts
        if (stage_age < self.stall_threshold_s or
                now - self._last_progress_t < self.stall_threshold_s):
            return
        self._stall_dumped = True
        self.record(K_WATCHDOG, self._stall_dump(stage_age))
        if _metrics.counters_on():
            reg = _metrics.get_registry()
            reg.counter('watchdog_stall_total').inc()
            reg.gauge('watchdog_last_dump_ts').set(round(time.time(), 3))

    def _stall_dump(self, stage_age):
        """All-thread Python stacks + registered-lock state + the wedged
        activity — the payload of a K_WATCHDOG record."""
        names = {t.ident: t.name for t in threading.enumerate()}
        threads = {}
        for ident, frame in sys._current_frames().items():
            key = '{} ({})'.format(names.get(ident, '?'), ident)
            threads[key] = ''.join(traceback.format_stack(frame))[-4000:]
        with self._lock:
            locks = {name: bool(lock.locked())
                     for name, lock in self._locks.items()
                     if hasattr(lock, 'locked')}
        return {'activity': self._activity,
                'age_s': round(stage_age, 3),
                'threads': threads,
                'locks': locks,
                'watch': dict(self._watch_sig or ())}

    # -- shutdown ------------------------------------------------------------

    def close(self, clean=True):
        """Stop the pump, write a final snapshot, stamp the clean-shutdown
        marker, and unmap. Idempotent."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if _metrics.counters_on():
            try:
                flat = _metrics.flatten_snapshot(_metrics.get_registry().snapshot())
                self.record(K_SNAPSHOT, {'metrics': flat})
            except Exception:  # noqa: BLE001 - best-effort final snapshot
                pass
        self.record(K_MARK, {'event': 'closing'})
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if clean:
                self.mark_clean_shutdown()
            try:
                self._mm.flush()
            except (OSError, ValueError):
                pass
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass


class _ActivitySlot(object):
    """The hook :class:`petastorm_tpu_torch.observability._StageTimer` drives: one
    ``enter``/``exit`` pair per stage execution, maintaining the recorder's
    crash-persistent current-activity field."""

    __slots__ = ('_recorder', '_current')

    def __init__(self, recorder):
        self._recorder = recorder
        self._current = ''

    def enter(self, name):
        prev = self._current
        self._current = name
        self._recorder.set_activity(name)
        return prev

    def exit(self, prev):
        self._current = prev
        self._recorder.set_activity(prev)


# ---------------------------------------------------------------------------
# the process-wide singleton + hooks
# ---------------------------------------------------------------------------

#: the enabled recorder (None = off: every hook is one load + None compare)
_RECORDER = None
#: the stage-timer hook (non-None only while enabled)
_ACTIVITY = None
_ENABLE_COUNT = 0
#: serializes enable(): readers started on two threads at once would each
#: create a recorder, and the one not kept would run its thread forever
_ENABLE_LOCK = threading.Lock()


def get_recorder():
    return _RECORDER


def enable(label='', run_dir=None, capacity=None, snapshot_interval_s=None,
           stall_threshold_s=None):
    """Create and arm this process's flight recorder (idempotent — returns
    the existing one when already enabled): mmap the flight file, start the
    snapshot/watchdog thread, arm faulthandler on the ``.crash`` sidecar,
    install signal markers and the atexit clean-shutdown hook."""
    with _ENABLE_LOCK:
        if _RECORDER is not None:
            return _RECORDER
        return _enable(label, run_dir, capacity, snapshot_interval_s, stall_threshold_s)


def _enable(label, run_dir, capacity, snapshot_interval_s, stall_threshold_s):
    """:func:`enable`'s work, under its lock."""
    global _RECORDER, _ACTIVITY, _ENABLE_COUNT
    run_dir = run_dir or default_dir()
    try:
        os.makedirs(run_dir, exist_ok=True)
    except OSError:
        return None
    _sweep_stale(run_dir)
    _ENABLE_COUNT += 1
    name = 'flight-{}-{}-{}.bin'.format(
        _LABEL_SANITIZE.sub('_', label or 'proc'), os.getpid(), _ENABLE_COUNT)
    path = os.path.join(run_dir, name)
    if capacity is None:
        capacity = int(os.environ.get('PSTPU_FLIGHT_CAPACITY', DEFAULT_CAPACITY))
    if snapshot_interval_s is None:
        snapshot_interval_s = float(os.environ.get('PSTPU_FLIGHT_INTERVAL', 1.0))
    if stall_threshold_s is None:
        stall_threshold_s = float(os.environ.get('PSTPU_FLIGHT_STALL_S', 30.0))
    try:
        rec = FlightRecorder(path, capacity=capacity, label=label,
                             snapshot_interval_s=snapshot_interval_s,
                             stall_threshold_s=stall_threshold_s)
    except OSError:
        return None
    _install_crash_capture(rec)
    atexit.register(_atexit_close)
    rec.record(K_MARK, {'event': 'enabled', 'label': label, 'pid': os.getpid(),
                        'argv': sys.argv[:3]})
    rec.start()
    _RECORDER = rec
    _ACTIVITY = _ActivitySlot(rec)
    return rec


def maybe_enable(label='', run_dir=None):
    """The wiring entry point pools/loaders/daemons call: enable recording
    unless ``PSTPU_FLIGHT=0`` or telemetry is off. Idempotent and cheap when
    already enabled (one global load)."""
    if _RECORDER is not None:
        return _RECORDER
    if os.environ.get('PSTPU_FLIGHT', '') == '0':
        return None
    if not _metrics.counters_on():
        return None
    return enable(label=label, run_dir=run_dir)


def disable():
    """Close the recorder and remove every hook (tests; long-lived hosts that
    want recording off after a phase)."""
    global _RECORDER, _ACTIVITY
    rec = _RECORDER
    _ACTIVITY = None
    _RECORDER = None
    if rec is not None:
        rec.close(clean=True)
        try:
            atexit.unregister(_atexit_close)
        except Exception:  # noqa: BLE001 - interpreter-shutdown race
            pass


def _atexit_close():
    rec = _RECORDER
    if rec is not None:
        rec.close(clean=True)


def record_event(payload):
    """Record a protocol/supervision event (no-op when disabled)."""
    rec = _RECORDER
    if rec is not None:
        rec.record(K_EVENT, payload)


def record_stall(report):
    """Record a stall report dict (the loader's closing report)."""
    rec = _RECORDER
    if rec is not None:
        rec.record(K_STALL, report)


def record_mark(payload):
    rec = _RECORDER
    if rec is not None:
        rec.record(K_MARK, payload)


def watch_progress(name, fn):
    """Register a watchdog progress source on the enabled recorder (no-op
    when disabled)."""
    rec = _RECORDER
    if rec is not None:
        rec.watch(name, fn)


def unwatch_progress(name):
    rec = _RECORDER
    if rec is not None:
        rec.unwatch(name)


def register_lock(name, lock):
    rec = _RECORDER
    if rec is not None:
        rec.register_lock(name, lock)


def unregister_lock(name):
    rec = _RECORDER
    if rec is not None:
        rec.unregister_lock(name)


#: signals a Python marker handler can observe on the way down. SIGSEGV-class
#: signals are faulthandler's job (no Python handler can run); SIGKILL is
#: unobservable and inferred post-mortem (no marker + no footer + dead pid).
_MARKER_SIGNALS = ('SIGTERM',)


def _signal_marker(signum, frame):
    """Stamp the crash footer, restore the default disposition and re-raise —
    the process still dies with the original signal. Async-signal-safe by
    construction: no allocation, locks, logging, or imports."""
    rec = _RECORDER
    if rec is not None:
        rec.stamp_crash(signum)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _install_crash_capture(rec):
    """Arm faulthandler on the ``.crash`` sidecar and install Python marker
    handlers for catchable death signals whose disposition is still default
    (an application's own handler always wins)."""
    try:
        crash = open(rec.path + '.crash', 'w')
        faulthandler.enable(file=crash, all_threads=True)
        rec._crash_file = crash  # keep the fd alive for the process lifetime
    except (OSError, ValueError, RuntimeError):
        pass
    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal is main-thread-only
    for name in _MARKER_SIGNALS:
        signum = getattr(signal, name, None)
        if signum is None:
            continue
        try:
            if signal.getsignal(signum) is signal.SIG_DFL:
                signal.signal(signum, _signal_marker)
        except (OSError, ValueError, RuntimeError):
            continue


# ---------------------------------------------------------------------------
# the torn-tolerant reader
# ---------------------------------------------------------------------------

def load_flight(path):
    """Parse one flight file into a dict (header fields + the intact record
    list). Torn/overwritten tail records are counted in ``torn``, never
    raised. Raises :class:`FlightFileError` only for a non-flight file."""
    with open(path, 'rb') as f:
        blob = f.read()
    if len(blob) < HEADER_SIZE:
        raise FlightFileError('{}: truncated header'.format(path))
    magic, version, pid, capacity, start_ts = _HDR.unpack_from(blob, 0)
    if magic != MAGIC:
        raise FlightFileError('{}: not a flight file'.format(path))
    if len(blob) < HEADER_SIZE + capacity:
        raise FlightFileError('{}: truncated ring'.format(path))
    write_off = _U64.unpack_from(blob, _OFF_WRITE)[0]
    oldest_off = _U64.unpack_from(blob, _OFF_OLDEST)[0]
    clean = _U32.unpack_from(blob, _OFF_CLEAN)[0]
    crash_signal, crash_ts = _FOOTER.unpack_from(blob, _OFF_CRASH)
    label = blob[_OFF_LABEL:_OFF_LABEL + 32].split(b'\x00', 1)[0].decode('utf-8', 'replace')
    hostname = blob[_OFF_HOSTNAME:_OFF_HOSTNAME + 64].split(b'\x00', 1)[0].decode('utf-8', 'replace')
    act_ts, act_raw = _ACT.unpack_from(blob, _OFF_ACTIVITY)
    activity = act_raw.split(b'\x00', 1)[0].decode('utf-8', 'replace')

    def get(off, n):
        i = off % capacity
        end = i + n
        if end <= capacity:
            return blob[HEADER_SIZE + i:HEADER_SIZE + end]
        return (blob[HEADER_SIZE + i:HEADER_SIZE + capacity] +
                blob[HEADER_SIZE:HEADER_SIZE + end - capacity])

    records, torn = [], 0
    off, prev_seq = oldest_off, None
    while off < write_off:
        if write_off - off < _REC_OVERHEAD:
            torn += 1
            break
        length, seq, kind, ts = _REC.unpack(get(off, _REC.size))
        total = _REC_OVERHEAD + length
        if length > capacity - _REC_OVERHEAD or off + total > write_off:
            torn += 1
            break
        trailer = _REC_TRAILER.unpack(get(off + _REC.size + length,
                                          _REC_TRAILER.size))[0]
        if trailer != seq or (prev_seq is not None and seq != prev_seq + 1):
            torn += 1
            break
        try:
            data = json.loads(get(off + _REC.size, length).decode('utf-8', 'replace'))
        except ValueError:
            data = None
        records.append({'seq': seq, 'kind': kind,
                        'kind_name': KIND_NAMES.get(kind, str(kind)),
                        'ts': ts, 'data': data})
        prev_seq = seq
        off += total
    return {'path': path, 'version': version, 'pid': pid, 'label': label,
            'hostname': hostname, 'capacity': capacity,
            'start_ts': start_ts, 'write_off': write_off,
            'clean_shutdown': bool(clean),
            'crash_signal': crash_signal or None,
            'crash_ts': crash_ts or None,
            'activity': activity, 'activity_ts': act_ts or None,
            'records': records, 'torn': torn}


def _signal_name(signum):
    try:
        return signal.Signals(signum).name
    except (ValueError, TypeError):
        return 'signal {}'.format(signum)


#: faulthandler banner -> signal name (the sidecar is the only witness for
#: signals no Python handler survives)
_SIDECAR_SIGNALS = (('Segmentation fault', 'SIGSEGV'), ('Aborted', 'SIGABRT'),
                    ('Bus error', 'SIGBUS'), ('Floating', 'SIGFPE'),
                    ('Illegal instruction', 'SIGILL'))


def parse_crash_sidecar(path):
    """Parse a faulthandler ``.crash`` sidecar: the fatal-signal name and the
    dumped stack text (None when absent/empty — the process did not die on a
    faulthandler-covered signal)."""
    try:
        with open(path, 'r', errors='replace') as f:
            text = f.read()
    except OSError:
        return None
    if not text.strip():
        return None
    sig = None
    for needle, name in _SIDECAR_SIGNALS:
        if needle in text:
            sig = name
            break
    return {'signal': sig, 'text': text[-8000:]}


# ---------------------------------------------------------------------------
# the post-mortem analyzer
# ---------------------------------------------------------------------------

def _process_status(flight, sidecar):
    """('exited'|'crashed'|'killed'|'running', signal_name|None)."""
    if flight['crash_signal']:
        return 'crashed', _signal_name(flight['crash_signal'])
    if sidecar is not None and sidecar.get('signal'):
        return 'crashed', sidecar['signal']
    if flight['clean_shutdown']:
        return 'exited', None
    if _pid_alive(flight['pid']):
        return 'running', None
    # no shutdown marker, no footer, no sidecar, pid gone: uncatchable death
    return 'killed', 'SIGKILL'


def _snapshot_window(records, last_s):
    """Windowed stall report over the K_SNAPSHOT records: newest snapshot vs
    the oldest one within ``last_s`` of it. None with fewer than 2."""
    snaps = [r for r in records
             if r['kind'] == K_SNAPSHOT and isinstance(r.get('data'), dict)
             and isinstance(r['data'].get('metrics'), dict)]
    if len(snaps) < 2:
        return None
    newest = snaps[-1]
    older = snaps[0]
    for r in snaps[:-1]:
        if r['ts'] >= newest['ts'] - last_s:
            older = r
            break
    if newest['ts'] <= older['ts']:
        older = snaps[-2]
    from petastorm_tpu_torch.observability import history as _history
    window = _history.window_delta(
        {'ts': older['ts'], 'diag': older['data']['metrics']},
        {'ts': newest['ts'], 'diag': newest['data']['metrics']})
    return _history.windowed_stall_report(window)


def postmortem_report(run_dir, last_s=30.0):
    """Merge every flight file under ``run_dir`` and reconstruct the run's
    last seconds: per-process status/crash signal/dying stage, windowed
    stall report, last supervision events, watchdog dumps, and a named
    probable cause. Works from the files alone — every process may be dead."""
    paths = sorted(p for p in os.listdir(run_dir)
                   if p.startswith('flight-') and p.endswith('.bin'))
    procs, skipped = [], []
    for name in paths:
        path = os.path.join(run_dir, name)
        try:
            flight = load_flight(path)
        except (FlightFileError, OSError) as e:
            skipped.append({'path': path, 'error': str(e)})
            continue
        sidecar = parse_crash_sidecar(path + '.crash')
        status, sig = _process_status(flight, sidecar)
        records = flight['records']
        events = [r for r in records if r['kind'] == K_EVENT][-10:]
        watchdogs = [r for r in records if r['kind'] == K_WATCHDOG]
        stalls = [r for r in records if r['kind'] == K_STALL]
        spans = [r for r in records if r['kind'] == K_SPAN]
        span_events = [e for r in spans for e in (r['data'] or {}).get('events', [])]
        procs.append({
            'label': flight['label'], 'pid': flight['pid'],
            'hostname': flight['hostname'], 'path': path,
            'status': status, 'signal': sig,
            'activity': flight['activity'] or None,
            'activity_ts': flight['activity_ts'],
            'start_ts': flight['start_ts'],
            'torn_records': flight['torn'],
            'records_total': len(records),
            'last_event': events[-1]['data'] if events else None,
            'events': [r['data'] for r in events],
            'watchdog_dumps': len(watchdogs),
            'last_watchdog': watchdogs[-1]['data'] if watchdogs else None,
            'last_stall_report': stalls[-1]['data'] if stalls else None,
            'window_stall_report': _snapshot_window(records, last_s),
            'span_events': len(span_events),
            'span_tail': [e.get('name') for e in span_events[-8:]],
            'crash_stacks': (sidecar or {}).get('text'),
        })
    return {'run_dir': run_dir, 'last_s': last_s, 'processes': procs,
            'skipped': skipped, 'probable_cause': _probable_cause(procs)}


def _proc_desc(p):
    return '{} (pid {})'.format(p['label'] or 'proc', p['pid'])


def _probable_cause(procs):
    """Name the most likely reason the run ended, in evidence order: crash
    signal > uncatchable kill > watchdog-confirmed wedge > unclean exit."""
    if not procs:
        return None
    crashed = [p for p in procs if p['status'] == 'crashed']
    if crashed:
        p = crashed[0]
        where = ' mid `{}`'.format(p['activity']) if p['activity'] else ''
        return '{} died on {}{}'.format(_proc_desc(p), p['signal'], where)
    killed = [p for p in procs if p['status'] == 'killed']
    dead = killed
    wedged = [p for p in procs if p['watchdog_dumps']]
    if wedged:
        p = wedged[0]
        dump = p['last_watchdog'] or {}
        cause = '{} wedged in `{}` for {}s (watchdog stack dump recorded)'.format(
            _proc_desc(p), dump.get('activity') or p['activity'] or '?',
            dump.get('age_s', '?'))
        if dead:
            cause += '; peer {} is dead ({})'.format(
                _proc_desc(dead[0]), dead[0]['signal'] or 'no shutdown marker')
        return cause
    if killed:
        p = killed[0]
        where = ' mid `{}`'.format(p['activity']) if p['activity'] else ''
        return ('{} was killed (no shutdown marker, no crash footer — '
                'SIGKILL/OOM){}'.format(_proc_desc(p), where))
    unclean = [p for p in procs if p['status'] == 'running']
    if unclean:
        return '{} still running (or died without the pid being reaped)'.format(
            _proc_desc(unclean[0]))
    return 'no crash or stall evidence: every process exited cleanly'


def format_postmortem(report):
    """Human-readable rendering of :func:`postmortem_report`."""
    from petastorm_tpu_torch.observability.report import format_stall_report
    lines = ['post-mortem of {} ({} flight file(s), last {:.0f}s window)'.format(
        report['run_dir'], len(report['processes']), report['last_s'])]
    if report['probable_cause']:
        lines.append('probable cause: {}'.format(report['probable_cause']))
    for p in report['processes']:
        head = '  {} [{}]'.format(_proc_desc(p), p['status'])
        if p['signal']:
            head += ' signal={}'.format(p['signal'])
        if p['activity']:
            head += ' last-stage={}'.format(p['activity'])
        lines.append(head)
        lines.append('    records={} torn={} watchdog_dumps={} span_events={}'.format(
            p['records_total'], p['torn_records'], p['watchdog_dumps'],
            p['span_events']))
        if p['last_event']:
            lines.append('    last event: {}'.format(
                json.dumps(p['last_event'], sort_keys=True)[:200]))
        if p['last_watchdog']:
            dump = p['last_watchdog']
            lines.append('    watchdog: wedged in `{}` for {}s; locks held: {}'.format(
                dump.get('activity'), dump.get('age_s'),
                [k for k, v in (dump.get('locks') or {}).items() if v] or 'none'))
        report_src = p['window_stall_report'] or p['last_stall_report']
        if report_src and 'reader_wait_s' in report_src:
            try:
                lines.append('    ' + format_stall_report(report_src)
                             .replace('\n', '\n    '))
            except (KeyError, TypeError):
                pass
    for s in report['skipped']:
        lines.append('  skipped {}: {}'.format(s['path'], s['error']))
    return '\n'.join(lines)


def main(argv=None):
    """``python -m petastorm_tpu_torch.observability.blackbox DIR``: one-command
    post-mortem forensics."""
    import argparse
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.observability.blackbox',
        description='Merge the crash-persistent flight files under DIR and '
                    'reconstruct what the run was doing when it died or hung.')
    parser.add_argument('run_dir', nargs='?', default=None,
                        help='flight-file directory (default: the '
                             'PSTPU_FLIGHT_DIR / tmp default run dir)')
    parser.add_argument('--last', type=float, default=30.0, metavar='SECONDS',
                        help='stall-report window: attribute the last N '
                             'seconds before each process stopped recording')
    parser.add_argument('--json', action='store_true', dest='as_json')
    args = parser.parse_args(argv)
    run_dir = args.run_dir or default_dir()
    if not os.path.isdir(run_dir):
        print('no flight directory at {} (was recording enabled? '
              'PSTPU_FLIGHT_DIR relocates it)'.format(run_dir), file=sys.stderr)
        return 1
    report = postmortem_report(run_dir, last_s=args.last)
    if args.as_json:
        print(json.dumps(report, default=repr))
    else:
        print(format_postmortem(report))
    return 0


__all__ = ['DEFAULT_CAPACITY', 'FlightFileError', 'FlightRecorder',
           'K_EVENT', 'K_MARK', 'K_SNAPSHOT', 'K_SPAN', 'K_STALL',
           'K_WATCHDOG', 'default_dir', 'disable', 'enable', 'format_postmortem',
           'get_recorder', 'load_flight', 'main', 'maybe_enable',
           'parse_crash_sidecar', 'postmortem_report', 'record_event',
           'record_mark', 'record_stall', 'register_lock', 'unregister_lock',
           'unwatch_progress', 'watch_progress']


if __name__ == '__main__':
    sys.exit(main())
