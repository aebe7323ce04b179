"""Tail-following reads: iterate a store that is still being written.

Twin of ``petastorm_tpu/sequence/tail.py``; the snapshot files are the JAX
package's, byte for byte, so a snapshot one package publishes is followed by
the other. A writer opened with ``append=True`` calls
:meth:`~petastorm_tpu_torch.etl.dataset_metadata.DatasetWriter.publish`
whenever it wants the rows written so far visible. ``publish`` closes the
open part files (a Parquet footer exists only on a closed file), rewrites
``_common_metadata`` with the merged row-group counts, and stamps an
immutable marker ``_snapshots/snap-NNNNNN.json`` holding the cumulative
piece list ``[[relpath, row_group, num_rows], ...]`` (a hard-linked publish,
with an ``O_EXCL`` create where links are refused, on local filesystems).
Readers skip a torn marker and pick it up whole on a later poll.

:class:`TailFollowingReader` turns that into a row stream that delivers
every row once: each *delta epoch* is one inner
:func:`~petastorm_tpu_torch.reader.make_reader` scoped (``piece_filter``) to
the row groups a new snapshot added beyond those already delivered. A piece
is wholly inside one delta or not visible at all. Growth shows as the
``dataset_grew`` counter; polling between snapshots is paced by
``poll_interval`` and bounded by ``idle_timeout``.

This module reads the wall clock (the poll cadence): it is outside rule
PT1400's scope, which covers sampling decisions, not IO pacing.
"""

from __future__ import annotations

import errno
import json
import os
import posixpath
import time

from pyarrow import fs as pafs

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.fs import FilesystemResolver

SNAPSHOT_DIR = '_snapshots'
_SNAPSHOT_FMT = 'snap-{:06d}.json'


def _snapshot_id(basename):
    """``snap-000012.json`` -> 12, or None for foreign or temporary files."""
    if not (basename.startswith('snap-') and basename.endswith('.json')):
        return None
    stem = basename[len('snap-'):-len('.json')]
    return int(stem) if stem.isdigit() else None


def list_snapshots(dataset_url):
    """All published snapshots as ``[(snapshot_id, info_dict)]``, ascending.

    Torn or foreign files under ``_snapshots/`` are skipped: a marker is
    returned only once it parses as a whole snapshot.
    """
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    snap_dir = posixpath.join(root, SNAPSHOT_DIR)
    infos = fs.get_file_info(pafs.FileSelector(snap_dir, allow_not_found=True))
    out = []
    for info in infos:
        if info.type != pafs.FileType.File:
            continue
        snap_id = _snapshot_id(posixpath.basename(info.path))
        if snap_id is None:
            continue
        try:
            with fs.open_input_stream(info.path) as f:
                payload = json.loads(f.read().decode('utf-8'))
            if payload.get('snapshot') != snap_id or 'pieces' not in payload:
                continue
        except (ValueError, OSError):
            continue  # torn marker mid-write: whole on a later poll
        out.append((snap_id, payload))
    out.sort(key=lambda pair: pair[0])
    return out


def latest_snapshot(dataset_url):
    """The newest whole snapshot's info dict, or None if none is published."""
    snaps = list_snapshots(dataset_url)
    return snaps[-1][1] if snaps else None


def publish_snapshot(dataset_url, final=False):
    """Stamp a snapshot marker naming every row group the current
    ``_common_metadata`` counts describe.

    Normally called through
    :meth:`~petastorm_tpu_torch.etl.dataset_metadata.DatasetWriter.publish`,
    which first closes the open part files and rewrites the counts; called
    directly it stamps a store whose metadata is already current (snapshot 0
    of a finished store, for followers to start from).

    :param final: marks the snapshot terminal: followers drain it and stop
        instead of polling for more
    :returns: the published snapshot id (int)
    """
    from petastorm_tpu_torch.etl.dataset_metadata import (ROW_GROUPS_PER_FILE_KEY,
                                                          _read_common_metadata)
    resolver = FilesystemResolver(dataset_url)
    fs, root = resolver.filesystem(), resolver.get_dataset_path()
    meta = _read_common_metadata(fs, root)
    if ROW_GROUPS_PER_FILE_KEY not in meta:
        raise PetastormTpuError(
            'Cannot publish a snapshot of {}: no row-group inventory in '
            '_common_metadata (write through materialize_dataset / '
            'DatasetWriter.publish first)'.format(dataset_url))
    counts = json.loads(meta[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
    pieces = []
    for relpath in sorted(counts):
        entry = counts[relpath]
        row_counts = entry if isinstance(entry, list) else [None] * entry
        for rg, num_rows in enumerate(row_counts):
            pieces.append([relpath, rg, num_rows])

    snap_dir = posixpath.join(root, SNAPSHOT_DIR)
    fs.create_dir(snap_dir, recursive=True)
    existing = [sid for sid, _ in list_snapshots(dataset_url)]
    snap_id = (existing[-1] + 1) if existing else 0
    while True:
        payload = json.dumps({'snapshot': snap_id, 'final': bool(final),
                              'pieces': pieces})
        path = posixpath.join(snap_dir, _SNAPSHOT_FMT.format(snap_id))
        if _write_marker(fs, path, payload):
            return snap_id
        snap_id += 1  # lost an O_EXCL race: the next id is ours


def _write_marker(fs, path, payload):
    """Write ``payload`` at ``path``, never replacing an existing marker.

    On a local filesystem: a temporary file hard-linked into place (an
    ``O_EXCL`` create where links are unsupported). Elsewhere a plain
    stream: a store has one writer, and readers skip torn markers. Returns
    False when ``path`` exists already (the caller takes the next id).
    """
    if not os.path.isdir(os.path.dirname(path)):
        with fs.open_output_stream(path) as sink:
            sink.write(payload.encode('utf-8'))
        return True
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    try:
        with open(tmp, 'w') as f:
            f.write(payload)
        try:
            os.link(tmp, path)
            return True
        except OSError as e:
            if getattr(e, 'errno', None) not in (errno.EPERM, errno.ENOSYS,
                                                 errno.EOPNOTSUPP):
                return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:
        return False
    try:
        os.write(fd, payload.encode('utf-8'))
    finally:
        os.close(fd)
    return True


class TailFollowingReader(object):
    """Follow a growing store, delivering every published row once.

    Each published snapshot's new row groups become one inner reader epoch
    (``piece_filter``-scoped); a row group joins the delivered set only when
    its delta epoch drains, and a position inside a delta checkpoints
    through the inner reader's own resume state, so ``state_dict()`` and a
    resume neither deliver a row twice nor skip one.

    :param dataset_url: a store grown by a concurrent
        ``DatasetWriter(append=True)`` + ``publish()`` writer
    :param poll_interval: seconds between scans of the snapshot directory
        while idle
    :param idle_timeout: raise :class:`PetastormTpuError` after this many
        seconds without a new snapshot (``None``: poll forever); a snapshot
        published with ``final=True`` ends the stream cleanly instead
    :param resume_state: a dict from :meth:`state_dict`
    :param reader_kwargs: passed to
        :func:`~petastorm_tpu_torch.reader.make_reader` for every delta epoch
        (``num_epochs``, ``piece_filter`` and ``resume_state`` belong to this
        class and are refused)
    """

    def __init__(self, dataset_url, poll_interval=0.5, idle_timeout=60.0,
                 resume_state=None, **reader_kwargs):
        for owned in ('num_epochs', 'piece_filter', 'resume_state'):
            if owned in reader_kwargs:
                raise PetastormTpuError(
                    '{} is owned by TailFollowingReader (one inner epoch per '
                    'snapshot delta)'.format(owned))
        if poll_interval <= 0:
            raise PetastormTpuError('poll_interval must be > 0')
        self._dataset_url = dataset_url
        self._poll_interval = poll_interval
        self._idle_timeout = idle_timeout
        self._reader_kwargs = dict(reader_kwargs)
        self._delivered = set()     # {(relpath, row_group)} of drained epochs
        self._consumed_snapshot = -1
        self._grew = 0
        self._rows_out = 0
        self._final_seen = False
        self._stopped = False
        self._inner = None
        self._current_delta = None  # sorted [(relpath, rg)] of the open epoch
        if resume_state is not None:
            self._load_state(resume_state)

    # -- iteration ----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._inner is not None:
                try:
                    item = next(self._inner)
                except StopIteration:
                    self._retire_inner()
                    continue
                self._rows_out += self._rows_in(item)
                return item
            if self._stopped:
                raise StopIteration
            # once a final marker is seen, drain the snapshots left without
            # waiting for more
            if not self._open_next_delta(poll=not self._final_seen):
                raise StopIteration  # the final snapshot is delivered

    next = __next__

    def _rows_in(self, item):
        # the JAX package's count, kept for parity: the first value of a
        # columnar NGram block is a dict of fields, so len() counts its
        # fields, not its windows
        if getattr(self._inner, 'batched_output', False):
            d = item._asdict() if hasattr(item, '_asdict') else item
            first = next(iter(d.values()))
            try:
                return len(first)
            except TypeError:
                return 1
        return 1

    def _retire_inner(self):
        """A delta epoch drained: its pieces are delivered."""
        self._delivered.update(self._current_delta)
        self._current_delta = None
        inner, self._inner = self._inner, None
        inner.stop()
        inner.join()

    def _open_next_delta(self, poll):
        """Scope a reader to the next snapshot's new pieces. Returns True when
        an epoch opened, False when a final snapshot is delivered. Raises at
        the idle timeout (the writer gone without a final marker)."""
        deadline = (time.monotonic() + self._idle_timeout
                    if self._idle_timeout is not None else None)
        while True:
            for snap_id, info in list_snapshots(self._dataset_url):
                if snap_id <= self._consumed_snapshot:
                    continue
                delta = sorted((relpath, rg) for relpath, rg, _ in info['pieces']
                               if (relpath, rg) not in self._delivered)
                self._consumed_snapshot = snap_id
                self._final_seen = self._final_seen or bool(info.get('final'))
                if delta:
                    self._grew += 1
                    obs.count('dataset_grew')
                    self._start_inner(delta)
                    return True
            if self._final_seen:
                return False
            if not poll:
                return False
            if deadline is not None and time.monotonic() >= deadline:
                raise PetastormTpuError(
                    'No new snapshot of {} within idle_timeout={}s — the '
                    'appending writer is gone without publishing final=True '
                    '(raise idle_timeout, or None to poll forever)'.format(
                        self._dataset_url, self._idle_timeout))
            time.sleep(self._poll_interval)

    def _start_inner(self, delta, inner_resume=None):
        from petastorm_tpu_torch.reader import make_reader
        self._current_delta = delta
        delta_set = set(delta)
        root = FilesystemResolver(self._dataset_url).get_dataset_path()

        def _in_delta(piece, _root=root, _set=delta_set):
            rel = posixpath.relpath(piece.path, _root)
            return (rel, piece.row_group) in _set

        self._inner = make_reader(self._dataset_url, num_epochs=1,
                                  piece_filter=_in_delta,
                                  resume_state=inner_resume,
                                  **self._reader_kwargs)

    # -- checkpoint ---------------------------------------------------------

    def state_dict(self):
        """The position to resume from: the delivered set, the snapshot
        cursor and, inside a delta epoch, its pieces and the inner reader's
        own resume state."""
        return {
            'version': 1,
            'delivered': sorted(self._delivered),
            'consumed_snapshot': self._consumed_snapshot,
            'final_seen': self._final_seen,
            'current_delta': (list(self._current_delta)
                              if self._current_delta is not None else None),
            'inner': self._inner.state_dict() if self._inner is not None else None,
        }

    def _load_state(self, state):
        if not isinstance(state, dict) or state.get('version') != 1:
            raise PetastormTpuError('Unrecognized resume_state (expected a dict '
                                    'from TailFollowingReader.state_dict())')
        self._delivered = {(relpath, rg) for relpath, rg in state['delivered']}
        self._consumed_snapshot = state['consumed_snapshot']
        self._final_seen = state['final_seen']
        if state['current_delta'] is not None:
            delta = sorted((relpath, rg) for relpath, rg in state['current_delta'])
            self._start_inner(delta, inner_resume=state['inner'])

    # -- reader surface -----------------------------------------------------

    @property
    def batched_output(self):
        if self._inner is not None:
            return self._inner.batched_output
        return self._reader_kwargs.get('output', 'rows') == 'columnar'

    @property
    def diagnostics(self):
        """The tail keys are always present; the open delta epoch's inner
        reader's diagnostics merge in under them."""
        out = dict(self._inner.diagnostics) if self._inner is not None else {}
        out['dataset_grew'] = self._grew
        out['tail_snapshot'] = self._consumed_snapshot
        out['tail_pieces_delivered'] = len(self._delivered)
        out['tail_rows_delivered'] = self._rows_out
        return out

    def stop(self):
        self._stopped = True
        if self._inner is not None:
            self._inner.stop()

    def join(self):
        if self._inner is not None:
            self._inner.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()
