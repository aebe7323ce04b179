"""Stream-multiplexing worker: one worker fleet serving many streams.

Twin of ``petastorm_tpu/serve/worker.py``. The serve daemon runs one pool
whose workers are :class:`MultiplexWorker`\\ s. Every ventilated item carries
a ``stream_id``; the worker builds the stream's real worker
(:class:`~petastorm_tpu_torch.row_worker.RowGroupDecoderWorker` or
:class:`~petastorm_tpu_torch.batch_worker.ArrowBatchWorker`) from the spec
file the broker wrote under the service directory before ventilating the
stream's first item, then delegates to it. Streams attach and detach while
the daemon runs without the pool restarting: the spec files carry each
stream's worker arguments into workers that already run (the daemon is
per-host, so a local file reaches every worker the shm ring does).

Batches of at least ``blob_threshold`` bytes are parked in a shared
``/dev/shm`` blob and only the path crosses the broadcast ring
(:class:`_BlobPublish`); a fused row group is decoded straight into its blob
(``reserve_fused``).
"""

from __future__ import annotations

import logging
import mmap
import os
import pickle
import tempfile

from petastorm_tpu_torch.serializers import NumpyBlockSerializer
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)

#: inner workers kept open per pool worker; beyond this the least recently
#: used stream's worker is shut down (its spec file reloads on demand)
_MAX_OPEN_STREAMS = 8

#: batches at least this large ride a shared /dev/shm blob, and only the path
#: crosses the broadcast ring: consumers map it copy-on-write with no upfront
#: copy, and the fan-out to K consumers copies nothing per consumer
DEFAULT_SERVE_BLOB_THRESHOLD = 1 << 20


class BlobRef(object):
    """A published batch parked in a shared blob file: what the worker hands
    the pool instead of the block. Picklable (a process-pool daemon ships it
    over its results transport)."""

    __slots__ = ('path', 'size')

    def __init__(self, path, size):
        self.path = path
        self.size = size

    def __reduce__(self):
        return (BlobRef, (self.path, self.size))


class FusedBlobRef(object):
    """A fused batch decoded straight into a shared blob: its path and the
    layout of each column, ``(name, dtype_str, shape, offset, nbytes)``.
    Consumers build numpy views over the mapping: no copy of the batch
    between the Parquet pages and the training loop."""

    __slots__ = ('path', 'size', 'rows', 'cols')

    def __init__(self, path, size, rows, cols):
        self.path = path
        self.size = size
        self.rows = rows
        self.cols = cols

    def __reduce__(self):
        return (FusedBlobRef, (self.path, self.size, self.rows, self.cols))


class _BlobPublish(object):
    """The publish function a stream's inner worker gets under the daemon:

    * ``publish(block)``: a block of at least ``threshold`` bytes is written
      into a fresh blob (one buffered write) and published as a
      :class:`BlobRef`; anything smaller passes through in-band;
    * ``publish.reserve_fused(total, rows)``: the fused native decode writes
      the batch straight into the blob's mapping
      (``RowGroupDecoderWorker._publish_fused_blob``);
    * ``publish.reserve_block(meta, payload_max)``: the process pool's
      in-place contract, backed by a blob.

    A callable object, not a closure, so the worker's
    ``getattr(publish_func, 'reserve_fused', None)`` probe finds the method.
    """

    def __init__(self, inner_publish, blob_dir, threshold, serializer):
        self._inner = inner_publish
        self._blob_dir = blob_dir
        self._threshold = threshold
        self._serializer = serializer
        self._disabled = False

    def _new_blob(self, total):
        """A fresh writable mapping and path for a ``total``-byte blob.

        :borrows: the caller owns the mapping and closes it (and unlinks the
            path on failure); both exits of the reservations do."""
        fd, path = tempfile.mkstemp(prefix='sb', dir=self._blob_dir)
        try:
            os.posix_fallocate(fd, 0, total)  # ENOSPC here, not SIGBUS later
            mm = mmap.mmap(fd, total)
        except OSError:
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        os.close(fd)
        return mm, path

    def __call__(self, data):
        ser = self._serializer
        if not self._disabled and self._blob_dir is not None:
            parts = ser.serialize_parts(data)
            if parts is not None:
                total = ser.parts_size(parts)
                if total >= self._threshold:
                    # buffered writes, not a fresh mapping: one kernel copy per
                    # byte and none of a new mapping's page faults
                    fd, path = tempfile.mkstemp(prefix='sb', dir=self._blob_dir)
                    try:
                        with os.fdopen(fd, 'wb') as f:
                            for p in parts:
                                f.write(p if isinstance(p, (bytes, bytearray))
                                        else ser._array_bytes(p))
                        self._inner(BlobRef(path, total))
                        return
                    except OSError as e:
                        logger.warning('serve blob write failed (%s); the batch goes in-band', e)
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                        self._disabled = True
        self._inner(data)

    def reserve_fused(self, total_bound, rows):
        """The direct-decode channel: ``(payload_view, finish, abort)`` over
        a writable blob mapping the fused decode lands the batch in,
        published by ``finish(cols)`` as a :class:`FusedBlobRef`; or None
        (the caller takes the copy path). ``PSTPU_SERVE_FUSED_BLOB=0``
        switches it off."""
        if self._disabled or self._blob_dir is None:
            return None
        if os.environ.get('PSTPU_SERVE_FUSED_BLOB', '1') in ('0', 'off'):
            return None
        if total_bound < self._threshold:
            return None
        try:
            mm, path = self._new_blob(total_bound)
        except OSError as e:
            logger.warning('serve blob allocation failed (%s); copy path', e)
            self._disabled = True
            return None
        view = memoryview(mm)  # noqa: PT500 - writable blob mapping owned by this reservation

        # the mapping dies with the caller's views; tmpfs pages are visible to
        # the consumers as soon as they are written
        def finish(cols):
            self._inner(FusedBlobRef(path, total_bound, rows, cols))

        def abort():
            try:
                os.unlink(path)
            except OSError:
                pass

        return view, finish, abort

    def reserve_block(self, meta_entries, payload_max):
        """The in-place channel: ``(payload_view, commit, abort)`` backed by
        a fresh blob mapping, or None (the caller takes the copy path)."""
        if self._disabled or self._blob_dir is None:
            return None
        prefix = self._serializer.frame_for_layout(meta_entries)
        if prefix is None:
            return None
        total = len(prefix) + payload_max
        if total < self._threshold:
            return None  # small batches take the in-band ring frame
        try:
            mm, path = self._new_blob(total)
        except OSError as e:
            logger.warning('serve blob allocation failed (%s); in-band path', e)
            self._disabled = True
            return None
        view = memoryview(mm)  # noqa: PT500 - writable blob mapping owned by this reservation
        view[:len(prefix)] = prefix

        # the mapping is not closed on commit or abort: the caller still holds
        # numpy views over the payload; it unmaps when they die
        def commit(actual_payload=payload_max):
            self._inner(BlobRef(path, len(prefix) + actual_payload))

        def abort():
            try:
                os.unlink(path)
            except OSError:
                pass

        return view[len(prefix):], commit, abort


def stream_spec_path(service_dir, stream_id):
    """Where a stream's pickled ``(worker_class, worker_args)`` lives."""
    return os.path.join(service_dir, 'streams', '{}.pkl'.format(stream_id))


def write_stream_spec(service_dir, stream_id, worker_class, worker_args):
    """Publish a stream's worker spec for the fleet (broker side; temp file
    and rename, so a worker never loads half a pickle)."""
    path = stream_spec_path(service_dir, stream_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    with open(tmp, 'wb') as f:
        pickle.dump((worker_class, worker_args), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def remove_stream_spec(service_dir, stream_id):
    try:
        os.unlink(stream_spec_path(service_dir, stream_id))
    except OSError:
        pass


class MultiplexWorker(WorkerBase):
    """``args``: ``{'service_dir', 'blob_dir', 'blob_threshold',
    'telemetry'}``. Items are the inner worker's kwargs plus ``stream_id``."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._inner = {}   # stream_id -> inner worker (insertion-ordered LRU)

    def _inner_worker(self, stream_id):
        worker = self._inner.pop(stream_id, None)
        if worker is None:
            with open(stream_spec_path(self.args['service_dir'], stream_id), 'rb') as f:
                worker_class, worker_args = pickle.load(f)
            publish = self.publish_func
            blob_dir = self.args.get('blob_dir')
            if blob_dir is not None:
                publish = _BlobPublish(
                    publish, blob_dir,
                    self.args.get('blob_threshold', DEFAULT_SERVE_BLOB_THRESHOLD),
                    NumpyBlockSerializer())
            worker = worker_class(self.worker_id, publish, worker_args)
            if len(self._inner) >= _MAX_OPEN_STREAMS:
                old_id, old = next(iter(self._inner.items()))
                del self._inner[old_id]
                try:
                    old.shutdown()
                except Exception:  # noqa: BLE001 - a stale stream's cleanup must not fail the live one
                    logger.debug('shutdown of idle stream %s worker failed', old_id)
        self._inner[stream_id] = worker  # re-inserted: most recently used
        return worker

    def process(self, stream_id, **kwargs):
        self._inner_worker(stream_id).process(**kwargs)

    def shutdown(self):
        for worker in self._inner.values():
            try:
                worker.shutdown()
            except Exception:  # noqa: BLE001 - best-effort fan-in of the inner shutdowns
                pass
        self._inner = {}


__all__ = ['BlobRef', 'DEFAULT_SERVE_BLOB_THRESHOLD', 'FusedBlobRef', 'MultiplexWorker',
           'remove_stream_spec', 'stream_spec_path', 'write_stream_spec']
