"""Device infeed: double-buffered host->device staging.

Twin of ``petastorm_tpu/jax/infeed.py``. ``prefetch_to_device`` keeps
``size`` batches in flight: each batch is copied into pinned host memory and
sent with ``.to(device, non_blocking=True)`` on a side CUDA stream (one
that a graph capture on the consumer's thread never uses), and an
event recorded after its copies makes the consumer's stream wait for exactly
that batch. So the copy of batch N+1 overlaps compute on batch N, and the
consumer never reads a batch before it has landed.

Staging onto a :class:`~petastorm_tpu_torch.parallel.DataSharding` (the
twin of staging onto a ``NamedSharding``) puts this rank's rows on the
sharding's device; when the sharding's replica group (the ranks of one
``model`` group) has more than one rank, the group's first rank's batch is
then broadcast over it, so every rank of the group trains on the same rows
in the same order. ``prefetch_to_device`` stages on its thread and
broadcasts on the consumer's, where the train step issues its own
collectives: two threads must not interleave collectives on one group. A
sequence sharding (``data_sharding(mesh, seq_axis='seq')``, the twin of
``P('data', 'seq', ...)``) then keeps this rank's slice of axis 1 of every
array, which must have one.

Telemetry, as the JAX infeed's: each staging is an ``infeed`` stage, which
times the host's part (the copy into pinned memory and the enqueue of the
non-blocking copy; it adds no synchronisation). When the iterator is a
loader, the staging runs under the loader's ``last_trace``, read on the
thread that pulled the batch, so the span joins that batch's tree. The
port also splits it, per array, into the stages ``infeed_alloc`` (the pinned
allocation), ``infeed_copy`` (the host copy: into pinned memory, or on the
CPU the copy that makes an array writable, where one is needed) and
``infeed_enqueue`` (the non-blocking copy's enqueue), counts the host bytes
copied in ``infeed_bytes_total``, and times the background pump's wait on a
full queue (``prefetch_put_wait``), the consumer's wait on an empty one
(``prefetch_get_wait``) and the consumer's part of each batch
(``prefetch_hand_over``: the stream wait and a sharding's broadcast).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.parallel.mesh import DataSharding

#: numpy dtype kinds that can live on the device; everything else (strings,
#: objects, datetimes) stays host-side numpy
TORCH_COMPATIBLE_KINDS = ('b', 'i', 'u', 'f', 'c')

#: dtypes torch cannot hold (or holds poorly), promoted as the JAX package's
#: torch adapter does (``petastorm_tpu/torch_utils.py``)
_PROMOTIONS = {
    np.dtype(np.uint16): np.int32,
    np.dtype(np.uint32): np.int64,
    np.dtype(np.uint64): np.int64,
}

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def _to_tensor(x, device):
    """``x`` on ``device``, and the host bytes copied on the way."""
    if x.dtype in _PROMOTIONS:
        x = x.astype(_PROMOTIONS[x.dtype])
    if device.type == 'cpu':
        # torch.from_numpy needs writable memory: read-only views copy
        with obs.stage('infeed_copy', cat='infeed'):
            host = np.require(x, requirements=['C', 'W'])
        return torch.from_numpy(host), 0 if host is x else host.nbytes
    with obs.stage('infeed_alloc', cat='infeed'):
        host = torch.empty(x.shape, dtype=_TORCH_DTYPES[x.dtype.newbyteorder('=')],
                           pin_memory=True)
    with obs.stage('infeed_copy', cat='infeed'):
        host.numpy()[...] = x  # the one host copy: into pinned memory
    with obs.stage('infeed_enqueue', cat='infeed'):
        return host.to(device, non_blocking=True), x.nbytes


def _target_device(target):
    """The device of a staging target: a device (``None`` = CUDA) or a
    :class:`DataSharding`."""
    return target.device if isinstance(target, DataSharding) else resolve_device(target)


def _broadcast_replicas(staged, target):
    """The replica group's first rank's batch, in the structure of
    ``staged``: tensors by ``broadcast`` (a CPU tensor, which may share the
    loader's numpy memory, is received into a copy), host-side columns by
    ``broadcast_object_list``. ``staged`` itself unless ``target`` is a
    :class:`DataSharding` with a replica group."""
    group = target.replica_group if isinstance(target, DataSharding) else None
    if group is None:
        return staged
    src = dist.get_global_rank(group, 0)
    host = []

    def receive(x):
        if isinstance(x, dict):
            return {k: receive(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            x = x if x.is_cuda else x.clone()
            dist.broadcast(x, src=src, group=group)
        else:
            host.append(x)
        return x

    staged = receive(staged)
    if not host:
        return staged
    dist.broadcast_object_list(host, src=src, group=group)
    received = iter(host)

    def swap(x):
        if isinstance(x, dict):
            return {k: swap(v) for k, v in x.items()}
        return x if isinstance(x, torch.Tensor) else next(received)

    return swap(staged)


def _slice_sequence(staged, target):
    """This rank's slice of axis 1 of every array of ``staged`` on a
    sequence sharding; ``staged`` itself otherwise."""
    if not isinstance(target, DataSharding) or target.seq_size == 1:
        return staged
    size, index = target.seq_size, target.seq_index

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if x.ndim < 2 or x.shape[1] % size:
            raise ValueError('a sequence sharding splits axis 1 in {} slices; got an array of '
                             'shape {}'.format(size, tuple(x.shape)))
        width = x.shape[1] // size
        return x[:, index * width:(index + 1) * width]

    return cut(staged)


def _distribute(staged, target):
    """The replica group's first rank's batch, then this rank's sequence
    slice of it."""
    return _slice_sequence(_broadcast_replicas(staged, target), target)


def _stage_local(batch, device, stream=None):
    copied = 0

    def put(x):
        nonlocal copied
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, np.ndarray) and x.dtype.kind in TORCH_COMPATIBLE_KINDS:
            tensor, nbytes = _to_tensor(x, device)
            copied += nbytes
            return tensor
        return x

    # the host's part of staging (async copies): what can stall the pipeline
    with obs.stage('infeed', cat='infeed'):
        if device.type == 'cuda' and stream is not None:
            with torch.cuda.stream(stream):
                staged = put(batch)
        else:
            staged = put(batch)
    obs.count('infeed_bytes_total', copied)
    return staged


def stage_batch(batch, device=None, stream=None):
    """Move the numeric numpy arrays of a (possibly nested) batch dict onto
    ``device``: a device (``None`` = CUDA) or a
    :class:`~petastorm_tpu_torch.parallel.DataSharding` (this rank's rows on
    its device, then broadcast over its replica group). Other columns stay
    numpy. On CUDA the copies are enqueued on ``stream`` (default: the
    current stream) and are asynchronous: a consumer on another stream must
    wait for them."""
    staged = _stage_local(batch, _target_device(device), stream)
    return _distribute(staged, device)


def _tensors(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, torch.Tensor):
        yield batch


def _side_stream(device):
    """The stream the infeed stages on, taken from the high-priority pool.

    PyTorch hands out each priority's pool of streams round robin (32 per
    device), and ``torch.cuda.graph`` captures on a default-priority stream
    taken from it once. So a default-priority stream taken here is, every
    32nd time, that capture stream: a batch staged on it while the consumer
    captures a graph joins the capture (its copies and its event become
    nodes of the graph), and the consumer's wait for that event then fails
    with CUDA's "invalid argument". A high-priority stream is never that
    stream."""
    return torch.cuda.Stream(device, priority=-1)


def prefetch_to_device(iterator, device=None, size=2, background=True):
    """Yield batches from ``iterator`` staged onto ``device`` (``None`` =
    CUDA, or a :class:`~petastorm_tpu_torch.parallel.DataSharding`), keeping
    ``size`` batches in flight ahead of the consumer.

    ``background=True`` (default) pulls and stages on a dedicated thread;
    its errors are re-raised on the consumer thread. ``background=False``
    refills synchronously on the consumer thread. A sharding's replica
    broadcast runs on the consumer thread, as each batch is handed over.
    """
    target = device
    device = _target_device(target)
    if size < 1:
        raise ValueError('size must be >= 1')
    side = _side_stream(device) if device.type == 'cuda' else None

    def stage(batch):
        # the loader's last_trace, read on the thread that just pulled the
        # batch: the infeed span joins that batch's tree
        with obs.use_trace(getattr(iterator, 'last_trace', None)):
            staged = _stage_local(batch, device, stream=side)
        event = None
        if side is not None:
            event = torch.cuda.Event()
            event.record(side)
        return staged, event

    def hand_over(staged, event):
        with obs.stage('prefetch_hand_over', cat='infeed'):
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for t in _tensors(staged):
                    # allocated on the side stream, used on the consumer's:
                    # the caching allocator must not recycle it before that
                    # use ends
                    t.record_stream(consumer)
            return _distribute(staged, target)

    if background:
        return _prefetch_background(iterator, stage, hand_over, size)
    return _prefetch_sync(iterator, stage, hand_over, size)


def _prefetch_sync(iterator, stage, hand_over, size):
    pending = deque()
    it = iter(iterator)
    try:
        while True:
            while len(pending) < size:
                try:
                    pending.append(stage(next(it)))
                except StopIteration:
                    while pending:
                        yield hand_over(*pending.popleft())
                    return
            yield hand_over(*pending.popleft())
    finally:
        pending.clear()


class _Final(object):
    """End-of-stream sentinel; carries the pump's exception, if any."""

    def __init__(self, exc=None):
        self.exc = exc


def _prefetch_background(iterator, stage, hand_over, size):
    q = queue_mod.Queue(maxsize=size)
    stop = threading.Event()

    def put(item):
        # the pump's wait on a full queue: the input's headroom
        with obs.stage('prefetch_put_wait', cat='infeed'):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

    def pump():
        try:
            for batch in iterator:
                if not put(stage(batch)):
                    return
            put(_Final())
        except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer thread
            put(_Final(exc))

    thread = threading.Thread(target=pump, daemon=True, name='pstpu-torch-prefetch')
    thread.start()
    try:
        while True:
            with obs.stage('prefetch_get_wait', cat='infeed'):
                item = q.get()
            if isinstance(item, _Final):
                if item.exc is not None:
                    raise item.exc
                return
            yield hand_over(*item)
    finally:
        stop.set()
        thread.join(timeout=5)
