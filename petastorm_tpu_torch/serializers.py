"""Payload serializers for the worker-process -> main-process results channel.

Twin of ``petastorm_tpu/serializers.py``, byte for byte on the wire: a
message framed by one package deserializes in the other.

Workers publish *column blocks* (dicts of numpy arrays), so the process
pool's default is :class:`NumpyBlockSerializer`, a raw-buffer framing whose
deserialize builds numpy views over the received message (no parse, no
per-array copy). Pickle is the universal fallback and is embedded for
non-block payloads; :class:`ArrowTableSerializer` covers ``pyarrow.Table``
payloads.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np
import pyarrow as pa


class PickleSerializer(object):
    def serialize(self, obj):
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, data):
        return pickle.loads(data)


class NumpyBlockSerializer(object):
    """Column blocks (dict of numpy arrays) as a pickled header followed by
    the arrays' raw buffers.

    Serialize is one memcpy per array; deserialize builds numpy views over
    the received message, which stays alive as long as the views do (the shm
    ring copies each message into a fresh buffer, or lends the slot under the
    lifetime ledger; zmq hands out a buffer of its own). Ragged object
    columns whose cells are ndarrays of one dtype (decoded images of varying
    size) ride the same raw-buffer channel, one buffer per cell with the
    shapes in the header; other object columns and non-block payloads ride
    an embedded pickle.
    """

    _BLOCK = b'N'
    _PICKLE = b'P'

    @staticmethod
    def _ragged_buffers(v):
        """``(cell_arrays, dtype_str, shapes)`` when every non-None cell of
        the 1-D object column ``v`` is an ndarray of one simple dtype (None
        cells allowed); else None. ``shapes`` has a None per None cell;
        ``cell_arrays`` holds only the present cells, contiguous."""
        if v.ndim != 1 or v.size == 0:
            return None
        dtype = None
        cells, shapes = [], []
        for el in v:
            if el is None:
                shapes.append(None)
                continue
            if not isinstance(el, np.ndarray) or el.dtype.hasobject or \
                    el.dtype.names is not None:
                return None
            if dtype is None:
                dtype = el.dtype
            elif el.dtype != dtype:
                return None
            el = np.ascontiguousarray(el)
            cells.append(el)
            shapes.append(el.shape)
        if dtype is None:  # all-None column: nothing raw to frame
            return None
        return cells, dtype.str, shapes

    @classmethod
    def _split_block(cls, obj):
        """The block classification and header framing every channel shares
        (join, parts, blob; all byte-identical for :meth:`deserialize`):
        ``(buffers, header_bytes)``, where buffers is the ordered list of
        contiguous arrays whose raw bytes follow the header, or None when the
        payload must ride plain pickle. Header meta entries are ``(name,
        dtype_str, shape, ragged_shapes)`` with exactly one of
        shape/ragged_shapes set."""
        if not isinstance(obj, dict) or not obj:
            return None
        meta = []
        buffers = []
        others = {}
        for k, v in obj.items():
            if not isinstance(v, np.ndarray):
                others[k] = v
            elif v.dtype != object and not v.dtype.hasobject and v.dtype.names is None:
                v = np.ascontiguousarray(v)
                meta.append((k, v.dtype.str, v.shape, None))
                buffers.append(v)
            else:
                ragged = cls._ragged_buffers(v) if v.dtype == object else None
                if ragged is None:
                    others[k] = v
                else:
                    cells, dtype_str, shapes = ragged
                    meta.append((k, dtype_str, None, shapes))
                    buffers.extend(cells)
        try:
            header = pickle.dumps((meta, others), protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 - unpicklable extras: plain pickle
            return None
        return buffers, header

    @staticmethod
    def _array_bytes(v):
        # datetime/timedelta arrays refuse buffer export, and
        # memoryview.cast('B') rejects views with zeros in shape/strides
        # (empty blocks): tobytes() for both, b'' is free anyway
        if v.dtype.kind in 'Mm' or v.size == 0:
            return v.tobytes()
        return memoryview(v).cast('B')  # noqa: PT500 - serialize-side source view, read only

    def serialize(self, obj):
        parts = self.serialize_parts(obj)
        if parts is None:
            return self._PICKLE + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return self.join_parts(parts)

    def serialize_parts(self, obj):
        """The framed message as a list of segments (one leading bytes
        prefix, then the raw column/cell arrays) for a gather-writing
        transport (``ShmRing.writev``); their concatenation is byte-identical
        to :meth:`serialize`. None when the payload must ride plain pickle
        (callers then use :meth:`serialize`)."""
        split = self._split_block(obj)
        if split is None:
            return None
        buffers, header = split
        return [b''.join((self._BLOCK, struct.pack('<I', len(header)), header))] + buffers

    @classmethod
    def frame_for_layout(cls, meta):
        """Framing prefix (marker + header) for a block whose column layout
        is known ahead of its decode: the in-place ring channel writes it
        before the payload bytes exist, and the fused native decode lands
        the rows right after it. ``meta`` entries are the ``(name,
        dtype_str, shape, ragged_shapes)`` tuples of :meth:`_split_block`;
        the message bytes equal :meth:`serialize` output for the same block.
        None for layouts the framing cannot carry."""
        try:
            header = pickle.dumps((list(meta), {}), protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 - unpicklable layout: copy path
            return None
        return b''.join((cls._BLOCK, struct.pack('<I', len(header)), header))

    @classmethod
    def parts_size(cls, parts):
        return sum(p.nbytes if isinstance(p, np.ndarray) else len(p) for p in parts)

    @classmethod
    def join_parts(cls, parts):
        """In-band form of an already split payload (byte-identical to
        :meth:`serialize`): the split never runs twice."""
        return b''.join(cls._array_bytes(p) if isinstance(p, np.ndarray) else p
                        for p in parts)

    @classmethod
    def write_parts_into(cls, parts, target):
        """Write a :meth:`serialize_parts` result into ``target`` (an mmapped
        /dev/shm blob): the single-copy channel. Returns the memoryview over
        ``target``, which the caller releases."""
        buf = memoryview(target)  # noqa: PT500 - target is a caller-provided writable buffer
        off = 0
        for p in parts:
            if isinstance(p, np.ndarray):
                n = p.nbytes
                buf[off:off + n] = cls._array_bytes(p)
            else:
                n = len(p)
                buf[off:off + n] = p
            off += n
        return buf

    def deserialize(self, data):
        mv = memoryview(data)
        marker = bytes(mv[:1])
        if marker == self._PICKLE:
            return pickle.loads(mv[1:])
        (hlen,) = struct.unpack('<I', mv[1:5])
        meta, out = pickle.loads(mv[5:5 + hlen])
        off = 5 + hlen
        for name, dtype_str, shape, ragged in meta:
            dt = np.dtype(dtype_str)
            if ragged is None:
                n = dt.itemsize
                for dim in shape:
                    n *= dim
                out[name] = np.frombuffer(mv[off:off + n], dtype=dt).reshape(shape)
                off += n
            else:
                col = np.empty(len(ragged), dtype=object)
                for i, shp in enumerate(ragged):
                    if shp is None:
                        continue
                    n = dt.itemsize
                    for dim in shp:
                        n *= dim
                    cell = np.frombuffer(mv[off:off + n], dtype=dt).reshape(shp)
                    # ragged cells arrive writable whatever the transport:
                    # over an immutable buffer the view is read-only, so copy
                    col[i] = cell if cell.flags.writeable else cell.copy()
                    off += n
                out[name] = col
        return out

    def serialize_into(self, obj, alloc, min_size=0):
        """Single-copy serialize: the exact framed size, a writable buffer
        from ``alloc(size)``, the message written straight into it. None when
        ``obj`` does not qualify (non-block payload, no raw buffers, or total
        < ``min_size``): callers then use :meth:`serialize`."""
        parts = self.serialize_parts(obj)
        if parts is None or len(parts) == 1:
            return None
        total = self.parts_size(parts)
        if total < min_size:
            return None
        return self.write_parts_into(parts, alloc(total))


class ArrowTableSerializer(object):
    """``pyarrow.Table`` payloads as Arrow IPC streams; other payloads
    (exceptions) ride pickle behind a marker byte."""

    _TABLE = b'T'
    _PICKLE = b'P'

    def serialize(self, obj):
        if isinstance(obj, pa.Table):
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, obj.schema) as writer:
                writer.write_table(obj)
            return self._TABLE + sink.getvalue().to_pybytes()
        return self._PICKLE + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, data):
        # the shm transport delivers memoryviews: bytes() makes the marker
        # compare equal to the bytes constants
        marker, body = bytes(data[:1]), data[1:]
        if marker == self._TABLE:
            with pa.ipc.open_stream(pa.BufferReader(body)) as reader:
                return reader.read_all()
        return pickle.loads(body)
