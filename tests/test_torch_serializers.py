"""The port's payload serializers (``petastorm_tpu_torch/serializers.py``)
against the JAX package's: the same blocks give the same bytes, and each
package deserializes the other's messages exactly, through every channel of
``NumpyBlockSerializer`` (whole, parts, joined parts, written into a buffer,
framed ahead of the layout)."""

import pickle

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import serializers as jax_serializers
from petastorm_tpu_torch import serializers


def _ragged_images(rng, n, none_at=()):
    col = np.empty(n, dtype=object)
    for i in range(n):
        if i not in none_at:
            col[i] = rng.integers(0, 256, (int(rng.integers(3, 9)), int(rng.integers(3, 9)), 3),
                                  dtype=np.uint8)
    return col


def _strings(n):
    col = np.empty(n, dtype=object)
    col[:] = ['n{:08d}'.format(i) for i in range(n)]
    return col


def _blocks():
    rng = np.random.default_rng(4)
    mixed = np.empty(3, dtype=object)
    mixed[:] = [np.zeros(2, np.int32), 'text', None]
    return {
        'numeric': {'image': rng.integers(0, 256, (4, 6, 6, 3), dtype=np.uint8),
                    'label': np.arange(4, dtype=np.int64),
                    'f16': rng.random((4, 2)).astype(np.float16),
                    'f64': rng.random(4), 'flag': np.array([True, False, True, True]),
                    'u32': np.arange(4, dtype=np.uint32) * 7},
        'strided': {'x': np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2],
                    'fortran': np.asfortranarray(rng.random((3, 4)))},
        'ragged': {'image': _ragged_images(rng, 5), 'label': np.arange(5)},
        'ragged_with_none': {'image': _ragged_images(rng, 4, none_at=(1, 3))},
        'strings': {'noun_id': _strings(6), 'label': np.arange(6, dtype=np.int64)},
        'object_mixed': {'cells': mixed, 'n': np.ones(3)},
        'datetime': {'t': np.array(['2024-01-01', '2025-06-30'], dtype='datetime64[D]'),
                     'dt': np.array([1, 2], dtype='timedelta64[s]')},
        'empty_rows': {'image': np.zeros((0, 4, 4, 3), np.uint8), 'label': np.zeros(0, np.int64)},
        'scalar_extra': {'x': np.arange(3), 'meta': {'source': 'unit'}},
        'not_a_block': [1, 'two', (3.0,)],
        'empty_dict': {},
    }


BLOCKS = _blocks()


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:
            for x, y in zip(a.ravel(), b.ravel()):
                _assert_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_numpy_block_bytes_equal_the_jax_packages(name):
    block = BLOCKS[name]
    ours = serializers.NumpyBlockSerializer().serialize(block)
    assert ours == jax_serializers.NumpyBlockSerializer().serialize(block)


@pytest.mark.parametrize('name', sorted(BLOCKS))
@pytest.mark.parametrize('direction', ['torch_to_jax', 'jax_to_torch'])
def test_each_package_deserializes_the_others_messages(name, direction):
    block = BLOCKS[name]
    port, jax = serializers.NumpyBlockSerializer(), jax_serializers.NumpyBlockSerializer()
    writer, reader = (port, jax) if direction == 'torch_to_jax' else (jax, port)
    # a writable buffer, as the ring and blob channels deliver
    out = reader.deserialize(bytearray(writer.serialize(block)))
    expected = block
    if isinstance(block, dict):
        expected = {k: (np.ascontiguousarray(v) if isinstance(v, np.ndarray) and v.dtype != object
                        else v) for k, v in block.items()}
    _assert_equal(out, expected)


@pytest.mark.parametrize('name', sorted(k for k, v in BLOCKS.items() if isinstance(v, dict) and v))
def test_every_channel_gives_the_same_bytes(name):
    block = BLOCKS[name]
    ser, jax = serializers.NumpyBlockSerializer(), jax_serializers.NumpyBlockSerializer()
    whole = ser.serialize(block)
    parts = ser.serialize_parts(block)
    assert ser.join_parts(parts) == whole == jax.join_parts(jax.serialize_parts(block))
    assert ser.parts_size(parts) == len(whole)
    target = bytearray(len(whole))
    ser.write_parts_into(parts, target).release()
    assert bytes(target) == whole
    got = ser.serialize_into(block, lambda n: bytearray(n))
    if len(parts) > 1:
        assert bytes(got) == whole
    else:
        assert got is None  # nothing raw to frame: the regular channel serves it


def test_frame_for_layout_then_payload_equals_serialize():
    """The in-place channel writes the header before the rows exist; the
    message is the one serialize() gives for the finished block, in both
    packages."""
    block = BLOCKS['numeric']
    ser = serializers.NumpyBlockSerializer()
    meta = [(k, v.dtype.str, v.shape, None) for k, v in block.items()]
    prefix = ser.frame_for_layout(meta)
    assert prefix == jax_serializers.NumpyBlockSerializer.frame_for_layout(meta)
    message = prefix + b''.join(np.ascontiguousarray(v).tobytes() for v in block.values())
    assert message == ser.serialize(block)
    assert ser.frame_for_layout([('x', lambda: 0, (1,), None)]) is None


def test_serialize_into_honours_min_size():
    block = BLOCKS['numeric']
    ser = serializers.NumpyBlockSerializer()
    size = len(ser.serialize(block))
    assert ser.serialize_into(block, bytearray, min_size=size + 1) is None
    assert ser.serialize_into(block, bytearray, min_size=size) is not None


def test_ragged_cells_arrive_writable_from_immutable_bytes():
    ser = serializers.NumpyBlockSerializer()
    out = ser.deserialize(ser.serialize(BLOCKS['ragged']))  # bytes: read-only buffer
    assert all(cell.flags.writeable for cell in out['image'])
    out = ser.deserialize(bytearray(ser.serialize(BLOCKS['ragged'])))
    assert all(cell.flags.writeable for cell in out['image'])
    assert out['label'].flags.writeable  # numeric views over a writable buffer


def test_numeric_columns_are_views_of_the_message():
    ser = serializers.NumpyBlockSerializer()
    buf = bytearray(ser.serialize(BLOCKS['numeric']))
    out = ser.deserialize(buf)
    out['label'][0] = 99  # a view: the write lands in the message
    assert ser.deserialize(buf)['label'][0] == 99


@pytest.mark.parametrize('payload', [pa.table({'x': np.arange(5), 's': ['a', 'b', 'c', 'd', 'e']}),
                                     ValueError('not a table')], ids=['table', 'exception'])
def test_arrow_table_serializer_matches_and_crosses(payload):
    ours, theirs = serializers.ArrowTableSerializer(), jax_serializers.ArrowTableSerializer()
    message = ours.serialize(payload)
    assert message == theirs.serialize(payload)
    for reader in (ours, theirs):
        out = reader.deserialize(memoryview(message))
        if isinstance(payload, pa.Table):
            assert out.equals(payload)
        else:
            assert type(out) is ValueError and out.args == payload.args


def test_pickle_serializer_matches():
    obj = {'a': [1, 2], 'b': np.arange(3)}
    message = serializers.PickleSerializer().serialize(obj)
    assert message == jax_serializers.PickleSerializer().serialize(obj)
    out = jax_serializers.PickleSerializer().deserialize(message)
    assert out['a'] == [1, 2] and np.array_equal(out['b'], obj['b'])
    assert pickle.loads(message)['a'] == [1, 2]
