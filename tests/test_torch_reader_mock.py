"""Port parity: ``generator``, ``test_util.reader_mock`` and
``test_util.shuffling_analysis`` of petastorm_tpu_torch against the JAX
package.

Equal seeds must give equal rows (every field type the generator draws:
ints of each width, floats, bools, strings, bytes, Decimals, datetimes,
wildcard shapes), the cases of ``tests/test_reader_mock.py`` hold for the
port's ``ReaderMock`` (the JAX loader's replaced by ``TorchDataLoader``),
and ``rank_correlation`` / ``compute_correlation_distribution`` give the
JAX numbers on the same streams."""

from decimal import Decimal

import numpy as np
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.generator import generate_datapoint as jax_generate_datapoint
from petastorm_tpu.test_util import shuffling_analysis as jax_shuffling
from petastorm_tpu.test_util.dataset_utils import TestSchema as JaxTestSchema
from petastorm_tpu.test_util.reader_mock import ReaderMock as JaxReaderMock
from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.generator import LIST_SIZE, generate_datapoint
from petastorm_tpu_torch.test_util import shuffling_analysis
from petastorm_tpu_torch.test_util.reader_mock import ReaderMock, schema_data_generator_example
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField, decode_row, encode_row

#: the JAX suite's TestSchema, loaded by the port from its JSON
TestSchema = Unischema.from_json(JaxTestSchema.to_json())


def _every_type(c, u):
    return u.Unischema('Every', [
        u.UnischemaField('i8', np.int8, (), c.ScalarCodec(), False),
        u.UnischemaField('u16', np.uint16, (2,), c.NdarrayCodec(), False),
        u.UnischemaField('i64', np.int64, (), c.ScalarCodec(), False),
        u.UnischemaField('u64', np.uint64, (None,), c.NdarrayCodec(), False),
        u.UnischemaField('f16', np.float16, (3,), c.NdarrayCodec(), False),
        u.UnischemaField('f64', np.float64, (), c.ScalarCodec(), False),
        u.UnischemaField('flag', np.bool_, (), c.ScalarCodec(), False),
        u.UnischemaField('flags', np.bool_, (2, 2), c.NdarrayCodec(), False),
        u.UnischemaField('word', np.str_, (), c.ScalarCodec(), False),
        u.UnischemaField('words', np.str_, (None, 2), c.NdarrayCodec(), False),
        u.UnischemaField('token', np.bytes_, (), c.ScalarCodec(), False),
        u.UnischemaField('tokens', np.bytes_, (3,), c.NdarrayCodec(), False),
        u.UnischemaField('price', Decimal, (), c.ScalarCodec(), False),
        u.UnischemaField('when', np.datetime64, (), c.ScalarCodec(), False),
        u.UnischemaField('whens', np.dtype('datetime64[ms]').type, (2,), c.NdarrayCodec(),
                         False),
    ])


def _assert_rows_equal(ours, theirs):
    assert list(ours) == list(theirs)
    for name in ours:
        a, b = ours[name], theirs[name]
        assert type(a) is type(b), name
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', [0, 7, 2**40])
@pytest.mark.parametrize('schema', ['every', 'test_schema'])
def test_generate_datapoint_draws_the_jax_rows(seed, schema):
    if schema == 'every':
        ours_schema, theirs_schema = _every_type(codecs, unischema), \
            _every_type(jax_codecs, jax_unischema)
    else:
        ours_schema, theirs_schema = TestSchema, JaxTestSchema
    rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # consecutive rows from one generator stay equal
        _assert_rows_equal(generate_datapoint(ours_schema, rng=rng),
                           jax_generate_datapoint(theirs_schema, rng=jax_rng))
    for list_size in (1, 5):
        _assert_rows_equal(
            generate_datapoint(ours_schema, rng=np.random.default_rng(seed), list_size=list_size),
            jax_generate_datapoint(theirs_schema, rng=np.random.default_rng(seed),
                                   list_size=list_size))


def test_generate_datapoint_conforms_and_roundtrips():
    row = generate_datapoint(TestSchema, rng=np.random.default_rng(0))
    assert set(row) == set(TestSchema.fields)
    decoded = decode_row(encode_row(TestSchema, dict(row)), TestSchema)
    assert set(decoded) == set(row)
    assert decoded['matrix'].shape == (32, 16, 3)
    assert decoded['image_png'].dtype == np.uint8


def test_generate_datapoint_wildcard_dims_and_refusal():
    row = generate_datapoint(Unischema('S', [UnischemaField('v', np.float32, (None, 4))]),
                             list_size=5)
    assert row['v'].shape == (5, 4)
    assert generate_datapoint(Unischema('S', [UnischemaField('v', np.int32, (None,))]),
                              rng=np.random.default_rng(0))['v'].shape == (LIST_SIZE,)
    bad = Unischema('S', [UnischemaField('c', np.complex64, ())])
    with pytest.raises(TypeError, match='unsupported dtype') as ours:
        generate_datapoint(bad)
    with pytest.raises(TypeError) as theirs:
        jax_generate_datapoint(jax_unischema.Unischema(
            'S', [jax_unischema.UnischemaField('c', np.complex64, ())]))
    assert str(ours.value) == str(theirs.value)


# -- ReaderMock -----------------------------------------------------------------------

@pytest.mark.parametrize('batch_size', [None, 3])
def test_reader_mock_yields_the_jax_mocks_rows(batch_size):
    with ReaderMock(TestSchema, num_rows=4, batch_size=batch_size, seed=5) as ours, \
            JaxReaderMock(JaxTestSchema, num_rows=4, batch_size=batch_size, seed=5) as theirs:
        items, jax_items = list(ours), list(theirs)
        assert ours.batched_output == theirs.batched_output == (batch_size is not None)
        assert ours.last_row_consumed and theirs.last_row_consumed
    assert len(items) == len(jax_items) == 4
    for a, b in zip(items, jax_items):
        _assert_rows_equal(a._asdict(), b._asdict())


def test_schema_data_generator_example_is_generate_datapoint():
    _assert_rows_equal(schema_data_generator_example(TestSchema, rng=np.random.default_rng(2)),
                       generate_datapoint(TestSchema, rng=np.random.default_rng(2)))


def test_reader_mock_row_iteration():
    with ReaderMock(TestSchema, num_rows=7) as reader:
        rows = list(reader)
    assert len(rows) == 7
    assert not reader.batched_output
    assert rows[0].matrix.shape == (32, 16, 3)
    assert isinstance(rows[0].id, (int, np.integer))


def test_reader_mock_infinite_by_default():
    reader = ReaderMock(TestSchema)
    assert len([next(reader) for _ in range(3)]) == 3
    assert not reader.last_row_consumed
    reader.stop()
    reader.join()


def test_reader_mock_batched_output():
    schema = Unischema('S', [UnischemaField('id', np.int64, ()),
                             UnischemaField('x', np.float32, (3,))])
    with ReaderMock(schema, num_rows=4, batch_size=5) as reader:
        batches = list(reader)
    assert reader.batched_output
    assert len(batches) == 4
    assert batches[0].x.shape == (5, 3) and batches[0].id.shape == (5,)


def test_reader_mock_reset():
    reader = ReaderMock(TestSchema, num_rows=2)
    assert len(list(reader)) == 2
    reader.reset()
    assert not reader.last_row_consumed
    assert len(list(reader)) == 2


def test_reader_mock_custom_generator():
    schema = Unischema('S', [UnischemaField('id', np.int64, ())])
    with ReaderMock(schema, schema_data_generator=lambda s: {'id': 3}, num_rows=2) as reader:
        assert [r.id for r in reader] == [3, 3]


def test_reader_mock_rejects_ngram():
    with pytest.raises(ValueError, match='NGram'):
        ReaderMock(TestSchema, ngram=object())


def test_torch_loader_over_reader_mock():
    """The loader tested with no store under it."""
    schema = Unischema('S', [UnischemaField('id', np.int64, ()),
                             UnischemaField('x', np.float32, (4,))])
    with ReaderMock(schema, num_rows=10, seed=3) as reader:
        batches = list(TorchDataLoader(reader, batch_size=4, drop_last=True))
    assert len(batches) == 2
    assert batches[0]['x'].shape == (4, 4)
    assert isinstance(batches[0]['x'], np.ndarray)  # host batches, staged later
    # the mock's rows, in order
    with ReaderMock(schema, num_rows=8, seed=3) as reader:
        rows = list(reader)
    np.testing.assert_array_equal(batches[1]['x'], np.stack([r.x for r in rows[4:8]]))
    np.testing.assert_array_equal(batches[0]['id'], [r.id for r in rows[:4]])


def test_torch_loader_over_batched_reader_mock():
    schema = Unischema('S', [UnischemaField('x', np.float32, (2,))])
    with ReaderMock(schema, num_rows=6, batch_size=5, seed=3) as reader:
        batches = list(TorchDataLoader(reader, batch_size=10, drop_last=True))
    assert len(batches) == 3
    assert batches[0]['x'].shape == (10, 2)


# -- shuffling_analysis -----------------------------------------------------------------

def test_rank_correlation_equals_jax_on_the_same_streams():
    rng = np.random.default_rng(0)
    streams = [list(range(50)), list(range(50))[::-1], [3], [], rng.permutation(200),
               rng.integers(0, 10, size=64), np.concatenate([np.arange(20), rng.permutation(20)])]
    for ids in streams:
        assert shuffling_analysis.rank_correlation(ids) == jax_shuffling.rank_correlation(ids)
    assert shuffling_analysis.rank_correlation(list(range(50))) == pytest.approx(1.0)
    assert shuffling_analysis.rank_correlation(list(range(50))[::-1]) == pytest.approx(-1.0)


def test_compute_correlation_distribution_equals_jax():
    schema = Unischema('S', [UnischemaField('id', np.int64, ())])
    jax_schema = jax_unischema.Unischema('S', [jax_unischema.UnischemaField('id', np.int64, ())])
    seeds = iter(range(10))
    jax_seeds = iter(range(10))
    ours = shuffling_analysis.compute_correlation_distribution(
        lambda: ReaderMock(schema, num_rows=40, seed=next(seeds)), num_runs=4)
    theirs = jax_shuffling.compute_correlation_distribution(
        lambda: JaxReaderMock(jax_schema, num_rows=40, seed=next(jax_seeds)), num_runs=4)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (4,) and np.all((ours >= 0) & (ours <= 1))
