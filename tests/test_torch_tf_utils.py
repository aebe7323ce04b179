"""The TensorFlow adapter of the port against the JAX package's: the same
store through each package's reader and ``make_petastorm_dataset`` gives the
same TF tensors (rows, column batches, NGram windows, the promotions, the
seeded shuffle), and ``make_tf_dataset_context`` the same fixed-size
batches. TensorFlow runs on the CPU here; the card's host has none."""

import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import observability as jax_obs
from petastorm_tpu import tf_utils as jax_tf_utils
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch import tf_utils

tf = pytest.importorskip('tensorflow')


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch.observability import blackbox

    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    if armed[0] is None:
        jax_blackbox.disable()
    if armed[1] is None:
        blackbox.disable()
    for module in (jax_obs, obs):
        module.get_registry().reset()
        module.get_ring().clear()
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


PACKAGES = {
    'torch': (make_reader, make_batch_reader, tf_utils),
    'jax': (jax_make_reader, jax_make_batch_reader, jax_tf_utils),
}


def _elements(pkg, url, batched=False, take=None, dataset_kwargs=None, **reader_kwargs):
    """The dataset's elements as numpy: a list of dicts of field -> value
    (NGram windows: offset -> field -> value)."""
    factory = PACKAGES[pkg][1 if batched else 0]
    reader_kwargs.setdefault('reader_pool_type', 'dummy')
    reader_kwargs.setdefault('shuffle_row_groups', False)
    with factory(url, **reader_kwargs) as reader:
        dataset = PACKAGES[pkg][2].make_petastorm_dataset(reader, **(dataset_kwargs or {}))
        if take is not None:
            dataset = dataset.take(take)
        out = []
        for element in dataset:
            if isinstance(element, dict):
                out.append({off: {k: (v.dtype, v.numpy()) for k, v in nt._asdict().items()}
                            for off, nt in element.items()})
            else:
                out.append({k: (v.dtype, v.numpy()) for k, v in element._asdict().items()})
        return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                _assert_same([x[k]], [y[k]])
                continue
            assert x[k][0] == y[k][0], k
            np.testing.assert_array_equal(x[k][1], y[k][1], err_msg=str(k))


def test_rows_match_jax(synthetic_dataset):
    rows = _elements('torch', synthetic_dataset.url, take=5, schema_fields=['id', 'matrix'])
    _assert_same(rows, _elements('jax', synthetic_dataset.url, take=5,
                                 schema_fields=['id', 'matrix']))
    assert len(rows) == 5 and rows[0]['matrix'][1].shape == (32, 16, 3)
    assert int(rows[0]['id'][1]) == 0


def test_batched_reader_matches_jax(scalar_dataset):
    blocks = _elements('torch', scalar_dataset.url, batched=True,
                       schema_fields=['id', 'float64'])
    _assert_same(blocks, _elements('jax', scalar_dataset.url, batched=True,
                                   schema_fields=['id', 'float64']))
    assert blocks[0]['id'][1].shape[0] == 10  # a row group


def test_promotions_match_jax(synthetic_dataset):
    # uint16 -> int32, Decimal -> string
    fields = ['id', 'matrix_uint16', 'decimal']
    rows = _elements('torch', synthetic_dataset.url, take=10, schema_fields=fields)
    _assert_same(rows, _elements('jax', synthetic_dataset.url, take=10, schema_fields=fields))
    assert rows[0]['matrix_uint16'][0] == tf.int32
    assert rows[0]['decimal'][0] == tf.string
    assert rows[0]['decimal'][1].decode().startswith('0.')


@pytest.mark.parametrize('offsets', ['ids', 'image'])
def test_ngram_windows_match_jax(synthetic_dataset, offsets):
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu_torch.ngram import NGram

    fields = {'ids': {0: ['id', 'id2'], 1: ['id']}, 'image': {0: ['id', 'image_png'], 1: ['id']}}
    windows = {}
    for pkg, cls in (('torch', NGram), ('jax', JaxNGram)):
        ngram = cls(fields[offsets], delta_threshold=1, timestamp_field='id')
        windows[pkg] = _elements(pkg, synthetic_dataset.url, take=8, ngram=ngram)
    _assert_same(windows['torch'], windows['jax'])
    assert sorted(windows['torch'][0]) == [0, 1]
    for w in windows['torch']:
        assert int(w[1]['id'][1]) == int(w[0]['id'][1]) + 1
    if offsets == 'image':
        expected = {r['id']: r for r in synthetic_dataset.data}
        w = windows['torch'][0]
        np.testing.assert_array_equal(w[0]['image_png'][1],
                                      expected[int(w[0]['id'][1])]['image_png'])


@pytest.mark.parametrize('seed', [3, 11])
def test_seeded_shuffle_matches_jax(synthetic_dataset, seed):
    kwargs = {'schema_fields': ['id'], 'dataset_kwargs': {'shuffle_buffer_size': 40,
                                                          'seed': seed}}
    ids = [int(r['id'][1]) for r in _elements('torch', synthetic_dataset.url, **kwargs)]
    assert ids == [int(r['id'][1]) for r in _elements('jax', synthetic_dataset.url, **kwargs)]
    assert sorted(ids) == list(range(100)) and ids != sorted(ids)
    assert ids == [int(r['id'][1]) for r in _elements('torch', synthetic_dataset.url, **kwargs)]


def test_a_one_slot_shuffle_passes_rows_through(synthetic_dataset):
    kwargs = {'schema_fields': ['id'], 'dataset_kwargs': {'shuffle_buffer_size': 1}}
    assert [int(r['id'][1]) for r in _elements('torch', synthetic_dataset.url, **kwargs)] == \
        list(range(100))


def test_tf1_session_recipe(synthetic_dataset):
    """``tf.compat.v1`` sessions pull rows through a one-shot iterator over
    the dataset, with the shuffle the reference's queue gave."""
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                     schema_fields=['id', 'matrix'], shuffle_row_groups=False,
                     num_epochs=1) as reader:
        with tf.Graph().as_default():
            ds = tf_utils.make_petastorm_dataset(reader, shuffle_buffer_size=20, seed=3)
            readout = tf.compat.v1.data.make_one_shot_iterator(ds).get_next()
            ids = []
            with tf.compat.v1.Session() as sess:
                while True:
                    try:
                        row = sess.run(readout)
                    except tf.errors.OutOfRangeError:
                        break
                    ids.append(int(row.id))
                    assert row.matrix.shape == (32, 16, 3)
    assert sorted(ids) == list(range(100)) and ids != sorted(ids)


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_refusals(synthetic_dataset, scalar_dataset, pkg):
    make, make_batch, module = PACKAGES[pkg]
    with make_batch(scalar_dataset.url, reader_pool_type='dummy', schema_fields=['id'],
                    shuffle_row_groups=False) as reader:
        with pytest.raises(ValueError, match='batched reader'):
            module.make_petastorm_dataset(reader, shuffle_buffer_size=10)
    ngram_cls = (__import__('petastorm_tpu_torch.ngram', fromlist=['NGram']).NGram
                 if pkg == 'torch' else __import__('petastorm_tpu.ngram', fromlist=['NGram']).NGram)
    ngram = ngram_cls({0: ['id'], 1: ['id']}, delta_threshold=1, timestamp_field='id')
    with make(synthetic_dataset.url, reader_pool_type='dummy', output='columnar',
              ngram=ngram) as reader:
        with pytest.raises(ValueError, match='columnar NGram'):
            module.make_petastorm_dataset(reader)


@pytest.mark.parametrize('value,expected', [
    (np.uint16(7), np.int32(7)), (np.uint32(7), np.int64(7)),
    (np.arange(3, dtype=np.uint16), np.arange(3, dtype=np.int32)),
    (np.arange(3, dtype=np.uint32), np.arange(3, dtype=np.int64)),
    (np.datetime64('2020-01-01T00:00:01'), np.int64(1577836801000000000)),
    (np.array(['2020-01-01'], dtype='datetime64[D]'), np.array([1577836800000000000]))])
def test_sanitize_matches_jax(value, expected):
    out = tf_utils._sanitize_field_value(value)
    jax_out = jax_tf_utils._sanitize_field_value(value)
    assert np.asarray(out).dtype == np.asarray(jax_out).dtype == np.asarray(expected).dtype
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(out, jax_out)


def test_sanitize_decimals_match_jax():
    from decimal import Decimal
    assert tf_utils._sanitize_field_value(Decimal('1.5')) == '1.5'
    cells = np.array([Decimal('1.5'), Decimal('2')], dtype=object)
    np.testing.assert_array_equal(tf_utils._sanitize_field_value(cells),
                                  jax_tf_utils._sanitize_field_value(cells))


def _context_batches(pkg, url):
    _, make_batch, module = PACKAGES[pkg]
    reader = make_batch(url, reader_pool_type='dummy', schema_fields=['id', 'float64'],
                        shuffle_row_groups=False, num_epochs=1)
    with module.make_tf_dataset_context(reader, batch_size=16, prefetch=0) as dataset:
        return [{k: v.numpy() for k, v in b._asdict().items()} for b in dataset]


def test_dataset_context_matches_jax(scalar_dataset):
    batches = _context_batches('torch', scalar_dataset.url)
    jax_batches = _context_batches('jax', scalar_dataset.url)
    assert [len(b['id']) for b in batches] == [16] * 6 + [4]
    for a, b in zip(batches, jax_batches):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert len(batches) == len(jax_batches)


def test_dataset_context_stops_the_reader_when_it_cannot_start(synthetic_dataset):
    from petastorm_tpu_torch.ngram import NGram

    ngram = NGram({0: ['id'], 1: ['id']}, delta_threshold=1, timestamp_field='id')
    reader = make_reader(synthetic_dataset.url, reader_pool_type='dummy', output='columnar',
                         ngram=ngram)
    with pytest.raises(ValueError):
        with tf_utils.make_tf_dataset_context(reader):
            pass
    assert reader._stopped  # __exit__ never ran: __enter__ stopped it
