"""Port parity: ``petastorm_tpu_torch.torch_utils.DataLoader`` (the
reference's ``petastorm.pytorch`` API) against ``petastorm_tpu.torch_utils``
on the same stores: the same batches, exactly (keys, dtypes, values, order),
on the row path and the columnar block path, with and without a seeded
shuffle, with the partial final batch, the dtype promotions, a custom
``collate_fn`` and the refusals. Every reader is the dummy pool's (one
deterministic order) and closed through ``with``."""

import datetime
import threading
import time
from decimal import Decimal

import numpy as np
import pytest
import torch

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import torch_utils as jax_torch_utils
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import torch_utils
from petastorm_tpu_torch.ngram import NGram

PACKAGES = {'jax': (jax_make_reader, jax_make_batch_reader, jax_torch_utils),
            'torch': (make_reader, make_batch_reader, torch_utils)}


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch import observability as obs
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


def _row_count(rows):
    return len(rows)


#: (store fixture, factory, reader kwargs, loader kwargs)
CASES = {
    'rows': ('synthetic_dataset', 'reader', {'schema_fields': ['id', 'matrix', 'decimal']},
             {'batch_size': 30}),
    'rows_shuffled': ('synthetic_dataset', 'reader',
                      {'schema_fields': ['id', 'id2', 'matrix_uint16', 'python_primitive_uint8',
                                         'id_odd', 'id_float']},
                      {'batch_size': 10, 'shuffling_queue_capacity': 40, 'seed': 5}),
    'rows_min_after': ('synthetic_dataset', 'reader', {'schema_fields': ['id', 'image_png']},
                       {'batch_size': 7, 'shuffling_queue_capacity': 30,
                        'min_after_retrieve': 5, 'seed': 11}),
    'columnar': ('synthetic_dataset', 'reader',
                 {'output': 'columnar', 'schema_fields': ['id', 'matrix', 'decimal',
                                                          'matrix_uint16']},
                 {'batch_size': 20}),
    'columnar_shuffled': ('synthetic_dataset', 'reader',
                          {'output': 'columnar', 'schema_fields': ['id', 'compressed_matrix']},
                          {'batch_size': 16, 'shuffling_queue_capacity': 40, 'seed': 3}),
    'batch_reader': ('scalar_dataset', 'batch_reader',
                     {'schema_fields': ['id', 'float64', 'datetime', 'int_fixed_size_list']},
                     {'batch_size': 16}),
    'batch_reader_shuffled': ('scalar_dataset', 'batch_reader',
                              {'schema_fields': ['id', 'float64', 'datetime']},
                              {'batch_size': 16, 'shuffling_queue_capacity': 40, 'seed': 3}),
    # a custom collate keeps the row path, a batched reader's rows included
    'custom_collate': ('scalar_dataset', 'batch_reader', {'schema_fields': ['id']},
                       {'batch_size': 25, 'collate_fn': _row_count}),
    'custom_collate_shuffled': ('scalar_dataset', 'batch_reader',
                                {'schema_fields': ['id', 'float64']},
                                {'batch_size': 9, 'shuffling_queue_capacity': 20, 'seed': 2,
                                 'collate_fn': lambda rows: [r['id'] for r in rows]}),
}


def _batches(package, store, factory, reader_kwargs, loader_kwargs):
    make, make_batch, module = PACKAGES[package]
    opener = make if factory == 'reader' else make_batch
    with opener(store.url, reader_pool_type='dummy', shuffle_row_groups=False,
                **reader_kwargs) as reader:
        loader = module.DataLoader(reader, **loader_kwargs)
        return loader._columnar, list(loader)


def _assert_batch_equal(got, expected):
    if not isinstance(expected, dict):
        assert got == expected
        return
    assert list(got) == list(expected)
    for name in expected:
        assert isinstance(got[name], torch.Tensor), name
        assert got[name].dtype == expected[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), expected[name].numpy(), err_msg=name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_batches_equal_the_jax_adapter(case, request):
    fixture, factory, reader_kwargs, loader_kwargs = CASES[case]
    store = request.getfixturevalue(fixture)
    jax_columnar, expected = _batches('jax', store, factory, reader_kwargs, loader_kwargs)
    columnar, got = _batches('torch', store, factory, reader_kwargs, loader_kwargs)
    assert columnar == jax_columnar
    assert len(got) == len(expected) > 1
    for g, e in zip(got, expected):
        _assert_batch_equal(g, e)
    if 'collate_fn' not in loader_kwargs:
        sizes = [len(b['id']) for b in got]
        # every row once; only the last batch may be short
        assert sum(sizes) == 100 and set(sizes[:-1]) == {loader_kwargs['batch_size']}
        ids = torch.cat([b['id'] for b in got]).tolist()
        assert sorted(ids) == list(range(100))
        assert (ids != sorted(ids)) == ('seed' in loader_kwargs)


def test_row_sanitizer_matches_jax():
    row = {'u16': np.arange(3, dtype=np.uint16), 'u32': np.arange(3, dtype=np.uint32),
           'u64': np.arange(3, dtype=np.uint64), 's16': np.uint16(7), 's32': np.uint32(8),
           's64': np.uint64(9), 'u8': np.arange(2, dtype=np.uint8), 'dec': Decimal('1.25'),
           'ts': np.datetime64(datetime.datetime(2021, 3, 4, 5, 6, 7)), 'f': 0.5, 'i': 3}
    expected = jax_torch_utils._sanitize_torch_types(row)
    got = torch_utils._sanitize_torch_types(row)
    assert list(got) == list(expected)
    for name in row:
        assert type(got[name]) is type(expected[name]), name
        assert np.asarray(got[name]).dtype == np.asarray(expected[name]).dtype, name
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(expected[name]))
    for value in (np.array(['a', 'b']), np.array([b'x']), np.array([None, 1], dtype=object)):
        with pytest.raises(TypeError) as jax_info:
            jax_torch_utils._sanitize_torch_types({'s': value})
        with pytest.raises(TypeError) as info:
            torch_utils._sanitize_torch_types({'s': value})
        assert str(info.value) == str(jax_info.value)


def test_collates_match_jax():
    rows = [{'a': np.arange(2, dtype=np.int64) + i, 'd': Decimal(i) / 4, 'x': float(i)}
            for i in range(3)]
    expected = jax_torch_utils.decimal_friendly_collate(rows)
    _assert_batch_equal(torch_utils.decimal_friendly_collate(rows), expected)
    columns = {'u16': np.arange(4, dtype=np.uint16), 'f': np.ones((4, 2), np.float32),
               'ts': np.array(['2020-01-01', '2020-01-02', 'NaT', '2021-05-05'],
                              dtype='datetime64[us]'),
               'dec': np.array([Decimal('1.5'), Decimal('2'), Decimal('0'), Decimal('-1')],
                               dtype=object)}
    _assert_batch_equal(torch_utils._collate_columns_to_torch(columns),
                        jax_torch_utils._collate_columns_to_torch(columns))
    for bad in (np.array(['a', 'b']), np.array([None, Decimal(1)], dtype=object)):
        with pytest.raises(TypeError) as jax_info:
            jax_torch_utils._collate_columns_to_torch({'s': bad})
        with pytest.raises(TypeError) as info:
            torch_utils._collate_columns_to_torch({'s': bad})
        assert str(info.value) == str(jax_info.value)
    col = np.arange(6, dtype=np.int64)
    col.setflags(write=False)
    out = torch_utils._collate_columns_to_torch({'x': col})
    out['x'][0] = 99  # writable: a copy was made, the source is untouched
    assert col[0] == 0


def test_string_field_refused_like_jax(synthetic_dataset):
    messages = []
    for package in ('jax', 'torch'):
        make, _, module = PACKAGES[package]
        with make(synthetic_dataset.url, reader_pool_type='dummy',
                  schema_fields=['id', 'sensor_name'], shuffle_row_groups=False) as reader:
            with pytest.raises(TypeError) as info:
                next(iter(module.DataLoader(reader, batch_size=4)))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_columnar_ngram_reader_refused(synthetic_dataset):
    fields = {0: ['id', 'id2'], 1: ['id', 'id2']}
    for package, ngram_cls in (('jax', JaxNGram), ('torch', NGram)):
        make, _, module = PACKAGES[package]
        ngram = ngram_cls(fields, delta_threshold=1, timestamp_field='id')
        with make(synthetic_dataset.url, reader_pool_type='dummy', output='columnar',
                  ngram=ngram) as reader:
            with pytest.raises(ValueError, match='columnar NGram'):
                module.DataLoader(reader, batch_size=4)
    # a row NGram reader's windows are rows: accepted, as in JAX
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                     ngram=NGram(fields, delta_threshold=1, timestamp_field='id')) as reader:
        torch_utils.DataLoader(reader, batch_size=4)


def test_context_manager_stops_and_joins_the_reader(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, reader_pool_type='thread', workers_count=2,
                         schema_fields=['id'])
    calls = []
    for name in ('stop', 'join'):
        method = getattr(reader, name)
        setattr(reader, name, lambda name=name, method=method: (calls.append(name), method()))
    with torch_utils.DataLoader(reader, batch_size=8) as loader:
        first = next(iter(loader))
    assert first['id'].shape == (8,)
    # the module fixture then finds none of the pool's threads left
    assert calls == ['stop', 'join']
