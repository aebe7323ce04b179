"""Ragged collation, bucketing and packing of the port against the JAX
package, on the same seeded rows and the same store: padded lengths, padded
arrays, length vectors, waste, bucket order, bins, packed slots and the
loaders' batches are compared exactly."""

import pickle
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.sequence import bucket as jax_bucket
from petastorm_tpu.sequence import collate as jax_collate
from petastorm_tpu.sequence import packing as jax_packing
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.sequence import (BucketBatchBuffer, CollateSpec, PackedSequenceLoader,
                                          PadSpec, collate_ragged_rows, first_fit_decreasing,
                                          pack_rows, padded_length, padding_waste_fraction)
from petastorm_tpu_torch.torch import TorchDataLoader, collate_rows


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
    # every reader was closed: none of their threads is left running
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


ROWS = 120
ROWS_PER_GROUP = 12
MAX_LEN = 64
BUCKETS = (4, 8, 16, 64)


def _token_rows(num_rows=ROWS, seed=7, max_len=MAX_LEN):
    """Zipf-like lengths: mostly short rows, a heavy tail."""
    rng = np.random.default_rng(seed)
    return [{'id': np.int64(i),
             'tokens': rng.integers(0, 1000, int(min(rng.zipf(1.6), max_len)), dtype=np.int32)}
            for i in range(num_rows)]


@pytest.fixture(scope='module')
def token_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('tokens'))
    schema = JaxUnischema('TokenSchema', [
        JaxUnischemaField('id', np.int64, (), JaxScalarCodec(), False),
        JaxUnischemaField('tokens', np.int32, (None,), JaxNdarrayCodec(), False)])
    rows = _token_rows()
    with jax_materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_GROUP) as writer:
        for row in rows:
            writer.write(row)
    return url, rows


def _readers(url, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('seed', 3)
    return jax_make_reader(url, **kwargs), make_reader(url, **kwargs)


def _jax_spec(spec):
    return jax_collate.CollateSpec(
        {name: jax_collate.PadSpec(pad_to=p.pad_to, buckets=p.buckets, max_length=p.max_length,
                                   pad_value=p.pad_value, emit_lengths=p.emit_lengths)
         for name, p in spec.pads.items()}, length_of=spec.length_of)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# -- padded_length / collate_ragged_rows --------------------------------------

@pytest.mark.parametrize('length,kwargs,expected', [
    (5, {'pad_to': 8}, 8), (8, {'pad_to': 8}, 8), (9, {'pad_to': 8}, 16),
    (3, {'buckets': BUCKETS}, 4), (17, {'buckets': BUCKETS}, 64), (65, {'buckets': BUCKETS}, 65),
    (100, {'pad_to': 8, 'max_length': 32}, 32), (0, {'pad_to': 1}, 1),
    (70, {'buckets': (4, 8), 'pad_to': 16}, 80), (7, {}, 7)])
def test_padded_length_matches_jax(length, kwargs, expected):
    assert padded_length(length, PadSpec(**kwargs)) == expected
    assert jax_collate.padded_length(length, jax_collate.PadSpec(**kwargs)) == expected


@pytest.mark.parametrize('pad', [
    {'pad_to': 16}, {'pad_to': 4, 'pad_value': -1}, {'buckets': BUCKETS},
    {'pad_to': 1, 'max_length': 5}, {'pad_to': 8, 'emit_lengths': False}])
def test_collate_ragged_rows_matches_jax(pad):
    rows = _token_rows(32, seed=11)
    spec = CollateSpec({'tokens': PadSpec(**pad)})
    stats, jax_stats = {}, {}
    for start in range(0, 32, 8):
        batch = collate_ragged_rows(rows[start:start + 8], spec, stats)
        jax_batch = jax_collate.collate_ragged_rows(rows[start:start + 8], _jax_spec(spec),
                                                    jax_stats)
        _assert_batches_equal(batch, jax_batch)
        assert ('tokens_lengths' in batch) == pad.get('emit_lengths', True)
    assert stats == jax_stats
    assert padding_waste_fraction(stats) == jax_collate.padding_waste_fraction(jax_stats)
    assert 0.0 < padding_waste_fraction(stats) < 1.0
    assert padding_waste_fraction({}) == jax_collate.padding_waste_fraction({}) == 0.0


def test_collate_ragged_rows_pads_and_truncates():
    rows = [{'id': i, 'tokens': np.arange(n, dtype=np.int32)} for i, n in enumerate([3, 5, 2])]
    stats = {'real_tokens': 0, 'padded_tokens': 0}
    batch = collate_ragged_rows(rows, CollateSpec({'tokens': PadSpec(pad_to=4, pad_value=-1)}),
                                stats)
    assert batch['tokens'].shape == (3, 8)
    assert list(batch['tokens_lengths']) == [3, 5, 2]
    np.testing.assert_array_equal(batch['tokens'][0], [0, 1, 2, -1, -1, -1, -1, -1])
    assert stats == {'real_tokens': 10, 'padded_tokens': 24}
    batch = collate_ragged_rows(rows, CollateSpec({'tokens': PadSpec(max_length=4)}))
    assert batch['tokens'].shape == (3, 4) and list(batch['tokens_lengths']) == [3, 4, 2]


@pytest.mark.parametrize('case', ['trailing', 'object', 'unknown', 'empty'])
def test_collate_ragged_rows_errors_match_jax(case):
    spec = {'tokens': PadSpec()}
    rows = {'trailing': [{'tokens': np.zeros((2, 3))}, {'tokens': np.zeros((2, 4))}],
            'object': [{'tokens': np.array(['a', None], dtype=object)}],
            'unknown': [{'other': np.zeros(2)}],
            'empty': []}[case]
    with pytest.raises(PetastormTpuError):
        collate_ragged_rows(rows, CollateSpec(spec))
    with pytest.raises(Exception) as jax_error:
        jax_collate.collate_ragged_rows(rows, _jax_spec(CollateSpec(spec)))
    assert type(jax_error.value).__name__ == 'PetastormTpuError'


def test_specs_reject_bad_arguments():
    for kwargs in ({'pad_to': 0}, {'buckets': ()}, {'buckets': (0, 4)}, {'max_length': 0}):
        with pytest.raises(ValueError):
            PadSpec(**kwargs)
        with pytest.raises(ValueError):
            jax_collate.PadSpec(**kwargs)
    with pytest.raises(ValueError, match='non-empty'):
        CollateSpec({})
    with pytest.raises(ValueError, match='PadSpec'):
        CollateSpec({'tokens': 8})
    with pytest.raises(ValueError, match='not a padded field'):
        CollateSpec({'tokens': PadSpec()}, length_of='other')


def test_collate_rows_error_points_at_collate_spec():
    with pytest.raises(PetastormTpuError, match='collate_spec=CollateSpec'):
        collate_rows([{'tokens': np.arange(3)}, {'tokens': np.arange(5)}])


# -- BucketBatchBuffer ----------------------------------------------------------

@pytest.mark.parametrize('seed', [None, 0, 5])
def test_bucket_buffer_order_matches_jax(seed):
    rows = _token_rows(90, seed=13)
    ours = BucketBatchBuffer(BUCKETS, 4, 'tokens', seed=seed)
    theirs = jax_bucket.BucketBatchBuffer(BUCKETS, 4, 'tokens', seed=seed)
    out, jax_out = [], []
    for start in range(0, 90, 15):
        ours.add_many(rows[start:start + 15])
        theirs.add_many(rows[start:start + 15])
        assert [int(r['id']) for r in ours._items] == [int(r['id']) for r in theirs._items]
        assert ours.rng_state == theirs.rng_state
        while ours.can_retrieve():
            out.append(int(ours.retrieve()['id']))
        while theirs.can_retrieve():
            jax_out.append(int(theirs.retrieve()['id']))
    ours.finish()
    theirs.finish()
    while ours.can_retrieve():
        out.append(int(ours.retrieve()['id']))
    while theirs.can_retrieve():
        jax_out.append(int(theirs.retrieve()['id']))
    assert out == jax_out
    assert sorted(out) == list(range(90)) and ours.size == 0


def test_bucket_buffer_rng_state_resumes_and_rejects_bad_args():
    # a checkpoint keeps the rows and the RNG state; a resume re-buckets the
    # rows, and the seeded stream goes on, the same in both packages
    rows = _token_rows(40, seed=17)
    drained = []
    for cls in (BucketBatchBuffer, jax_bucket.BucketBatchBuffer):
        first = cls(BUCKETS, 4, 'tokens', seed=9)
        first.add_many(rows[:20])
        first.retrieve()
        resumed = cls(BUCKETS, 4, lambda r: len(r['tokens']))
        resumed.rng_state = first.rng_state
        resumed.add_many(first._items)
        resumed.add_many(rows[20:])
        resumed.finish()
        out = []
        while resumed.can_retrieve():
            out.append(int(resumed.retrieve()['id']))
        drained.append((out, resumed.rng_state))
    assert drained[0] == drained[1] and len(drained[0][0]) == 39
    with pytest.raises(ValueError):
        BucketBatchBuffer((), 4, 'tokens')
    with pytest.raises(ValueError):
        BucketBatchBuffer((4, 8), 0, 'tokens')
    with pytest.raises(RuntimeError, match='no retrievable'):
        BucketBatchBuffer((4,), 4, 'tokens').retrieve()


# -- packing ----------------------------------------------------------------------

@pytest.mark.parametrize('capacity', [64, 100])
def test_first_fit_decreasing_matches_jax(capacity):
    lengths = [len(r['tokens']) for r in _token_rows(200, seed=19)]
    bins = first_fit_decreasing(lengths, capacity)
    assert bins == jax_packing.first_fit_decreasing(lengths, capacity)
    assert sorted(i for b in bins for i in b) == list(range(200))
    assert all(sum(lengths[i] for i in b) <= capacity for b in bins)
    with pytest.raises(PetastormTpuError, match='exceeds tokens_per_batch'):
        first_fit_decreasing([capacity + 1], capacity)


def test_pack_rows_matches_jax():
    rows = _token_rows(50, seed=23)
    batch, stats = pack_rows(rows, 64, ['tokens'], pad_value=-7)
    jax_batch, jax_stats = jax_packing.pack_rows(rows, 64, ['tokens'], pad_value=-7)
    _assert_batches_equal(batch, jax_batch)
    assert stats == jax_stats
    # a slot's segments: 1-based ids, positions restarting per segment
    rows = [{'tokens': np.arange(n, dtype=np.int32) + 10 * n} for n in (5, 3, 4)]
    batch, stats = pack_rows(rows, tokens_per_batch=8, sequence_fields=['tokens'])
    np.testing.assert_array_equal(batch['segment_ids'][0], [1, 1, 1, 1, 1, 2, 2, 2])
    np.testing.assert_array_equal(batch['positions'][0], [0, 1, 2, 3, 4, 0, 1, 2])
    assert batch['num_segments'].tolist() == [2, 1] and stats['packing_efficiency'] == 0.75


def _packed(reader_pair, **kwargs):
    out = []
    for reader, cls in zip(reader_pair, (jax_packing.PackedSequenceLoader, PackedSequenceLoader)):
        with reader:
            loader = cls(reader, tokens_per_batch=64, sequence_fields=['tokens'], **kwargs)
            out.append(([dict(b) for b in loader], loader.packing_efficiency,
                        {k: v for k, v in loader.diagnostics.items() if k.startswith('packed')}))
    return out


@pytest.mark.parametrize('output', ['rows', 'columnar'])
def test_packed_sequence_loader_matches_jax(token_store, output):
    url, rows = token_store
    (jax_batches, jax_eff, jax_diag), (batches, eff, diag) = _packed(
        _readers(url, output=output), slots_per_batch=4, pool_rows=32)
    assert len(batches) == len(jax_batches) > 1
    for a, b in zip(batches, jax_batches):
        _assert_batches_equal(a, b)
    assert eff == jax_eff and diag == jax_diag
    assert diag['packed_real_tokens'] == sum(len(r['tokens']) for r in rows)
    assert sum(int((b['segment_ids'] > 0).sum()) for b in batches) == diag['packed_real_tokens']


def test_packed_sequence_loader_checkpoint_matches_jax(token_store):
    url, _ = token_store
    states = []
    for reader, cls in zip(_readers(url), (jax_packing.PackedSequenceLoader,
                                           PackedSequenceLoader)):
        with reader:
            loader = cls(reader, tokens_per_batch=64, sequence_fields=['tokens'],
                         slots_per_batch=2, pool_rows=16)
            it = iter(loader)
            next(it)
            states.append(pickle.loads(pickle.dumps(loader.state_dict())))
    jax_state, state = states
    assert state['version'] == jax_state['version'] == 1
    assert [int(r['id']) for r in state['rows']] == [int(r['id']) for r in jax_state['rows']]
    resumed = []
    for reader, cls in zip(_readers(url, resume_state=state['reader']),
                           (jax_packing.PackedSequenceLoader, PackedSequenceLoader)):
        with reader:
            loader = cls(reader, tokens_per_batch=64, sequence_fields=['tokens'],
                         slots_per_batch=2, pool_rows=16, resume_state=state)
            resumed.append([dict(b) for b in loader])
    assert len(resumed[0]) == len(resumed[1]) > 0
    for a, b in zip(*resumed):
        _assert_batches_equal(a, b)


# -- the loaders ------------------------------------------------------------------

def _loader_batches(url, limit=None, **loader_kwargs):
    out = []
    for reader, cls in zip(_readers(url), (JaxDataLoader, TorchDataLoader)):
        kwargs = dict(loader_kwargs)
        if 'collate_spec' in kwargs and cls is JaxDataLoader:
            kwargs['collate_spec'] = _jax_spec(kwargs['collate_spec'])
        with reader:
            loader = cls(reader, batch_size=10, drop_last=False, **kwargs)
            batches = []
            for batch in loader:
                batches.append(batch)
                if limit is not None and len(batches) == limit:
                    break
            out.append((batches, loader))
    return out


@pytest.mark.parametrize('loader_kwargs', [
    {'collate_spec': CollateSpec({'tokens': PadSpec(pad_to=8)})},
    {'collate_spec': CollateSpec({'tokens': PadSpec(pad_to=8)}), 'shuffling_queue_capacity': 30,
     'seed': 4},
    {'collate_spec': CollateSpec({'tokens': PadSpec(buckets=BUCKETS)}),
     'bucket_boundaries': BUCKETS, 'seed': 21},
    {'collate_spec': CollateSpec({'tokens': PadSpec(buckets=BUCKETS)}),
     'bucket_boundaries': BUCKETS}], ids=['pad', 'shuffled', 'bucketed', 'bucketed_fifo'])
def test_loader_ragged_batches_match_jax(token_store, loader_kwargs):
    url, rows = token_store
    (jax_batches, jax_loader), (batches, loader) = _loader_batches(url, **loader_kwargs)
    assert len(batches) == len(jax_batches)
    for a, b in zip(batches, jax_batches):
        _assert_batches_equal(a, b)
    by_id = {int(r['id']): r['tokens'] for r in rows}
    assert sorted(int(i) for b in batches for i in b['id']) == sorted(by_id)
    for b in batches:
        for row_id, n, padded in zip(b['id'], b['tokens_lengths'], b['tokens']):
            np.testing.assert_array_equal(padded[:n], by_id[int(row_id)])
            assert not padded[n:].any()
    waste = loader.diagnostics['padding_waste_fraction']
    assert waste == jax_loader.diagnostics['padding_waste_fraction'] and 0.0 < waste < 1.0


def test_bucketing_cuts_padding_waste(token_store):
    url, _ = token_store
    (_, padded), = _loader_batches(url, collate_spec=CollateSpec(
        {'tokens': PadSpec(buckets=BUCKETS)}))[1:]
    (_, bucketed), = _loader_batches(url, collate_spec=CollateSpec(
        {'tokens': PadSpec(buckets=BUCKETS)}), bucket_boundaries=BUCKETS, seed=1)[1:]
    assert (bucketed.diagnostics['padding_waste_fraction']
            < padded.diagnostics['padding_waste_fraction'])


def test_bucketed_checkpoint_resume_matches_jax(token_store):
    url, rows = token_store
    spec = CollateSpec({'tokens': PadSpec(buckets=BUCKETS)})
    kwargs = {'batch_size': 5, 'drop_last': False, 'seed': 33, 'bucket_boundaries': BUCKETS}
    heads, states = [], []
    for reader, cls in zip(_readers(url, seed=33), (JaxDataLoader, TorchDataLoader)):
        with reader:
            loader = cls(reader, collate_spec=spec if cls is TorchDataLoader else _jax_spec(spec),
                         **kwargs)
            it = iter(loader)
            heads.append([int(i) for _ in range(4) for i in next(it)['id']])
            states.append(pickle.loads(pickle.dumps(loader.state_dict())))
    assert heads[0] == heads[1]
    assert states[0]['buffer_rng'] == states[1]['buffer_rng']
    assert ([int(r['id']) for r in states[0]['rows']]
            == [int(r['id']) for r in states[1]['rows']])
    # each package resumes its own state and the other's: one stream
    tails = []
    for state in states:
        for reader, cls in zip(_readers(url, seed=33, resume_state=state['reader']),
                               (JaxDataLoader, TorchDataLoader)):
            with reader:
                loader = cls(reader, resume_state=state, collate_spec=(
                    spec if cls is TorchDataLoader else _jax_spec(spec)), **kwargs)
                tails.append([int(i) for b in loader for i in b['id']])
    # the JAX loader ignores the port state's reader_yielded: three resumes
    # with the JAX package's semantics
    assert tails[0] == tails[1] == tails[2]
    combined = heads[1] + tails[1]
    assert set(combined) == {int(r['id']) for r in rows}
    # rows read twice come only from row groups in flight at the checkpoint
    assert len(combined) - len(set(combined)) <= 2 * ROWS_PER_GROUP
    # the port's resume of its own state skips the rows of the partly read
    # row group it already held: every row once
    exact = heads[1] + tails[3]
    assert sorted(exact) == sorted(int(r['id']) for r in rows)


def test_loader_collate_arguments_are_checked(token_store):
    url, _ = token_store
    spec = CollateSpec({'tokens': PadSpec(pad_to=8)})
    with make_reader(url, reader_pool_type='dummy', output='columnar') as reader:
        with pytest.raises(ValueError, match='row-oriented'):
            TorchDataLoader(reader, batch_size=10, collate_spec=spec)
    with make_reader(url, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='requires collate_spec'):
            TorchDataLoader(reader, batch_size=10, bucket_boundaries=(8, 32))
        with pytest.raises(ValueError, match='shuffling buffer'):
            TorchDataLoader(reader, batch_size=10, shuffling_queue_capacity=20,
                            collate_spec=spec, bucket_boundaries=(8, 32))
        loader = TorchDataLoader(reader, batch_size=10)
        assert loader.diagnostics['padding_waste_fraction'] == 0.0
