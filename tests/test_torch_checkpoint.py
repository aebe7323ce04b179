"""Port parity: reader and loader checkpoint/resume of petastorm_tpu_torch
against the JAX package, case for case with ``tests/test_checkpoint.py``.

Where a run is deterministic (the dummy pool, a seed) the port's id stream
and its state dicts must equal the JAX package's exactly; where a pool's
threads or processes reorder items, the tests hold the port to the contract
the JAX tests define (no row lost, only in-flight row groups read again).
A state taken by either package resumes the other's reader and loader, and
gives the same remaining rows as the JAX resume."""

import pickle
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import merge_resume_states as jax_merge_resume_states
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu_torch import make_batch_reader, make_reader, merge_resume_states
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.workers import ProcessPoolOptions


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


PACKAGES = {
    'jax': (jax_make_reader, jax_make_batch_reader, JaxDataLoader, jax_in_lambda),
    'torch': (make_reader, make_batch_reader, TorchDataLoader, in_lambda),
}


def _read_ids(reader, limit=None):
    ids = []
    for row in reader:
        ids.append(int(row.id))
        if limit is not None and len(ids) >= limit:
            break
    return ids


def _read_batch_ids(reader, limit_batches=None):
    ids = []
    n = 0
    for batch in reader:
        ids.extend(int(i) for i in batch.id)
        n += 1
        if limit_batches is not None and n >= limit_batches:
            break
    return ids


def _checkpointed_ids(factory, url, limit, read=_read_ids, **kwargs):
    """Read ``limit`` ids (rows or batches), take the state, stop; then the
    rest through a reader resumed from the pickled state."""
    reader = factory(url, **kwargs)
    first = read(reader, limit)
    state = pickle.loads(pickle.dumps(reader.state_dict()))
    reader.stop()
    reader.join()
    resumed = factory(url, resume_state=state, **kwargs)
    rest = read(resumed)
    resumed.stop()
    resumed.join()
    return first, rest, state


def _both_exact(factory_index, url, limit, read=_read_ids, **kwargs):
    """The checkpointed stream through each package; the port's ids and
    state must equal the JAX package's."""
    (j_first, j_rest, j_state), (t_first, t_rest, t_state) = [
        _checkpointed_ids(PACKAGES[name][factory_index], url, limit, read, **kwargs)
        for name in ('jax', 'torch')]
    assert (t_first, t_rest) == (j_first, j_rest)
    assert t_state == j_state
    return t_first, t_rest


@pytest.mark.parametrize('pool', ['thread', 'process'])
def test_row_reader_resume_covers_all_rows(synthetic_dataset, pool):
    workers = {'thread': 3, 'process': 2}[pool]
    first, rest, _ = _checkpointed_ids(make_reader, synthetic_dataset.url, 33,
                                       schema_fields=['id'], reader_pool_type=pool,
                                       workers_count=workers, seed=11)
    all_ids = {r['id'] for r in synthetic_dataset.data}
    assert set(first) | set(rest) == all_ids, 'checkpoint/resume lost rows'
    assert all((first + rest).count(i) <= 2 for i in all_ids)


def test_row_reader_exact_resume_at_group_boundary(synthetic_dataset):
    kwargs = dict(schema_fields=['id'], reader_pool_type='dummy', seed=5, num_epochs=2)
    expected = _read_ids(jax_make_reader(synthetic_dataset.url, **kwargs))
    first, rest = _both_exact(0, synthetic_dataset.url, 30, **kwargs)
    assert first + rest == expected


def test_row_reader_exact_resume_at_epoch_boundary(synthetic_dataset):
    kwargs = dict(schema_fields=['id'], reader_pool_type='dummy', seed=7, num_epochs=3)
    expected = _read_ids(make_reader(synthetic_dataset.url, **kwargs))
    assert len(expected) == 300
    first, rest = _both_exact(0, synthetic_dataset.url, 100, **kwargs)
    assert first + rest == expected
    assert rest[:100] != first or rest[100:200] != first


def test_mid_group_checkpoint_rereads_partial_group_only(synthetic_dataset):
    first, rest = _both_exact(0, synthetic_dataset.url, 25, schema_fields=['id'],
                              reader_pool_type='dummy', seed=3)
    combined = first + rest
    all_ids = {r['id'] for r in synthetic_dataset.data}
    assert set(combined) == all_ids
    assert {i for i in all_ids if combined.count(i) > 1} == set(first[20:25])


def test_batch_reader_checkpoint_resume(scalar_dataset):
    first, rest = _both_exact(1, scalar_dataset.url, 4, _read_batch_ids, schema_fields=['id'],
                              reader_pool_type='dummy', seed=13)
    all_ids = {r['id'] for r in scalar_dataset.data}
    combined = first + rest
    assert set(combined) == all_ids
    assert len(combined) == len(all_ids)


def test_rebatch_checkpoint_resume(scalar_dataset):
    first, rest = _both_exact(1, scalar_dataset.url, 5, _read_batch_ids, schema_fields=['id'],
                              reader_pool_type='dummy', seed=17, batch_size=7)
    all_ids = {r['id'] for r in scalar_dataset.data}
    combined = first + rest
    assert set(combined) == all_ids
    assert all(combined.count(i) <= 2 for i in all_ids)


def test_rebatch_drop_last_state_rereads_the_dropped_rows(scalar_dataset):
    # 100 rows in batches of 32: the last 4 rows are dropped, not delivered,
    # so a state taken after the pass reads their row group again
    def run(make_batch):
        with make_batch(scalar_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                        seed=19, batch_size=32, drop_last=True) as reader:
            ids = _read_batch_ids(reader)
            state = reader.state_dict()
        with make_batch(scalar_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                        seed=19, batch_size=32, resume_state=state) as resumed:
            return ids, _read_batch_ids(resumed), state

    expected = run(jax_make_batch_reader)
    ids, rest, state = run(make_batch_reader)
    assert (ids, rest, state) == expected
    assert len(ids) == 96 and state['remaining_global_parts']
    assert set(ids) | set(rest) == {r['id'] for r in scalar_dataset.data}


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_checkpoint_with_predicate_filtered_groups(synthetic_dataset, package):
    make, _, _, lam = PACKAGES[package]
    predicate = lam(['id'], lambda values: values['id'] < 30)
    first, rest, state = _checkpointed_ids(make, synthetic_dataset.url, 15, schema_fields=['id'],
                                           predicate=predicate, reader_pool_type='dummy',
                                           seed=19)
    matching = {r['id'] for r in synthetic_dataset.data if r['id'] < 30}
    assert set(first) | set(rest) == matching
    if package == 'torch':
        jax_predicate = jax_in_lambda(['id'], lambda values: values['id'] < 30)
        assert (first, rest, state) == _checkpointed_ids(
            jax_make_reader, synthetic_dataset.url, 15, schema_fields=['id'],
            predicate=jax_predicate, reader_pool_type='dummy', seed=19)


def test_state_dict_picklable_with_lambda_predicate(synthetic_dataset):
    predicate = in_lambda(['id'], lambda values: values['id'] % 2 == 0)
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], predicate=predicate,
                         reader_pool_type='dummy', seed=37)
    _read_ids(reader, limit=10)
    blob = pickle.dumps(reader.state_dict())
    reader.stop()
    reader.join()
    assert len(blob) < 100_000


@pytest.mark.parametrize('pool', ['thread', 'dummy'])
def test_failed_item_stays_undelivered(synthetic_dataset, pool):
    from petastorm_tpu_torch.transform import TransformSpec

    calls = {'n': 0}

    def explode_once(row):
        calls['n'] += 1
        if calls['n'] == 1:
            raise RuntimeError('decode exploded')
        return row

    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type=pool,
                         workers_count=1, seed=41, transform_spec=TransformSpec(explode_once))
    ids, errors = [], 0
    while True:
        try:
            ids.append(int(next(reader).id))
        except StopIteration:
            break
        except RuntimeError:
            errors += 1
            if pool == 'dummy':
                break  # the dummy pool stops its ventilator on a raised error
    assert errors == 1
    state = reader.state_dict()
    reader.stop()
    reader.join()
    resumed = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type=pool,
                          workers_count=1, seed=41, transform_spec=TransformSpec(lambda r: r),
                          resume_state=state)
    rest = _read_ids(resumed)
    resumed.stop()
    resumed.join()
    assert set(ids) | set(rest) == {r['id'] for r in synthetic_dataset.data}


def test_resume_state_is_pool_independent(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='thread',
                         workers_count=3, seed=23)
    first = _read_ids(reader, limit=20)
    state = reader.state_dict()
    reader.stop()
    reader.join()
    resumed = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                          seed=23, resume_state=state)
    rest = _read_ids(resumed)
    assert set(first) | set(rest) == {r['id'] for r in synthetic_dataset.data}


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_resume_state_mismatch_rejected(synthetic_dataset, package):
    make = PACKAGES[package][0]
    reader = make(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy', seed=29)
    _read_ids(reader, limit=5)
    state = reader.state_dict()
    reader.stop()
    reader.join()
    # a state of either package is refused by the port with the JAX message
    with pytest.raises(ValueError, match='does not match'):
        make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                    seed=29, shuffle_row_drop_partitions=2, resume_state=state)
    with pytest.raises(ValueError, match='Unrecognized'):
        make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                    seed=29, resume_state={'bogus': True})


def test_finished_reader_state_resumes_empty(synthetic_dataset):
    first, rest = _both_exact(0, synthetic_dataset.url, None, schema_fields=['id'],
                              reader_pool_type='dummy', seed=31)
    assert len(first) == 100 and rest == []


def _loader_checkpoint(package, url, batches, loader_kwargs, reader_kwargs):
    """``batches`` batches through a loader of ``package``, then its pickled
    state; the reader is stopped."""
    make, _, loader_cls, _ = PACKAGES[package]
    reader = make(url, **reader_kwargs)
    loader = loader_cls(reader, **loader_kwargs)
    it = iter(loader)
    first = [int(i) for _ in range(batches) for i in next(it)['id']]
    state = pickle.loads(pickle.dumps(loader.state_dict()))
    reader.stop()
    reader.join()
    return first, state


def _loader_resume(package, url, state, loader_kwargs, reader_kwargs):
    """The ids a loader of ``package`` resumed from ``state`` delivers."""
    make, _, loader_cls, _ = PACKAGES[package]
    reader = make(url, resume_state=state['reader'], **reader_kwargs)
    with loader_cls(reader, resume_state=state, **loader_kwargs) as loader:
        return [int(i) for b in loader for i in b['id']]


LOADER_CASES = {
    'rows': (dict(batch_size=10, shuffling_queue_capacity=30, seed=43, drop_last=False),
             dict(schema_fields=['id'], reader_pool_type='dummy', seed=43)),
    'columnar': (dict(batch_size=8, shuffling_queue_capacity=30, seed=43, drop_last=False),
                 dict(schema_fields=['id'], reader_pool_type='dummy', seed=43,
                      output='columnar')),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_loader_checkpoint_with_shuffle_buffer(synthetic_dataset, case):
    loader_kwargs, reader_kwargs = LOADER_CASES[case]
    url = synthetic_dataset.url
    first, state = _loader_checkpoint('torch', url, 3, loader_kwargs, reader_kwargs)
    j_first, j_state = _loader_checkpoint('jax', url, 3, loader_kwargs, reader_kwargs)
    assert first == j_first
    assert state['reader'] == j_state['reader'] and state['buffer_rng'] == j_state['buffer_rng']
    assert pickle.dumps(state['rows']) == pickle.dumps(j_state['rows'])
    rest = _loader_resume('torch', url, state, loader_kwargs, reader_kwargs)
    j_rest = _loader_resume('jax', url, j_state, loader_kwargs, reader_kwargs)
    combined = first + rest
    assert set(combined) == set(range(100))
    # the JAX resume reads the partly yielded row group again whole: its
    # rows the loader already took arrive twice
    assert len([i for i in range(100) if (first + j_rest).count(i) > 1]) <= 10
    if case == 'columnar':
        # whole row groups enter the buffer: nothing is partly yielded
        assert 'reader_yielded' not in state and rest == j_rest
    else:
        # the port's state also counts those rows, and its resume skips
        # them: every row once, the uninterrupted stream's batches
        assert state['reader_yielded'] and len(combined) == 100
        make, _, loader_cls, _ = PACKAGES['torch']
        with loader_cls(make(url, **reader_kwargs), **loader_kwargs) as loader:
            assert combined == [int(i) for b in loader for i in b['id']]


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
@pytest.mark.parametrize('taken_by,resumed_by', [('jax', 'torch'), ('torch', 'jax')])
def test_loader_state_resumes_across_packages(synthetic_dataset, case, taken_by, resumed_by):
    # a state taken by one package resumes the other's reader and loader and
    # gives the rows the taking package's own resume gives, in its order;
    # the JAX loader ignores a port state's reader_yielded, so it gives the
    # rows the port's resume gives without it
    loader_kwargs, reader_kwargs = LOADER_CASES[case]
    url = synthetic_dataset.url
    first, state = _loader_checkpoint(taken_by, url, 3, loader_kwargs, reader_kwargs)
    rest = _loader_resume(resumed_by, url, state, loader_kwargs, reader_kwargs)
    expected_state = state
    if resumed_by == 'jax':
        expected_state = {k: v for k, v in state.items() if k != 'reader_yielded'}
    assert rest == _loader_resume(taken_by, url, expected_state, loader_kwargs, reader_kwargs)
    assert set(first + rest) == set(range(100))


@pytest.mark.parametrize('taken_by,resumed_by', [('jax', 'torch'), ('torch', 'jax')])
def test_reader_state_resumes_across_packages(scalar_dataset, taken_by, resumed_by):
    kwargs = dict(schema_fields=['id'], reader_pool_type='dummy', seed=53, batch_size=16)
    reader = PACKAGES[taken_by][1](scalar_dataset.url, **kwargs)
    first = _read_batch_ids(reader, 2)
    state = pickle.loads(pickle.dumps(reader.state_dict()))
    reader.stop()
    reader.join()
    rests = []
    for package in (resumed_by, taken_by):
        with PACKAGES[package][1](scalar_dataset.url, resume_state=state, **kwargs) as resumed:
            rests.append(_read_batch_ids(resumed))
    assert rests[0] == rests[1]
    assert set(first + rests[0]) == {r['id'] for r in scalar_dataset.data}


def test_loader_reiter_with_buffered_rows_rejected(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                         seed=7)
    with TorchDataLoader(reader, batch_size=10, shuffling_queue_capacity=30, seed=7) as loader:
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match='buffered rows'):
            iter(loader)


def test_loader_multi_epoch_after_drop_last(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                         seed=7)
    with TorchDataLoader(reader, batch_size=30, drop_last=True) as loader:
        assert sum(len(b['id']) for b in loader) == 90
        assert sum(len(b['id']) for b in loader) == 0


def test_loader_state_dict_before_resume_iteration_preserves_rows(synthetic_dataset):
    loader_kwargs = dict(batch_size=10, shuffling_queue_capacity=30, seed=43)
    _, state = _loader_checkpoint('torch', synthetic_dataset.url, 1, loader_kwargs,
                                  dict(schema_fields=['id'], reader_pool_type='dummy', seed=43))
    assert state['rows']
    r2 = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                     seed=43, resume_state=state['reader'])
    with TorchDataLoader(r2, resume_state=state, **loader_kwargs) as resumed:
        state2 = resumed.state_dict()
    assert state2['rows'] == state['rows']
    assert state2['buffer_rng'] == state['buffer_rng']


def test_loader_resume_with_empty_rows_then_checkpoint(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                         seed=11)
    state = TorchDataLoader(reader, batch_size=10).state_dict()
    reader.stop()
    reader.join()
    assert state['rows'] == []
    r2 = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                     seed=11, resume_state=state['reader'])
    with TorchDataLoader(r2, batch_size=10, shuffling_queue_capacity=30, seed=11,
                         resume_state=state) as resumed:
        next(iter(resumed))
        state2 = resumed.state_dict()
    assert state2['rows']
    assert state2['buffer_rng'] is not None


def test_loader_seeded_resume_is_deterministic(synthetic_dataset):
    from petastorm_tpu_torch.shuffling_buffer import RandomShufflingBuffer

    loader_kwargs, reader_kwargs = LOADER_CASES['rows']
    _, state = _loader_checkpoint('torch', synthetic_dataset.url, 3, loader_kwargs,
                                  reader_kwargs)
    assert state['buffer_rng'] is not None
    assert RandomShufflingBuffer(30, 15, seed=43).rng_state != state['buffer_rng']
    runs = [_loader_resume('torch', synthetic_dataset.url, state, loader_kwargs, reader_kwargs)
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_loader_columnar_resume_through_process_pool_blob_transport(tmp_path):
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(), False),
                             UnischemaField('big', np.uint8, (128, 64, 3), RawTensorCodec(),
                                            False)])
    url = 'file://' + str(tmp_path / 'ds')
    rng = np.random.default_rng(4)
    # 24 KB rows x 50-row groups = 1.2 MB blocks: over the 1 MiB blob threshold
    with materialize_dataset(url, schema, rows_per_row_group=50) as writer:
        for i in range(150):
            writer.write({'id': np.int64(i),
                          'big': rng.integers(0, 255, (128, 64, 3), dtype=np.uint8)})
    reader = make_reader(url, output='columnar', reader_pool_type=ProcessPoolOptions(results_timeout_s=60),
                         workers_count=1, seed=13)
    loader = TorchDataLoader(reader, 16, shuffling_queue_capacity=64, seed=13)
    it = iter(loader)
    seen = [int(i) for _ in range(3) for i in next(it)['id']]
    state = pickle.loads(pickle.dumps(loader.state_dict()))
    reader.stop()
    reader.join()
    resumed_reader = make_reader(url, output='columnar', reader_pool_type=ProcessPoolOptions(results_timeout_s=60),
                                 workers_count=1, seed=13, resume_state=state['reader'])
    with TorchDataLoader(resumed_reader, 16, shuffling_queue_capacity=64, seed=13,
                         drop_last=False, resume_state=state) as resumed:
        rest = [int(i) for b in resumed for i in b['id']]
    combined = seen + rest
    assert set(combined) == set(range(150))
    assert all(combined.count(i) <= 2 for i in range(150))


def _host_stream(package, url, host, n_hosts, seed, resume=None):
    make, _, loader_cls, _ = PACKAGES[package]
    reader = make(url, schema_fields=['id'], output='columnar', reader_pool_type='dummy',
                  seed=seed, shuffle_row_groups=True, cur_shard=host, shard_count=n_hosts,
                  resume_state=resume['reader'] if resume else None)
    return loader_cls(reader, batch_size=10, drop_last=False, resume_state=resume), reader


def test_pod_wide_checkpoint_resume_exactly_once(synthetic_dataset):
    n_hosts, seed = 4, 101
    url = synthetic_dataset.url
    baselines = []
    for host in range(n_hosts):
        loader, _ = _host_stream('torch', url, host, n_hosts, seed)
        with loader:
            baselines.append([[int(i) for i in b['id']] for b in loader])
    streams = []
    for host in range(n_hosts):
        loader, reader = _host_stream('torch', url, host, n_hosts, seed)
        it = iter(loader)
        first = [[int(i) for i in next(it)['id']] for _ in range(1 + host % 2)]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
        reader.stop()
        reader.join()
        # the JAX package's loader and reader resume the port's state alike
        for package in ('torch', 'jax'):
            resumed_loader, _ = _host_stream(package, url, host, n_hosts, seed, resume=state)
            with resumed_loader:
                rest = [[int(i) for i in b['id']] for b in resumed_loader]
            assert first + rest == baselines[host], (package, host)
        streams.append(first + rest)
    delivered = [i for stream in streams for batch in stream for i in batch]
    assert sorted(delivered) == sorted(r['id'] for r in synthetic_dataset.data)


def test_pod_wide_shards_are_disjoint_after_resume(synthetic_dataset):
    n_hosts, seed = 4, 7
    url = synthetic_dataset.url
    per_host = []
    for host in range(n_hosts):
        loader, reader = _host_stream('torch', url, host, n_hosts, seed)
        first = [int(i) for i in next(iter(loader))['id']]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
        reader.stop()
        reader.join()
        resumed_loader, _ = _host_stream('torch', url, host, n_hosts, seed, resume=state)
        with resumed_loader:
            rest = [int(i) for b in resumed_loader for i in b['id']]
        per_host.append(set(first) | set(rest))
    for a in range(n_hosts):
        for b in range(a + 1, n_hosts):
            assert not (per_host[a] & per_host[b])


def test_resume_state_on_wrong_shard_remaps_instead_of_exact_replay(synthetic_dataset):
    url = synthetic_dataset.url
    reader = make_reader(url, schema_fields=['id'], reader_pool_type='dummy', seed=9,
                         cur_shard=0, shard_count=2)
    _read_ids(reader, limit=18)
    state = pickle.loads(pickle.dumps(reader.state_dict()))
    reader.stop()
    reader.join()
    assert state['shard'] == [0, 2] and state['remaining_global_parts']
    resumed = make_reader(url, schema_fields=['id'], reader_pool_type='dummy', seed=9,
                          cur_shard=1, shard_count=2, resume_state=state)
    assert _read_ids(resumed) == []
    resumed.stop()
    resumed.join()


@pytest.mark.parametrize('merged_by', ['jax', 'torch'])
def test_portable_resume_across_shard_counts(synthetic_dataset, merged_by):
    url = synthetic_dataset.url
    all_ids = {r['id'] for r in synthetic_dataset.data}
    first, states = [], []
    for shard in range(2):
        reader = make_reader(url, schema_fields=['id'], reader_pool_type='dummy', seed=9,
                             cur_shard=shard, shard_count=2)
        first.append(_read_ids(reader, limit=18))
        states.append(reader.state_dict())
        reader.stop()
        reader.join()
    merge = {'jax': jax_merge_resume_states, 'torch': merge_resume_states}[merged_by]
    merged = pickle.loads(pickle.dumps(merge(states)))
    assert merged == jax_merge_resume_states(states)
    rest = []
    for shard in range(3):
        resumed = make_reader(url, schema_fields=['id'], reader_pool_type='dummy', seed=9,
                              cur_shard=shard, shard_count=3, resume_state=merged)
        rest.append(_read_ids(resumed))
        resumed.stop()
        resumed.join()
        with jax_make_reader(url, schema_fields=['id'], reader_pool_type='dummy', seed=9,
                             cur_shard=shard, shard_count=3, resume_state=merged) as jr:
            assert _read_ids(jr) == rest[-1]
    delivered = [i for part in first + rest for i in part]
    assert set(delivered) == all_ids
    assert all(delivered.count(i) <= 2 for i in all_ids)
    replayed = [i for part in rest for i in part]
    assert len(replayed) == len(set(replayed))


def test_merge_resume_states_rejects_mismatched_selections(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                         seed=1)
    _read_ids(reader, limit=5)
    state = reader.state_dict()
    reader.stop()
    reader.join()
    other = dict(state, num_global_pieces=state['num_global_pieces'] + 1)
    with pytest.raises(ValueError, match='disagree on the dataset-wide'):
        merge_resume_states([state, other])
    with pytest.raises(ValueError, match='version-2'):
        merge_resume_states([{'version': 1}])
    with pytest.raises(ValueError, match='at least one'):
        merge_resume_states([])


@pytest.fixture
def small_smoke(tmp_path, monkeypatch):
    """``chip_smoke.py``'s plain store and resume phases at a small size on
    the CPU: 224 rows of 32 px (14 row groups), 32-row batches, the
    smoke's ratio of shuffle capacity to batch, a small ResNet."""
    import chip_smoke
    import torch
    from petastorm_tpu_torch.models import BottleneckBlock, ResNet
    from petastorm_tpu_torch.models.train import create_train_state

    images = {}

    def image(i):
        if i not in images:
            images[i] = chip_smoke._photo(np.random.default_rng([7, i]), 32, 32)
        return images[i]

    for name, value in (('ROWS', 224), ('IMAGE_SIZE', 32), ('BATCH', 32),
                        ('SHUFFLE_CAPACITY', 256), ('DEVICE_TYPE', 'cpu'), ('_image', image)):
        monkeypatch.setattr(chip_smoke, name, value)

    def new_train_state(torch_module):
        torch.manual_seed(chip_smoke.SEED)
        return create_train_state(ResNet([1, 1, 1, 1], BottleneckBlock,
                                         num_classes=chip_smoke.NUM_CLASSES, num_filters=4,
                                         dtype=torch.float32), device='cpu')

    monkeypatch.setattr(chip_smoke, 'new_train_state', new_train_state)
    url = 'file://' + str(tmp_path / 'plain')
    chip_smoke.build_plain_store(url)
    return chip_smoke, url


def test_smoke_resume_checks_at_small_size(small_smoke, capsys):
    chip_smoke, url = small_smoke
    epoch = chip_smoke.check_thread_epoch_once(url)
    assert epoch['each_row_once'] and epoch['rows_before'] == 5 * 32
    chip_smoke.phase_resume_checks(url, epoch)
    line = [ln for ln in capsys.readouterr().out.splitlines() if 'resume_checks' in ln][-1]
    assert '"each_row_once": true' in line and '"none_lost": true' in line
    assert '"dropped": 16' in line and 'does not match' in line


def test_smoke_plain_resume_at_small_size(small_smoke, capsys, monkeypatch):
    import torch

    import petastorm_tpu_torch.ops.preprocess as preprocess
    from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel

    # on the CPU the op runs the kernel's plain version: count its calls
    # where the card counts the kernel's launches
    plain = preprocess.normalize_reference

    def counted(*args, **kwargs):
        normalize_kernel.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(preprocess, 'normalize_reference', counted)
    chip_smoke, url = small_smoke
    launches, first_loss = chip_smoke.phase_plain_resume(torch, url, graphed=False)
    assert launches['normalize'] == 2 * chip_smoke.RESUME_STEPS
    out = capsys.readouterr().out
    assert '"batches_equal_as_rows": 8' in out and '"max_abs_loss_diff": 0.0' in out
    assert np.isfinite(first_loss)
