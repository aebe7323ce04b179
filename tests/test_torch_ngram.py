"""Port parity: NGram windows of petastorm_tpu_torch against the JAX package,
case for case with ``tests/test_ngram.py`` and the NGram cases of
``tests/test_jax_loader.py``.

The same rows (or the same store and seed) go through the JAX function and
its twin, and the windows must be equal: exactly and in order where the run
is deterministic (``form_ngram``, ``form_ngram_columnar``, the dummy pool),
as multisets where a thread or process pool orders the row groups. The
store is the suite's 100-row ``synthetic_dataset`` (10 rows per row group),
written by the JAX package. Every reader and loader is closed through
``with``; the module leaves no flight recorder or telemetry state behind."""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax.loader import stack_ngram_time_axis as jax_stack_ngram_time_axis
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.test_util.dataset_utils import TestSchema as JaxTestSchema
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import get_schema
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel import DataSharding
from petastorm_tpu_torch.row_worker import select_row_drop_indices
from petastorm_tpu_torch.torch import TorchDataLoader, stack_ngram_time_axis, stage_batch

PACKAGES = {'jax': (JaxNGram, jax_make_reader, JaxDataLoader, jax_stack_ngram_time_axis),
            'torch': (NGram, make_reader, TorchDataLoader, stack_ngram_time_axis)}


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


def _ngram(package, length=3, delta_threshold=1, overlap=True, fields=('id', 'id2')):
    """``tests/test_ngram.py``'s ``_ts_ngram`` in either package, with field
    names (regex patterns the reader resolves)."""
    return PACKAGES[package][0]({i: list(fields) for i in range(length)},
                                delta_threshold=delta_threshold, timestamp_field='id',
                                timestamp_overlap=overlap)


def _value(v):
    v = np.asarray(v)
    return v.dtype.str, v.shape, v.tobytes()


def _row_window(window):
    """A hashable form of one window of dicts or namedtuples."""
    return tuple((off, tuple(sorted((k, _value(v)) for k, v in (
        w._asdict() if hasattr(w, '_asdict') else w).items())))
        for off, w in sorted(window.items()))


def _block_windows(block):
    """The windows of one nested columnar block, each in :func:`_row_window`'s form."""
    n = len(next(iter(block[min(block)].values())))
    return [tuple((off, tuple(sorted((k, _value(col[i])) for k, col in block[off].items())))
                  for off in sorted(block)) for i in range(n)]


def _start_id(window):
    """The ``id`` at offset 0 of a window in :func:`_row_window`'s form."""
    dtype, _, data = dict(dict(window)[0])['id']
    return int(np.frombuffer(data, dtype)[0])


def _read(package, url, output, **kwargs):
    with PACKAGES[package][1](url, output=output, **kwargs) as reader:
        items = list(reader)
    if output == 'rows':
        return [_row_window(w) for w in items]
    return [w for block in items for w in _block_windows(block)]


# -- form_ngram and form_ngram_columnar (tests/test_ngram.py, TestFormNgram and
# -- TestFormNgramColumnarParity) ------------------------------------------------

FORM_CASES = {
    # name: (ngram kwargs, ids of the row group's rows)
    'basic_window': ({'length': 3}, range(5)),
    'delta_threshold_drops_gaps': ({'length': 2}, [0, 1, 5, 6]),
    'no_overlap': ({'length': 2, 'overlap': False}, range(6)),
    'unsorted_input_gets_sorted': ({'length': 2}, [3, 1, 0, 2]),
    'sorted_contiguous': ({'length': 3}, range(8)),
    'unsorted_with_gaps': ({'length': 2}, [9, 3, 1, 0, 5, 6, 2, 12, 13]),
    'no_overlap_greedy': ({'length': 2, 'overlap': False}, [4, 0, 1, 2, 3, 5, 8, 9]),
    'no_qualifying_window': ({'length': 2}, [0, 5, 10]),
    'no_threshold': ({'length': 2, 'delta_threshold': None}, [0, 5, 10]),
}


@pytest.mark.parametrize('case', sorted(FORM_CASES))
def test_form_ngram_equals_jax(case):
    kwargs, ids = FORM_CASES[case]
    rows = [{'id': int(i), 'id2': int(i) * 10} for i in ids]
    block = {'id': np.asarray(list(ids), dtype=np.int64),
             'id2': np.asarray(list(ids), dtype=np.int64) * 10}
    ours, theirs = _ngram('torch', **kwargs), _ngram('jax', **kwargs)
    expected = theirs.form_ngram(rows, JaxTestSchema)
    assert ours.form_ngram(rows, JaxTestSchema) == expected
    col, jax_col = ours.form_ngram_columnar(block), theirs.form_ngram_columnar(block)
    if jax_col is None:
        assert col is None and not expected
        return
    assert _block_windows(col) == _block_windows(jax_col) == [_row_window(w) for w in expected]


def test_form_ngram_per_timestep_fields_and_negative_offsets_equal_jax():
    rows = [{'id': i, 'id2': i} for i in range(4)]
    block = {'id': np.arange(4), 'id2': np.arange(4)}
    for fields in ({0: ['id', 'id2'], 1: ['id']}, {-1: ['id'], 0: ['id'], 1: ['id']}):
        ours, theirs = NGram(fields, 1, 'id'), JaxNGram(fields, 1, 'id')
        assert ours.length == theirs.length
        assert ours.form_ngram(rows, JaxTestSchema) == theirs.form_ngram(rows, JaxTestSchema)
        assert (_block_windows(ours.form_ngram_columnar(block))
                == _block_windows(theirs.form_ngram_columnar(block)))
    out = NGram({0: ['id', 'id2'], 1: ['id']}, 1, 'id').form_ngram_columnar(block)
    assert set(out[0]) == {'id', 'id2'} and set(out[1]) == {'id'}


def test_non_consecutive_offsets_and_regex_resolution_equal_jax(synthetic_dataset):
    with pytest.raises(PetastormTpuError, match='consecutive'):
        NGram({0: ['id'], 2: ['id']}, 1, 'id')
    with pytest.raises(JaxPetastormTpuError, match='consecutive'):
        JaxNGram({0: ['id'], 2: ['id']}, 1, 'id')
    fields = {0: ['id.*'], 1: ['id']}
    ours, theirs = NGram(fields, 1, 'id'), JaxNGram(fields, 1, 'id')
    ours.resolve_regex_field_names(get_schema(synthetic_dataset.url))
    theirs.resolve_regex_field_names(JaxTestSchema)
    assert set(ours.get_field_names_at_timestep(0)) == {'id', 'id2', 'id_float', 'id_odd'}
    for offset in (0, 1):
        assert (ours.get_field_names_at_timestep(offset)
                == theirs.get_field_names_at_timestep(offset))
    assert ours.get_field_names_at_all_timesteps() == theirs.get_field_names_at_all_timesteps()


# -- the reader (tests/test_ngram.py, TestNgramEndToEnd and
# -- TestColumnarNgramEndToEnd) --------------------------------------------------

@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
@pytest.mark.parametrize('output', ['rows', 'columnar'])
def test_reader_windows_equal_jax(synthetic_dataset, pool, output):
    """The same windows as the JAX reader for the same store and seed, in
    the same order on the dummy pool; 8 windows per 10-row row group."""
    kwargs = {'reader_pool_type': pool, 'workers_count': 2, 'seed': 123,
              'shuffle_row_groups': True}
    if pool == 'process':
        kwargs['pool_kwargs'] = {'results_timeout_s': 60}
    ours = _read('torch', synthetic_dataset.url, output, ngram=_ngram('torch'), **kwargs)
    kwargs.pop('pool_kwargs', None)
    theirs = _read('jax', synthetic_dataset.url, output, ngram=_ngram('jax'), **kwargs)
    assert len(ours) == 80
    if pool == 'dummy':
        assert ours == theirs
    else:
        assert sorted(ours) == sorted(theirs)


def test_process_pool_windows_equal_thread_pool(synthetic_dataset):
    """Window blocks cross the process boundary by the block serializer's
    embedded pickle, zero-copy ring slots included: the same windows as the
    thread pool's."""
    ngram_kwargs = {'fields': ('id', 'matrix')}
    thread = _read('torch', synthetic_dataset.url, 'columnar',
                   ngram=_ngram('torch', **ngram_kwargs), reader_pool_type='thread',
                   workers_count=2, seed=5)
    process = _read('torch', synthetic_dataset.url, 'columnar',
                    ngram=_ngram('torch', **ngram_kwargs), reader_pool_type='process',
                    workers_count=2, seed=5, zero_copy=True,
                    pool_kwargs={'results_timeout_s': 60})
    assert len(thread) == 80 and sorted(process) == sorted(thread)


def test_windows_never_cross_a_row_group(synthetic_dataset):
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy', ngram=_ngram('torch'),
                     shuffle_row_groups=False) as reader:
        windows = list(reader)
    assert sorted(w[0].id for w in windows) == [i for i in range(100) if i % 10 <= 7]
    w = windows[0]
    assert [w[t].id for t in range(3)] == [w[0].id, w[0].id + 1, w[0].id + 2]
    # the namedtuples carry only that timestep's fields
    assert set(w[0]._fields) == {'id', 'id2'}


def test_windows_with_images_equal_jax(synthetic_dataset):
    fields = {0: ['id', 'image_png'], 1: ['id']}
    kwargs = {'reader_pool_type': 'dummy', 'shuffle_row_groups': False}
    with make_reader(synthetic_dataset.url, ngram=NGram(fields, 1, 'id'), **kwargs) as reader:
        ours = next(iter(reader))
    with jax_make_reader(synthetic_dataset.url, ngram=JaxNGram(fields, 1, 'id'),
                         **kwargs) as reader:
        theirs = next(iter(reader))
    assert _row_window(ours) == _row_window(theirs)
    expected = {r['id']: r for r in synthetic_dataset.data}
    np.testing.assert_array_equal(ours[0].image_png, expected[ours[0].id]['image_png'])


@pytest.mark.parametrize('output', ['rows', 'columnar'])
def test_row_drop_partitions_spill_over_as_jax(synthetic_dataset, output):
    """Two row-drop partitions per row group lose no window at their
    boundary: each spills over by ``length - 1`` rows."""
    kwargs = {'reader_pool_type': 'dummy', 'shuffle_row_groups': False,
              'shuffle_row_drop_partitions': 2}
    ours = _read('torch', synthetic_dataset.url, output, ngram=_ngram('torch', length=2), **kwargs)
    theirs = _read('jax', synthetic_dataset.url, output, ngram=_ngram('jax', length=2), **kwargs)
    assert ours == theirs
    assert sorted(_start_id(w) for w in ours) == [i for i in range(100) if i % 10 <= 8]


def test_select_row_drop_indices_spill_equals_jax():
    from petastorm_tpu.row_worker import select_row_drop_indices as jax_select
    for num_rows, parts, length in ((10, 2, 2), (10, 3, 3), (7, 3, 4), (2, 3, 2)):
        for part in range(parts):
            np.testing.assert_array_equal(
                select_row_drop_indices(num_rows, (part, parts), _ngram('torch', length)),
                jax_select(num_rows, (part, parts), _ngram('jax', length)))


def test_no_overlap_with_row_drop_and_rebatching_refused_as_jax(synthetic_dataset):
    for package in PACKAGES:
        factory = PACKAGES[package][1]
        with pytest.raises(NotImplementedError, match='timestamp_overlap=False'):
            factory(synthetic_dataset.url, ngram=_ngram(package, overlap=False),
                    shuffle_row_drop_partitions=2)
        with pytest.raises(ValueError, match='batch_size rebatching is not supported'):
            factory(synthetic_dataset.url, ngram=_ngram(package), output='columnar', batch_size=4)


# -- stack_ngram_time_axis and the loader (test_ngram.py, test_jax_loader.py) ---

def test_stack_ngram_time_axis_equals_jax(synthetic_dataset):
    stacked = {}
    for package in PACKAGES:
        with PACKAGES[package][1](synthetic_dataset.url, reader_pool_type='dummy',
                                  ngram=_ngram(package), output='columnar',
                                  shuffle_row_groups=False) as reader:
            stacked[package] = PACKAGES[package][3](next(iter(reader)))
    ours = stacked['torch']
    assert sorted(ours) == sorted(stacked['jax']) == ['id', 'id2']
    for name in ours:
        np.testing.assert_array_equal(ours[name], stacked['jax'][name])
    assert ours['id'].shape == (8, 3)
    np.testing.assert_array_equal(ours['id'][:, 2], ours['id'][:, 0] + 2)
    by_id = {r['id']: r['id2'] for r in synthetic_dataset.data}
    np.testing.assert_array_equal(ours['id2'], np.vectorize(by_id.get)(ours['id']))
    # a batch staged as tensors stacks into a tensor
    tensors = stack_ngram_time_axis({0: {'id': torch.arange(4)}, 1: {'id': torch.arange(4) + 1}})
    assert torch.equal(tensors['id'], torch.stack([torch.arange(4), torch.arange(4) + 1], 1))


def test_stack_ngram_time_axis_ragged_field_error():
    batch = {0: {'id': np.zeros((4, 3))}, 1: {'id': np.zeros((4, 5))}}
    with pytest.raises(PetastormTpuError, match="'id'.*TransformSpec"):
        stack_ngram_time_axis(batch)
    with pytest.raises(JaxPetastormTpuError, match="'id'.*TransformSpec"):
        jax_stack_ngram_time_axis(batch)


def test_row_loader_ngram_batches_equal_jax(synthetic_dataset):
    fields = {0: ['id', 'matrix'], 1: ['id']}
    batches = {}
    for package, (ngram_cls, factory, loader_cls, _) in PACKAGES.items():
        with loader_cls(factory(synthetic_dataset.url, reader_pool_type='dummy',
                                ngram=ngram_cls(fields, 1, 'id'), shuffle_row_groups=False),
                        batch_size=4) as loader:
            batches[package] = next(iter(loader))
    ours = batches['torch']
    assert sorted(ours) == [0, 1] and ours[0]['matrix'].shape == (4, 32, 16, 3)
    np.testing.assert_array_equal(ours[1]['id'], ours[0]['id'] + 1)
    for off in ours:
        assert sorted(ours[off]) == sorted(batches['jax'][off])
        for name in ours[off]:
            np.testing.assert_array_equal(ours[off][name], batches['jax'][off][name])


def test_row_loader_ngram_state_pickles_and_resumes_as_jax(synthetic_dataset):
    """A row NGram loader's state keeps its buffered windows as plain dicts
    (schema namedtuples do not pickle), equal to JAX's, and a resume from
    either package's state gives JAX's next batch."""
    fields = {0: ['id'], 1: ['id', 'id2']}

    def run(package, state=None):
        ngram_cls, factory, loader_cls, _ = PACKAGES[package]
        reader = factory(synthetic_dataset.url, reader_pool_type='dummy', seed=1,
                         ngram=ngram_cls(fields, 1, 'id'),
                         resume_state=None if state is None else state['reader'])
        with loader_cls(reader, batch_size=4, shuffling_queue_capacity=16, seed=1,
                        resume_state=state) as loader:
            it = iter(loader)
            batch = next(it)
            return batch, pickle.loads(pickle.dumps(loader.state_dict()))

    (ours, state), (theirs, jax_state) = run('torch'), run('jax')
    for off in theirs:
        np.testing.assert_array_equal(ours[off]['id'], theirs[off]['id'])
    assert state['rows'] and isinstance(state['rows'][0][0], dict)
    assert [{o: {k: int(v) for k, v in w[o].items()} for o in w} for w in state['rows']] == \
        [{o: {k: int(v) for k, v in w[o].items()} for o in w} for w in jax_state['rows']]
    expected = run('jax', jax_state)[0]
    for taken in (state, jax_state):
        resumed = run('torch', taken)[0]
        for off in expected:
            for name in expected[off]:
                np.testing.assert_array_equal(resumed[off][name], expected[off][name])


def _columnar_loader_run(package, url, state=None, batches=3):
    """Windows of 4 through a shuffling columnar loader on the dummy pool:
    ``batches`` stacked batches and the loader's state after them."""
    ngram_cls, factory, loader_cls, stack = PACKAGES[package]
    reader_kwargs = {'reader_pool_type': 'dummy', 'seed': 1, 'num_epochs': None,
                     'output': 'columnar'}
    if state is not None:
        reader_kwargs['resume_state'] = state['reader']
    out = []
    with loader_cls(factory(url, ngram=ngram_cls({i: ['id', 'id2'] for i in range(4)}, 1, 'id'),
                            **reader_kwargs),
                    batch_size=8, shuffling_queue_capacity=32, seed=2,
                    resume_state=state) as loader:
        it = iter(loader)
        for _ in range(batches):
            out.append(stack(next(it)))
        return out, loader.state_dict()


def test_columnar_loader_shuffles_and_resumes_windows_as_jax(synthetic_dataset):
    """A shuffling loader over columnar windows gives JAX's batches for the
    same seeds; its state holds the buffered windows under flat
    ``(offset, field)`` keys as JAX's does, and each package resumes the
    other's state into the same next batches."""
    runs = {p: _columnar_loader_run(p, synthetic_dataset.url) for p in PACKAGES}
    for ours, theirs in zip(runs['torch'][0], runs['jax'][0]):
        assert sorted(ours) == ['id', 'id2'] and ours['id'].shape == (8, 4)
        for name in ours:
            np.testing.assert_array_equal(ours[name], theirs[name])
    state, jax_state = runs['torch'][1], runs['jax'][1]
    assert state['rows'] and sorted(state['rows'][0]) == sorted(jax_state['rows'][0])
    assert sorted(state['rows'][0])[0] == (0, 'id')
    resumed = {(by, taken): _columnar_loader_run(by, synthetic_dataset.url, runs[taken][1], 2)[0]
               for by in PACKAGES for taken in PACKAGES}
    expected = resumed[('jax', 'jax')]
    for batches in resumed.values():
        for ours, theirs in zip(batches, expected):
            for name in theirs:
                np.testing.assert_array_equal(ours[name], theirs[name])


def test_time_stack_stages_onto_a_sequence_sharding(synthetic_dataset):
    """``[B, T]`` window stacks staged onto a sequence sharding keep this
    rank's slice of the time axis (the twin of ``P('data', 'seq')`` in
    ``test_ngram_time_stack_feeds_sequence_sharding``); a ``[B]`` column
    has no time axis to split."""
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy', shuffle_row_groups=False,
                     ngram=NGram({i: ['id'] for i in range(4)}, 1, 'id')) as reader:
        with TorchDataLoader(reader, batch_size=4) as loader:
            stacked = stack_ngram_time_axis(next(iter(loader)))
    assert stacked['id'].shape == (4, 4)
    np.testing.assert_array_equal(stacked['id'][:, 1], stacked['id'][:, 0] + 1)
    for index in range(2):
        sharding = DataSharding(None, ('data',), torch.device('cpu'), 0, 1, seq_index=index,
                                seq_size=2)
        staged = stage_batch(stacked, sharding)
        assert isinstance(staged['id'], torch.Tensor)
        np.testing.assert_array_equal(staged['id'].numpy(),
                                      stacked['id'][:, 2 * index:2 * index + 2])
        with pytest.raises(ValueError, match='axis 1'):
            stage_batch({'id': stacked['id'][:, 0]}, sharding)
