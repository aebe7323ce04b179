"""Mixtures of the port against the JAX package: ``WeightedSamplingReader``
and ``MixtureReader`` over the same two token stores, each package's readers
on a dummy pool without shuffling. The id sequences, the ``mixture_*``
diagnostics and the stall reports are compared exactly."""

import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import observability as jax_obs
from petastorm_tpu import weighted_sampling_reader as jax_wsr
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.sequence import mixture as jax_mixture
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch import weighted_sampling_reader as wsr
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.sequence import MixtureReader, MixtureSchedule
from petastorm_tpu_torch.torch import TorchDataLoader


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


#: each package's names for the same things
PACKAGES = {
    'jax': {'make_reader': jax_make_reader, 'Mixture': jax_mixture.MixtureReader,
            'Schedule': jax_mixture.MixtureSchedule,
            'Weighted': jax_wsr.WeightedSamplingReader, 'error': JaxPetastormTpuError,
            'obs': jax_obs},
    'torch': {'make_reader': make_reader, 'Mixture': MixtureReader,
              'Schedule': MixtureSchedule, 'Weighted': wsr.WeightedSamplingReader,
              'error': PetastormTpuError, 'obs': obs},
}

TokenSchema = JaxUnischema('TokenSchema', [
    JaxUnischemaField('id', np.int64, (), JaxScalarCodec(), False),
    JaxUnischemaField('tokens', np.int32, (None,), JaxNdarrayCodec(), False),
])


def _token_rows(num_rows, seed, id_offset=0, max_len=64):
    """Zipf-like lengths: mostly short rows, a heavy tail."""
    rng = np.random.default_rng(seed)
    return [{'id': np.int64(i + id_offset),
             'tokens': rng.integers(0, 1000, int(min(rng.zipf(1.6), max_len)), dtype=np.int32)}
            for i in range(num_rows)]


def _write(path, rows, rows_per_row_group=10):
    url = 'file://' + str(path)
    with jax_materialize_dataset(url, TokenSchema, rows_per_row_group=rows_per_row_group) as w:
        for row in rows:
            w.write(row)
    return url


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    """Two stores of different lengths: 40 rows (ids 0-39), 10 rows (ids
    1000-1009)."""
    rows_a = _token_rows(40, seed=1)
    rows_b = _token_rows(10, seed=2, id_offset=1000)
    return ((_write(tmp_path_factory.mktemp('mix_a'), rows_a), rows_a),
            (_write(tmp_path_factory.mktemp('mix_b'), rows_b), rows_b))


def _reader(pkg, url, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('shuffle_row_groups', False)
    return PACKAGES[pkg]['make_reader'](url, **kwargs)


def _mixture_keys(diag):
    return {k: v for k, v in diag.items() if k.startswith('mixture_')}


def _ids(item):
    return [int(x) for x in np.atleast_1d(item.id)]


def _drain(pkg, sources, cls='Mixture', reader_kwargs=None, **kwargs):
    """Every id of a mixture of the two sources, and its ``mixture_*``
    diagnostics (``None`` for the base class)."""
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a, **(reader_kwargs or {})) as ra, \
            _reader(pkg, url_b, **(reader_kwargs or {})) as rb:
        mixed = PACKAGES[pkg][cls]([ra, rb], **kwargs)
        ids = [i for item in mixed for i in _ids(item)]
        diag = _mixture_keys(mixed.diagnostics) if cls == 'Mixture' else None
        return ids, diag, mixed


@pytest.mark.parametrize('seed', [0, 7, 17, 99, 2 ** 40])
@pytest.mark.parametrize('weights', [(0.5, 0.5), (7, 3), (0.1, 0.9)])
def test_renormalize_interleaving_matches_jax(sources, seed, weights):
    # a dry source hands its mass to the live one: every row of both comes
    ids, diag, mixed = _drain('torch', sources, weights=list(weights), seed=seed)
    jax_ids, jax_diag, _ = _drain('jax', sources, weights=list(weights), seed=seed)
    assert ids == jax_ids
    assert diag == jax_diag
    (_, rows_a), (_, rows_b) = sources
    assert sorted(ids) == sorted(int(r['id']) for r in rows_a + rows_b)
    assert diag['mixture_source_0_rows'] == 40 and diag['mixture_source_1_rows'] == 10
    assert diag['mixture_source_0_exhausted'] == diag['mixture_source_1_exhausted'] == 1
    assert mixed.last_row_consumed


@pytest.mark.parametrize('seed', [17, 5])
def test_stop_policy_matches_jax(sources, seed):
    # the first dry source ends the mixture: the original petastorm's rule
    ids, _, mixed = _drain('torch', sources, cls='Weighted', probabilities=[0.5, 0.5],
                           seed=seed, on_exhausted='stop')
    jax_ids, _, _ = _drain('jax', sources, cls='Weighted', probabilities=[0.5, 0.5],
                           seed=seed, on_exhausted='stop')
    assert ids == jax_ids
    assert len(ids) < 50 and mixed.last_row_consumed
    assert len(set(ids)) == len(ids)


def test_base_reader_interleaving_matches_jax(sources):
    ids, _, _ = _drain('torch', sources, cls='Weighted', probabilities=[2, 1], seed=3)
    jax_ids, _, _ = _drain('jax', sources, cls='Weighted', probabilities=[2, 1], seed=3)
    assert ids == jax_ids and len(ids) == 50


def test_same_seed_same_interleaving(sources):
    runs = [_drain('torch', sources, weights=[0.7, 0.3], seed=99)[0] for _ in range(2)]
    assert runs[0] == runs[1]
    assert runs[0] != _drain('torch', sources, weights=[0.7, 0.3], seed=98)[0]


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
@pytest.mark.parametrize('kwargs,match', [
    ({'probabilities': [1, 1], 'on_exhausted': 'ignore'}, 'on_exhausted'),
    ({'probabilities': [1]}, 'same length'),
    ({'probabilities': [0, 0]}, 'positive'),
])
def test_weighted_sampling_refusals(sources, pkg, kwargs, match):
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a) as ra, _reader(pkg, url_b) as rb:
        with pytest.raises(PACKAGES[pkg]['error'], match=match):
            PACKAGES[pkg]['Weighted']([ra, rb], **kwargs)


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
@pytest.mark.parametrize('other,match', [
    ({'output': 'columnar'}, 'batched_output'),
    ({'schema_fields': ['id']}, 'same fields'),
])
def test_sources_must_agree(sources, pkg, other, match):
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a) as ra, _reader(pkg, url_b, **other) as rb:
        with pytest.raises(PACKAGES[pkg]['error'], match=match):
            PACKAGES[pkg]['Mixture']([ra, rb], weights=[1, 1])


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_sources_must_share_the_ngram(sources, pkg):
    if pkg == 'jax':
        from petastorm_tpu.ngram import NGram
    else:
        from petastorm_tpu_torch.ngram import NGram
    (url_a, _), (url_b, _) = sources
    ngram = NGram({0: ['id'], 1: ['id']}, delta_threshold=1, timestamp_field='id')
    with _reader(pkg, url_a) as ra, _reader(pkg, url_b, ngram=ngram) as rb:
        with pytest.raises(PACKAGES[pkg]['error'], match='NGram'):
            PACKAGES[pkg]['Weighted']([ra, rb], [1, 1])


def _live_weights(pkg, sources):
    """20 rows at [1, 0], a live swap to [0, 1], 20 more; then the
    refusals of a swap."""
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a, num_epochs=None) as ra, _reader(pkg, url_b, num_epochs=None) as rb:
        mixed = PACKAGES[pkg]['Mixture']([ra, rb], weights=[1, 0], seed=5, token_field='tokens')
        ids = [int(next(mixed).id) for _ in range(20)]
        before = _mixture_keys(mixed.diagnostics)
        mixed.set_weights([0, 1])
        ids += [int(next(mixed).id) for _ in range(20)]
        for bad in ([1], [-1, 2], [0, 0]):
            with pytest.raises(PACKAGES[pkg]['error']):
                mixed.set_weights(bad)
        return ids, before, _mixture_keys(mixed.diagnostics), mixed.weights


def test_set_weights_live_matches_jax(sources):
    result = _live_weights('torch', sources)
    assert result == _live_weights('jax', sources)
    ids, before, diag, weights = result
    assert before['mixture_source_1_rows'] == 0
    assert all(i < 1000 for i in ids[:20]) and all(i >= 1000 for i in ids[20:])
    assert diag['mixture_source_0_rows'] == diag['mixture_source_1_rows'] == 20
    assert diag['mixture_source_1_tokens'] > 0
    assert diag['mixture_weight_updates'] == 1
    assert weights == (0.0, 1.0)


def test_token_counts_are_the_rows_lengths(sources):
    (url_a, rows_a), (url_b, rows_b) = sources
    lengths = {int(r['id']): len(r['tokens']) for r in rows_a + rows_b}
    with _reader('torch', url_a) as ra, _reader('torch', url_b) as rb:
        mixed = MixtureReader([ra, rb], weights=[1, 1], seed=2, token_field='tokens')
        ids = [int(r.id) for r in mixed]
        diag = mixed.diagnostics
    assert diag['mixture_source_0_tokens'] == sum(lengths[i] for i in ids if i < 1000)
    assert diag['mixture_source_1_tokens'] == sum(lengths[i] for i in ids if i >= 1000)


def _columnar_counts(pkg, sources):
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a, output='columnar') as ra, \
            _reader(pkg, url_b, output='columnar') as rb:
        mixed = PACKAGES[pkg]['Mixture']([ra, rb], weights=[3, 1], seed=11,
                                         token_field='tokens')
        ids = [_ids(block) for block in mixed]
        return ids, _mixture_keys(mixed.diagnostics)


def test_columnar_blocks_count_rows_and_tokens_as_jax(sources):
    # a batched source's block counts its rows and the sum of its cells'
    # lengths
    ids, diag = _columnar_counts('torch', sources)
    assert (ids, diag) == _columnar_counts('jax', sources)
    (_, rows_a), (_, rows_b) = sources
    assert diag['mixture_source_0_rows'] == 40 and diag['mixture_source_1_rows'] == 10
    assert diag['mixture_source_0_tokens'] == sum(len(r['tokens']) for r in rows_a)
    assert diag['mixture_source_1_tokens'] == sum(len(r['tokens']) for r in rows_b)


def _schedule_run(pkg, sources):
    (url_a, _), (url_b, _) = sources
    schedule = PACKAGES[pkg]['Schedule']({0: [1, 0], 1: [0, 1]})
    out = [schedule.weights_for(0), schedule.weights_for(5)]
    with _reader(pkg, url_a, num_epochs=None) as ra, _reader(pkg, url_b, num_epochs=None) as rb:
        mixed = PACKAGES[pkg]['Mixture']([ra, rb], seed=3, schedule=schedule)
        out.append(mixed.weights)
        out.append([int(next(mixed).id) for _ in range(5)])
        mixed.reset()
        out += [mixed.epoch, mixed.weights, [int(next(mixed).id) for _ in range(5)],
                _mixture_keys(mixed.diagnostics)]
    return out


def test_schedule_applies_at_reset_as_jax(sources):
    out = _schedule_run('torch', sources)
    assert out == _schedule_run('jax', sources)
    w0, w5, weights, first, epoch, new_weights, second, diag = out
    assert (w0, w5, weights, new_weights) == ((1.0, 0.0), (0.0, 1.0), (1.0, 0.0), (0.0, 1.0))
    assert epoch == 1 and diag['mixture_epoch'] == 1
    assert diag['mixture_weight_updates'] == 0  # schedule steps are not user swaps
    assert diag['mixture_source_0_rows'] == diag['mixture_source_1_rows'] == 5
    assert all(i < 1000 for i in first) and all(i >= 1000 for i in second)


def _reset_revives(pkg, sources):
    # one-epoch sources: reset() resets the finished ones and revives them
    with _reader(pkg, sources[0][0]) as ra, _reader(pkg, sources[1][0]) as rb:
        mixed = PACKAGES[pkg]['Mixture']([ra, rb], weights=[1, 1], seed=4)
        first = [int(r.id) for r in mixed]
        mixed.reset()
        second = [int(r.id) for r in mixed]
        return first, second, _mixture_keys(mixed.diagnostics)


def test_reset_revives_finished_sources_as_jax(sources):
    first, second, diag = _reset_revives('torch', sources)
    assert (first, second, diag) == _reset_revives('jax', sources)
    assert sorted(first) == sorted(second) and len(first) == 50
    assert diag['mixture_source_0_rows'] == 80 and diag['mixture_epoch'] == 1


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_schedule_refusals(pkg):
    with pytest.raises(PACKAGES[pkg]['error'], match='epoch 0'):
        PACKAGES[pkg]['Schedule']({1: [1, 1]})
    with pytest.raises(PACKAGES[pkg]['error'], match='at least one'):
        PACKAGES[pkg]['Schedule']({})
    assert repr(PACKAGES[pkg]['Schedule']([(0, [1, 2]), (3, [2, 1])])) == \
        'MixtureSchedule({0: (1.0, 2.0), 3: (2.0, 1.0)})'


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_mixture_needs_weights_or_a_schedule(sources, pkg):
    with _reader(pkg, sources[0][0]) as ra, _reader(pkg, sources[1][0]) as rb:
        with pytest.raises(PACKAGES[pkg]['error'], match='weights or a schedule'):
            PACKAGES[pkg]['Mixture']([ra, rb])


def _stall_report(pkg, sources):
    (url_a, _), (url_b, _) = sources
    with _reader(pkg, url_a) as ra, _reader(pkg, url_b) as rb:
        mixed = PACKAGES[pkg]['Mixture']([ra, rb], weights=[0.5, 0.5], seed=17,
                                         token_field='tokens')
        for _ in range(10):
            next(mixed)
        diag = mixed.diagnostics
    return diag


def test_stall_report_of_a_two_source_mixture_matches_jax(sources):
    diag = _stall_report('torch', sources)
    jax_diag = _stall_report('jax', sources)
    assert _mixture_keys(diag) == _mixture_keys(jax_diag)
    report = obs.stall_report(diag)
    # the port's report of its own diagnostics is the JAX package's report
    # of the same dict, mixture included
    assert report == jax_obs.stall_report(diag)
    assert report['mixture'] == jax_obs.stall_report(jax_diag)['mixture']
    assert set(report['mixture']) == {0, 1}
    assert sum(src['rows'] for src in report['mixture'].values()) == 10
    rendered = obs.format_stall_report(report)
    assert 'mixture sources' in rendered and 'source 0' in rendered and 'source 1' in rendered
    assert rendered == jax_obs.format_stall_report(report)


def test_loader_over_a_mixture_on_the_cpu(sources):
    # the card path's composition: a columnar mixture into the loader
    (url_a, rows_a), (url_b, rows_b) = sources
    with _reader('torch', url_a, output='columnar') as ra, \
            _reader('torch', url_b, output='columnar') as rb:
        mixed = MixtureReader([ra, rb], weights=[7, 3], seed=7)
        loader = TorchDataLoader(mixed, batch_size=10, to_device='cpu')
        ids = [int(i) for batch in loader for i in batch['id']]
        diag = loader.diagnostics
    assert sorted(ids) == sorted(int(r['id']) for r in rows_a + rows_b)
    assert diag['mixture_source_0_rows'] == 40 and diag['mixture_source_1_rows'] == 10
    assert set(obs.stall_report(diag)['mixture']) == {0, 1}


def test_duty_cycle_over_a_mixture_reports_its_sources_pools(sources):
    # the card path's helper: a composition has no pool of its own, so the
    # run reports each source's
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    (url_a, _), (url_b, _) = sources
    mixtures = []

    def factory(url, **kwargs):
        readers = [make_reader(u, schema_fields=['id'], output='columnar', **kwargs)
                   for u in (url, url_b)]
        mixtures.append(MixtureReader(readers, weights=[7, 3], seed=7))
        return mixtures[-1]

    result = pipeline_duty_cycle(url_a, lambda ids: None, lambda b: (b['id'],), batch_size=5,
                                 steps=4, warmup_steps=1, device='cpu', reader_factory=factory,
                                 reader_kwargs={'reader_pool_type': 'dummy', 'seed': 7})
    pools = result.extra['pool']
    assert isinstance(pools, list) and len(pools) == 2 and all(isinstance(p, dict) for p in pools)
    assert sorted(result.extra['stall']['mixture']) == [0, 1]
    assert mixtures[0].diagnostics['mixture_source_0_rows'] >= 1


def test_smoke_mixture_checks_at_small_size(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s ``mixture_checks`` on the CPU over a 1024-row
    token store (4 row groups a source)."""
    import json

    import chip_smoke

    monkeypatch.setattr(chip_smoke, 'TOKENS_ROWS', 1024)
    url = 'file://' + str(tmp_path / 'tokens')
    rows = chip_smoke.build_token_store(url)
    chip_smoke.phase_mixture_checks(url, rows)
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"mixture_checks"' in ln][-1])
    assert line['renormalize']['every_row_once'] and line['renormalize']['rows'] == 1024
    assert line['stop']['rows'] < 1024 and sum(line['stop']['exhausted']) == 1
    assert [e['weights'] for e in line['schedule']['epochs']] == [[0.7, 0.3], [0.5, 0.5]]
