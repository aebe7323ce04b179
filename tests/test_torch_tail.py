"""Tail-following ingest of the port against the JAX package: snapshots
published by ``DatasetWriter.publish`` and ``publish_snapshot``, and
``TailFollowingReader`` over a store that grows between and during reads.
The snapshot payloads are compared byte for byte, the delivered ids as
sequences (dummy pools, no shuffle), and a snapshot written by one package
is followed by the other, both ways."""

import json
import os
import pickle
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import observability as jax_obs
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.etl import dataset_metadata as jax_dm
from petastorm_tpu.sequence import tail as jax_tail
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import dataset_metadata as dm
from petastorm_tpu_torch.sequence import tail
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


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
    'jax': {'dm': jax_dm, 'tail': jax_tail, 'error': JaxPetastormTpuError, 'obs': jax_obs,
            'schema': JaxUnischema('TokenSchema', [
                JaxUnischemaField('id', np.int64, (), JaxScalarCodec(), False),
                JaxUnischemaField('tokens', np.int32, (None,), JaxNdarrayCodec(), False)])},
    'torch': {'dm': dm, 'tail': tail, 'error': PetastormTpuError, 'obs': obs,
              'schema': Unischema('TokenSchema', [
                  UnischemaField('id', np.int64, (), ScalarCodec(), False),
                  UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False)])},
}
BOTH = ['torch', 'jax']
#: (writer's package, follower's package)
PAIRS = [('torch', 'torch'), ('jax', 'jax'), ('torch', 'jax'), ('jax', 'torch')]
POLL = 0.02


def _token_rows(num_rows, seed, id_offset=0, max_len=64):
    rng = np.random.default_rng(seed)
    return [{'id': np.int64(i + id_offset),
             'tokens': rng.integers(0, 1000, int(min(rng.zipf(1.6), max_len)), dtype=np.int32)}
            for i in range(num_rows)]


def _store(pkg, path, num_rows=10, seed=7):
    """A finished 10-row store (5 rows a row group) and its rows."""
    url = 'file://' + str(path)
    rows = _token_rows(num_rows, seed)
    with PACKAGES[pkg]['dm'].materialize_dataset(url, PACKAGES[pkg]['schema'],
                                                 rows_per_row_group=5) as w:
        for row in rows:
            w.write(row)
    return url, rows


def _append(pkg, url, rows, final=False, rows_per_row_group=5):
    """Grow the store by ``rows`` through an appending writer and publish."""
    writer = PACKAGES[pkg]['dm'].DatasetWriter(url, PACKAGES[pkg]['schema'],
                                               rows_per_row_group=rows_per_row_group,
                                               append=True)
    for row in rows:
        writer.write(row)
    snap = writer.publish(final=final)
    writer.close()
    return snap


def _follower(pkg, url, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('shuffle_row_groups', False)
    kwargs.setdefault('poll_interval', POLL)
    kwargs.setdefault('idle_timeout', 30)
    return PACKAGES[pkg]['tail'].TailFollowingReader(url, **kwargs)


def _snapshot_files(url):
    snap_dir = os.path.join(url[len('file://'):], '_snapshots')
    return {name: open(os.path.join(snap_dir, name), 'rb').read()
            for name in sorted(os.listdir(snap_dir))}


def _grow(pkg, url, cycles, seed, final_last=True):
    """``cycles`` appends of 10 rows each (ids 100, 200, ... upwards)."""
    ids = []
    for cycle in range(cycles):
        extra = _token_rows(10, seed=seed + cycle, id_offset=100 * (cycle + 1))
        _append(pkg, url, extra, final=final_last and cycle == cycles - 1)
        ids += [int(r['id']) for r in extra]
    return ids


# -- snapshots ----------------------------------------------------------------------

@pytest.mark.parametrize('pkg', BOTH)
def test_publish_snapshot_and_listing(tmp_path, pkg):
    url, _ = _store(pkg, tmp_path / 'ds')
    t = PACKAGES[pkg]['tail']
    assert t.latest_snapshot(url) is None and t.list_snapshots(url) == []
    assert t.publish_snapshot(url) == 0
    assert [s for s, _ in t.list_snapshots(url)] == [0]
    info = t.latest_snapshot(url)
    assert info == {'snapshot': 0, 'final': False,
                    'pieces': [['part-00000.parquet', 0, 5], ['part-00000.parquet', 1, 5]]}
    assert t.publish_snapshot(url, final=True) == 1
    assert t.latest_snapshot(url)['final'] is True


def test_snapshot_files_and_metadata_are_the_jax_packages(tmp_path):
    # the same rows written, appended and published by each package: the
    # snapshot markers are byte-equal and so are the stored counts
    files, counts = {}, {}
    for pkg in BOTH:
        url, _ = _store(pkg, tmp_path / pkg)
        PACKAGES[pkg]['tail'].publish_snapshot(url)
        _grow(pkg, url, 2, seed=20)
        files[pkg] = _snapshot_files(url)
        counts[pkg] = jax_dm.read_metadata_dict(url)[jax_dm.ROW_GROUPS_PER_FILE_KEY]
    assert files['torch'] == files['jax']
    assert sorted(files['torch']) == ['snap-000000.json', 'snap-000001.json',
                                      'snap-000002.json']
    assert counts['torch'] == counts['jax']
    last = json.loads(files['torch']['snap-000002.json'])
    assert last['final'] is True and len(last['pieces']) == 6


@pytest.mark.parametrize('pkg', BOTH)
def test_append_writer_extends_the_store(tmp_path, pkg):
    url, rows = _store(pkg, tmp_path / 'ds')
    PACKAGES[pkg]['tail'].publish_snapshot(url)
    extra = _token_rows(10, seed=11, id_offset=100)
    assert _append(pkg, url, extra) == 1
    assert len(PACKAGES[pkg]['tail'].latest_snapshot(url)['pieces']) == 4  # cumulative
    # the whole store reads back: no part file was written over
    with make_reader(url, schema_fields=['id'], reader_pool_type='dummy') as reader:
        ids = sorted(int(r.id) for r in reader)
    assert ids == sorted(int(r['id']) for r in rows + extra)


@pytest.mark.parametrize('pkg', BOTH)
def test_publish_keeps_the_writer_usable(tmp_path, pkg):
    # each publish closes the part files: the next write opens a fresh name
    url = 'file://' + str(tmp_path / 'ds')
    writer = PACKAGES[pkg]['dm'].DatasetWriter(url, PACKAGES[pkg]['schema'],
                                               rows_per_row_group=5)
    rows = _token_rows(17, seed=3)
    snaps = []
    for start in (0, 7, 12):
        for row in rows[start:start + {0: 7, 7: 5, 12: 5}[start]]:
            writer.write(row)
        snaps.append(writer.publish(final=start == 12))
    writer.close()
    assert snaps == [0, 1, 2]
    info = PACKAGES[pkg]['tail'].latest_snapshot(url)
    # 7 rows -> groups of 5 and 2; then 5; then 5
    assert info['pieces'] == [['part-00000.parquet', 0, 5], ['part-00000.parquet', 1, 2],
                              ['part-00001.parquet', 0, 5], ['part-00002.parquet', 0, 5]]
    with pytest.raises(PACKAGES[pkg]['error'], match='closed'):
        writer.publish()


@pytest.mark.parametrize('pkg', BOTH)
def test_publish_needs_an_inventory(tmp_path, pkg):
    (tmp_path / 'empty').mkdir()
    with pytest.raises(PACKAGES[pkg]['error'], match='no row-group inventory'):
        PACKAGES[pkg]['tail'].publish_snapshot('file://' + str(tmp_path / 'empty'))


@pytest.mark.parametrize('pkg', BOTH)
def test_torn_and_foreign_markers_are_skipped(tmp_path, pkg):
    url, _ = _store(pkg, tmp_path / 'ds')
    t = PACKAGES[pkg]['tail']
    t.publish_snapshot(url)
    snap_dir = tmp_path / 'ds' / '_snapshots'
    (snap_dir / 'snap-000001.json').write_text('{"snapshot": 1, "pie')  # torn mid-write
    (snap_dir / 'snap-000002.json').write_text('{"snapshot": 7, "pieces": []}')  # id mismatch
    (snap_dir / 'notes.json').write_text('{}')
    (snap_dir / 'snap-000003.json.tmp.1').write_text('{}')
    assert [s for s, _ in t.list_snapshots(url)] == [0]
    # the next publish never replaces a marker: ids 1 and 2 are taken by
    # the torn and the mismatched files, so it takes 3
    assert t.publish_snapshot(url) == 3
    assert [s for s, _ in t.list_snapshots(url)] == [0, 3]


# -- following ----------------------------------------------------------------------

@pytest.mark.parametrize('writer,follower', PAIRS)
def test_exactly_once_across_cycles(tmp_path, writer, follower):
    url, rows = _store(writer, tmp_path / 'ds')
    PACKAGES[writer]['tail'].publish_snapshot(url)
    expected = [int(r['id']) for r in rows] + _grow(writer, url, 3, seed=20)
    with _follower(follower, url) as t:
        ids = [int(r.id) for r in t]
        diag = t.diagnostics
    assert ids == expected  # in snapshot order, rows in file order
    assert diag['dataset_grew'] == 4  # the first snapshot + 3 growths
    assert diag['tail_rows_delivered'] == len(expected)
    assert diag['tail_snapshot'] == 3 and diag['tail_pieces_delivered'] == 8


def test_follower_ids_and_diagnostics_match_jax(tmp_path):
    url, _ = _store('jax', tmp_path / 'ds')
    jax_tail.publish_snapshot(url)
    _grow('jax', url, 2, seed=30)
    out = {}
    for pkg in BOTH:
        with _follower(pkg, url, schema_fields=['id']) as t:
            ids = [int(r.id) for r in t]
            diag = t.diagnostics
        out[pkg] = (ids, {k: v for k, v in diag.items()
                          if k.startswith('tail_') or k == 'dataset_grew'})
    assert out['torch'] == out['jax']


@pytest.mark.parametrize('writer,follower', PAIRS)
def test_concurrent_writer(tmp_path, writer, follower):
    url, rows = _store(writer, tmp_path / 'ds')
    PACKAGES[writer]['tail'].publish_snapshot(url)
    expected = {int(r['id']) for r in rows}
    lock = threading.Lock()

    def grow():
        for cycle in range(3):
            time.sleep(0.1)
            extra = _token_rows(10, seed=40 + cycle, id_offset=100 * (cycle + 1))
            with lock:
                expected.update(int(r['id']) for r in extra)
            _append(writer, url, extra, final=cycle == 2)

    thread = threading.Thread(target=grow)
    thread.start()
    try:
        with _follower(follower, url) as t:
            ids = [int(r.id) for r in t]
            grew = t.diagnostics['dataset_grew']
    finally:
        thread.join()
    assert len(ids) == len(set(ids)), 'a row delivered twice'
    assert set(ids) == expected
    assert 2 <= grew <= 4


def _first_then_rest(pkg_first, pkg_rest, url, take, **kwargs):
    first_tail = _follower(pkg_first, url, **kwargs)
    first = [int(x) for _ in range(take) for x in np.atleast_1d(next(first_tail).id)]
    state = pickle.loads(pickle.dumps(first_tail.state_dict()))
    first_tail.stop()
    first_tail.join()
    with _follower(pkg_rest, url, resume_state=state, **kwargs) as resumed:
        rest = [int(x) for item in resumed for x in np.atleast_1d(item.id)]
    return first, rest, state


@pytest.mark.parametrize('first,rest', PAIRS)
def test_checkpoint_resume(tmp_path, first, rest):
    # 15 rows: 3 whole 5-row groups, inside the second delta
    url, rows = _store('torch', tmp_path / 'ds')
    tail.publish_snapshot(url)
    expected = [int(r['id']) for r in rows] + _grow('torch', url, 2, seed=60)
    got_first, got_rest, state = _first_then_rest(first, rest, url, 15)
    assert got_first + got_rest == expected
    assert state['version'] == 1
    assert state['current_delta'] == [('part-00001.parquet', 0), ('part-00001.parquet', 1)]
    assert state['delivered'] == [('part-00000.parquet', 0), ('part-00000.parquet', 1)]


def test_state_dicts_match_jax(tmp_path):
    url, _ = _store('jax', tmp_path / 'ds')
    jax_tail.publish_snapshot(url)
    _grow('jax', url, 2, seed=61)
    states = {}
    for pkg in BOTH:
        with _follower(pkg, url, output='columnar') as t:
            for _ in range(3):
                next(t)
            states[pkg] = t.state_dict()
    inner = {pkg: states[pkg].pop('inner') for pkg in BOTH}
    assert states['torch'] == states['jax']
    assert inner['torch']['remaining_global_parts'] == inner['jax']['remaining_global_parts']


def test_columnar_resume_delivers_the_rest_once(tmp_path):
    url, rows = _store('torch', tmp_path / 'ds')
    tail.publish_snapshot(url)
    expected = [int(r['id']) for r in rows] + _grow('torch', url, 2, seed=62)
    first, rest, _ = _first_then_rest('torch', 'torch', url, 3, output='columnar')
    assert sorted(first + rest) == sorted(expected) and len(first) == 15


def test_columnar_ngram_rows_count_as_jax(tmp_path):
    # the JAX package counts a columnar NGram block through len() of its
    # first offset's dict of fields; the port keeps that count
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu_torch.ngram import NGram

    url, _ = _store('torch', tmp_path / 'ds')
    tail.publish_snapshot(url)
    _grow('torch', url, 1, seed=63)
    counts = {}
    for pkg, cls in (('torch', NGram), ('jax', JaxNGram)):
        ngram = cls({0: ['id'], 1: ['id']}, delta_threshold=1, timestamp_field='id')
        with _follower(pkg, url, output='columnar', ngram=ngram) as t:
            blocks = list(t)
            counts[pkg] = (len(blocks), t.diagnostics['tail_rows_delivered'])
    assert counts['torch'] == counts['jax']
    assert counts['torch'][1] == counts['torch'][0]  # one field: 1 per block


@pytest.mark.parametrize('pkg', BOTH)
def test_idle_timeout(tmp_path, pkg):
    url, _ = _store(pkg, tmp_path / 'ds')
    PACKAGES[pkg]['tail'].publish_snapshot(url)  # never final
    t = _follower(pkg, url, idle_timeout=0.2)
    try:
        with pytest.raises(PACKAGES[pkg]['error'], match='idle_timeout'):
            for _ in t:
                pass
    finally:
        t.stop()
        t.join()
    assert t.diagnostics['tail_rows_delivered'] == 10


@pytest.mark.parametrize('pkg', BOTH)
@pytest.mark.parametrize('kwargs,match', [
    ({'num_epochs': 3}, 'num_epochs'), ({'piece_filter': None}, 'piece_filter'),
    ({'poll_interval': 0}, 'poll_interval'),
    ({'resume_state': {'version': 2}}, 'Unrecognized resume_state')])
def test_refusals(tmp_path, pkg, kwargs, match):
    url, _ = _store(pkg, tmp_path / 'ds')
    with pytest.raises(PACKAGES[pkg]['error'], match=match):
        PACKAGES[pkg]['tail'].TailFollowingReader(url, **kwargs)


def test_stop_ends_the_stream_and_keys_are_present_before_any_read(tmp_path):
    url, _ = _store('torch', tmp_path / 'ds')
    tail.publish_snapshot(url)
    t = _follower('torch', url, output='columnar')
    assert t.batched_output
    assert {k: t.diagnostics[k] for k in ('dataset_grew', 'tail_snapshot',
                                          'tail_pieces_delivered', 'tail_rows_delivered')} == \
        {'dataset_grew': 0, 'tail_snapshot': -1, 'tail_pieces_delivered': 0,
         'tail_rows_delivered': 0}
    next(t)
    t.stop()
    t.join()
    with pytest.raises(StopIteration):
        while True:
            next(t)
    assert not _follower('torch', url).batched_output


def test_duty_cycle_over_a_tail_reports_its_open_deltas_pool(tmp_path):
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    url, _ = _store('torch', tmp_path / 'ds')
    tail.publish_snapshot(url)
    _grow('torch', url, 2, seed=64)
    tails = []

    def factory(url, num_epochs=None, **kwargs):
        # the tail owns its epochs: the helper's num_epochs is not its
        tails.append(tail.TailFollowingReader(url, poll_interval=POLL, idle_timeout=30,
                                              schema_fields=['id'], output='columnar',
                                              **kwargs))
        return tails[-1]

    result = pipeline_duty_cycle(url, lambda ids: None, lambda b: (b['id'],), batch_size=5,
                                 steps=3, warmup_steps=1, device='cpu', reader_factory=factory,
                                 reader_kwargs={'reader_pool_type': 'dummy',
                                                'shuffle_row_groups': False})
    assert result.extra['pool'] is None or isinstance(result.extra['pool'], dict)
    assert result.extra['diagnostics']['dataset_grew'] >= 2
    assert tails[0].diagnostics['tail_rows_delivered'] >= 20


def test_smoke_tail_checks_at_small_size(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s ``tail_checks`` on the CPU: a writer process fills
    a 256-row store (2 snapshots) while the tail follows it."""
    import json

    import chip_smoke

    monkeypatch.setattr(chip_smoke, 'ROWS', 256)
    chip_smoke.phase_tail_checks(str(tmp_path))
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"tail_checks"' in ln][-1])
    assert line['writer_rc'] == 0 and line['concurrent']['writer']['snapshots'] == [0, 1]
    assert line['concurrent']['every_row_once'] and line['concurrent']['dataset_grew'] == 2
    assert line['resume']['inside_a_delta'] and line['resume']['every_row_once']
    assert line['torn']['listed'] == [0, 1] and line['idle_timeout']['raised']
