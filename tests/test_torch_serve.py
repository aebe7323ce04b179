"""Port parity: the shared reader service of petastorm_tpu_torch against the
JAX package's, case for case with ``tests/test_serve.py``.

* The fair-share scheduler: both packages' ``FairShareVentilator`` dispatch
  the same (tenant, item, seq) sequence and fire the same done callbacks for
  the same tenants, weights, budgets and completions; the threaded cases of
  ``tests/test_serve.py`` run on both.
* The service: an in-process :class:`ReaderService` (no subprocess, a few MiB
  of ring, under ``tmp_path``, shut down in ``finally``) serves the suite's
  stores; its rows equal the port's private reader's and the JAX served
  reader's as sets per epoch (a two-worker fleet completes row groups in no
  fixed order). Two tenants share one decode; a late joiner gets a suffix; a
  detach or a slow consumer stalls nobody; the blob plane is exact and
  collected; the refusals match.
* Three tests spawn the real daemon (``python -m petastorm_tpu_torch.serve``)
  through ``make_reader(serve=<dir>)`` as a user does; each ends it and
  checks that its pid is gone and no ``/dev/shm`` segment of it is left (one
  SIGKILLs it, and the next daemon's start reaps its rings). One
  more runs the daemon's entry point in a fresh interpreter and checks that
  it imports neither ``torch`` nor ``jax`` nor ``petastorm_tpu``.
"""

import glob
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.serve.client import default_service_dir as jax_default_service_dir
from petastorm_tpu.serve.service import ReaderService as JaxReaderService
from petastorm_tpu.serve.service import canonical_stream_id as jax_canonical_stream_id
from petastorm_tpu.workers.ventilator import FairShareVentilator as JaxFairShareVentilator
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.columnar import BatchResultsQueueReader
from petastorm_tpu_torch.errors import (ConsumerEvictedError, EmptyResultError,
                                        ServeDaemonDiedError, ServeError)
from petastorm_tpu_torch.native import read_routes
from petastorm_tpu_torch.native.shm_ring import BcastRing
from petastorm_tpu_torch.row_worker import RowResultsQueueReader
from petastorm_tpu_torch.serve import (ReaderService, ServedReader, canonical_stream_id,
                                       connect_service, default_service_dir)
from petastorm_tpu_torch.serve.client import _pid_alive, _ServedPoolFacade
from petastorm_tpu_torch.serve.service import read_endpoint
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.workers import FairShareVentilator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENTILATORS = {'jax': JaxFairShareVentilator, 'torch': FairShareVentilator}
#: the in-process services' ring: a few MiB, not the daemon's 64 MiB default
RING_BYTES = 4 << 20


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


def _own_shm_entries():
    """The ``/dev/shm`` rings and blob dirs named after this process."""
    tag = '_{}_'.format(os.getpid())
    return {e for e in os.listdir('/dev/shm') if e.startswith('pstpu') and tag in e}


@pytest.fixture(autouse=True)
def _leave_no_shm_segment():
    before = _own_shm_entries()
    yield
    assert _own_shm_entries() - before == set()


def _base_spec(url, **overrides):
    spec = dict(dataset_url=url, batch_reader=False, schema_fields=None, seed=0,
                shuffle_row_groups=False, shuffle_row_drop_partitions=1, predicate=None,
                rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                transform_spec=None, ngram=None, columnar_ngram=False,
                storage_retry_policy=None, chunk_cache=None, chunk_cache_size_limit=None,
                cache=None)
    spec.update(overrides)
    return spec


def _make_service(tmp_path, package='torch', name='svc', **kwargs):
    defaults = dict(pool_type='thread', workers_count=2, idle_timeout_s=None,
                    ring_bytes=RING_BYTES)
    defaults.update(kwargs)
    cls = ReaderService if package == 'torch' else JaxReaderService
    svc = cls(str(tmp_path / name), **defaults)
    svc.start()
    return svc


def _stop_jax_service(svc):
    """Shut a JAX in-process service down, its accept thread included:
    closing a listening socket does not wake a thread blocked in accept(), so
    one connection is made just before the close (the JAX ``shutdown`` sets
    its flag first, so the woken loop exits)."""
    from multiprocessing.connection import Client
    listener = svc._listener
    close = listener.close

    def wake_then_close():
        try:
            Client(listener.address, family='AF_UNIX').close()
        except OSError:
            pass
        close()

    listener.close = wake_then_close
    svc.shutdown()


def _facade(reply):
    ring = BcastRing.attach(reply['ring_name'])
    return ring, _ServedPoolFacade(ring, reply['token'], reply['daemon_pid'],
                                   reply['tenant_id'])


def _consume_rows(reply, out, key, limit=None):
    """Drain one attached consumer's stream of rows into ``out[key]``."""
    ring, facade = _facade(reply)
    reader = RowResultsQueueReader(reply['client_plan']['transformed_schema'])
    rows = []
    try:
        while limit is None or len(rows) < limit:
            rows.append(reader.read_next(facade))
    except EmptyResultError:
        pass
    finally:
        out[key] = rows
        out[key + '_frames'] = facade.frames
        ring.close()


def _drain_in_threads(jobs, timeout=90):
    threads = [threading.Thread(target=fn, args=args) for fn, args in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), 'consumers hung'


def _row_key(row):
    return int(row.id), np.asarray(row.matrix).tobytes()


# -- the fair-share scheduler ----------------------------------------------------------

#: scripted runs: tenants (id, items, epochs, weight, budget, shuffle seed),
#: how many dispatches stay in flight before the oldest completes, and the
#: run-time edits keyed by the dispatch count at which they happen
SCENARIOS = {
    'weights': dict(tenants=[('a', 6, 1, 2, 100, None), ('b', 6, 1, 1, 100, None)],
                    window=100, edits={}),
    'budgets': dict(tenants=[('a', 5, 2, 1, 2, 3), ('b', 5, 2, 3, 1, 4), ('c', 5, 2, 1, 3, 5)],
                    window=3, edits={}),
    'edits': dict(tenants=[('a', 8, 1, 1, 2, None), ('b', 8, 3, 1, 2, 9)],
                  window=2, edits={4: ('remove', 'a'), 6: ('weight', 'b', 3),
                                   7: ('add', ('c', 4, 2, 2, 1, 11))}),
    'empty_and_infinite': dict(tenants=[('a', 0, 1, 1, 1, None), ('b', 3, None, 2, 2, 1),
                                        ('c', 2, 0, 1, 1, None)],
                               window=2, edits={12: ('remove', 'b')}),
}


def _dispatch_sequence(package, scenario):
    """Run one scenario through a package's ventilator on this thread (the
    scheduler's own pick, no feeding thread, so the run is deterministic):
    the dispatches, the done callbacks and the final counters."""
    sc = SCENARIOS[scenario]
    done = []
    fsv = VENTILATORS[package](lambda **kw: None, on_tenant_done=done.append)

    def add(tid, n_items, epochs, weight, budget, seed):
        fsv.add_tenant(tid, [{'i': i} for i in range(n_items)], iterations=epochs,
                       weight=weight, max_in_flight=budget, shuffle=seed is not None,
                       seed=seed)

    for tenant in sc['tenants']:
        add(*tenant)
    seq_log, in_flight = [], []
    for _ in range(200):
        edit = sc['edits'].get(len(seq_log))
        if edit is not None and edit[0] == 'remove':
            fsv.remove_tenant(edit[1])
        elif edit is not None and edit[0] == 'weight':
            fsv.set_tenant_weight(edit[1], edit[2])
        elif edit is not None and edit[0] == 'add':
            add(*edit[1])
        with fsv._cv:
            picked = fsv._pick_next()
        if picked is None:
            if not in_flight:
                break
        else:
            tq, item, seq = picked
            seq_log.append((tq.tenant_id, item['i'], seq))
            in_flight.append(seq)
        if picked is None or len(in_flight) >= sc['window']:
            fsv.processed_item(in_flight.pop(0))
    return seq_log, done, fsv.tenant_stats()


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_fairshare_dispatch_sequence_equals_jax(scenario):
    ours = _dispatch_sequence('torch', scenario)
    theirs = _dispatch_sequence('jax', scenario)
    assert ours == theirs
    seq_log, done, _stats = ours
    assert [s for _, _, s in seq_log] == list(range(len(seq_log)))
    assert len(set(done)) == len(done)


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_fairshare_weighted_round_robin_and_budgets(package):
    dispatched, done = [], []
    fsv = VENTILATORS[package](lambda **kw: dispatched.append(kw), on_tenant_done=done.append)
    fsv.start()
    try:
        fsv.add_tenant('a', [{'i': n} for n in range(6)], iterations=1, weight=2,
                       max_in_flight=100)
        fsv.add_tenant('b', [{'i': n} for n in range(6)], iterations=1, weight=1,
                       max_in_flight=100)
        deadline = time.monotonic() + 5
        while len(dispatched) < 12 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(dispatched) == 12
        order = [fsv.tenant_of_seq(kw['_seq']) for kw in dispatched]
        assert set(order) <= {'a', 'b', None}
        assert 'b' in [t for t in order[:9] if t is not None][:4], order  # starvation-free
        for kw in dispatched:
            fsv.processed_item(kw['_seq'])
        deadline = time.monotonic() + 5
        while len(done) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(done) == ['a', 'b']
    finally:
        fsv.stop()


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_fairshare_in_flight_budget_gates_dispatch(package):
    dispatched = []
    fsv = VENTILATORS[package](lambda **kw: dispatched.append(kw))
    fsv.start()
    try:
        fsv.add_tenant('a', [{'i': n} for n in range(10)], iterations=1, weight=1,
                       max_in_flight=2)
        time.sleep(0.3)
        assert len(dispatched) == 2  # admission control: the budget caps in-flight
        fsv.processed_item(dispatched[0]['_seq'])
        deadline = time.monotonic() + 5
        while len(dispatched) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(dispatched) == 3
        stats = fsv.tenant_stats()['a']
        assert stats['in_flight'] == 2 and stats['dispatched'] == 3
    finally:
        fsv.stop()


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_fairshare_remove_tenant_mid_epoch_drains_silently(package):
    dispatched, done = [], []
    fsv = VENTILATORS[package](lambda **kw: dispatched.append(kw), on_tenant_done=done.append)
    fsv.start()
    try:
        fsv.add_tenant('a', [{'i': n} for n in range(50)], iterations=1, weight=1,
                       max_in_flight=2)
        deadline = time.monotonic() + 5
        while len(dispatched) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fsv.remove_tenant('a')
        n_at_removal = len(dispatched)
        for kw in list(dispatched):
            fsv.processed_item(kw['_seq'])
        time.sleep(0.2)
        assert len(dispatched) == n_at_removal  # nothing new fed
        assert done == []                       # a removed tenant never finishes
        final = fsv.tenant_stats()['a']
        assert final['removed'] and final['in_flight'] == 0
    finally:
        fsv.stop()


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_fairshare_skewed_demand_respects_weights(package):
    order, dispatched = [], []
    lock = threading.Lock()

    def record(**kw):
        with lock:
            dispatched.append(kw['_seq'])
            order.append(fsv.tenant_of_seq(kw['_seq']))

    fsv = VENTILATORS[package](record)
    fsv.start()
    try:
        fsv.add_tenant('heavy', [{'i': n} for n in range(40)], iterations=1, weight=2,
                       max_in_flight=100)
        fsv.add_tenant('light', [{'i': n} for n in range(40)], iterations=1, weight=1,
                       max_in_flight=100)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with lock:
                if len(order) >= 60:
                    break
            time.sleep(0.005)
        with lock:
            prefix = order[:30]
        # every 3-dispatch cycle is 2 heavy + 1 light while both have backlog
        # (with jitter from the race of add_tenant and the first refill)
        assert 17 <= prefix.count('heavy') <= 23, prefix
        for i in range(0, 27, 3):
            assert 'light' in prefix[i:i + 4], prefix
        for seq in dispatched:
            fsv.processed_item(seq)
    finally:
        fsv.stop()


def test_stream_spec_canonicalization_equals_jax():
    a, b = _base_spec('file:///data/x'), _base_spec('file:///data/x')
    c = _base_spec('file:///data/x', num_epochs=2)
    assert canonical_stream_id(a) == canonical_stream_id(b) == jax_canonical_stream_id(a)
    assert canonical_stream_id(c) == jax_canonical_stream_id(c) != canonical_stream_id(a)


# -- the service, in process -------------------------------------------------------------

def test_one_tenant_equals_the_private_reader_and_the_jax_daemon(tmp_path, synthetic_dataset):
    url = synthetic_dataset.url
    epochs = 2
    svc = _make_service(tmp_path)
    jax_svc = _make_service(tmp_path, package='jax', name='jax_svc')
    try:
        with make_reader(url, serve=svc.service_dir, seed=0, num_epochs=epochs,
                         workers_count=2) as served:
            assert isinstance(served, ServedReader)
            ours = [_row_key(r) for r in served]
            assert served.last_row_consumed
        with make_reader(url, seed=0, num_epochs=epochs, workers_count=2) as private:
            plain = [_row_key(r) for r in private]
        with jax_make_reader(url, serve=jax_svc.service_dir, seed=0, num_epochs=epochs,
                             workers_count=2) as jax_served:
            theirs = [_row_key(r) for r in jax_served]
    finally:
        svc.shutdown()
        _stop_jax_service(jax_svc)
    n = len(synthetic_dataset.data)
    assert len(ours) == len(plain) == len(theirs) == epochs * n
    # the same rows, each once per epoch; a two-worker fleet completes row
    # groups in no fixed order, across the epoch boundary too
    assert sorted(ours) == sorted(plain) == sorted(theirs)
    assert sorted(set(ours)) == sorted(ours)[::epochs]


def test_one_worker_fleet_serves_the_private_order(tmp_path, synthetic_dataset):
    svc = _make_service(tmp_path, workers_count=1)
    try:
        with make_reader(synthetic_dataset.url, serve=svc.service_dir, seed=3,
                         shuffle_row_groups=True, output='columnar') as served:
            ours = [b.id.tolist() for b in served]
    finally:
        svc.shutdown()
    with make_reader(synthetic_dataset.url, seed=3, shuffle_row_groups=True,
                     output='columnar', reader_pool_type='dummy') as private:
        assert ours == [b.id.tolist() for b in private]


def test_two_tenants_share_one_decode(tmp_path, synthetic_dataset):
    svc = _make_service(tmp_path)
    try:
        spec = _base_spec(synthetic_dataset.url)
        r1, r2 = svc.attach(dict(spec)), svc.attach(dict(spec))
        assert r1['stream_id'] == r2['stream_id']
        out = {}
        _drain_in_threads([(_consume_rows, (r1, out, 'a')), (_consume_rows, (r2, out, 'b'))])
        n = len(synthetic_dataset.data)
        assert len(out['a']) == len(out['b']) == n
        assert sorted(map(_row_key, out['a'])) == sorted(map(_row_key, out['b']))
        stats = svc.stats()
        stream = stats['streams'][r1['stream_id']]
        # one decode served both: each row group decoded once, and every
        # batch of the second tenant is a shared-decode hit
        assert stream['decoded_batches'] == 10
        assert sum(t['shared_decode_hits'] for t in stream['tenants'].values()) == 10
        assert stats['pool']['items_completed'] == 10
    finally:
        svc.shutdown()


def test_attach_mid_epoch_gets_a_suffix(tmp_path, synthetic_dataset):
    svc = _make_service(tmp_path)
    try:
        spec = _base_spec(synthetic_dataset.url, num_epochs=3)
        r1 = svc.attach(dict(spec))
        out = {}
        t1 = threading.Thread(target=_consume_rows, args=(r1, out, 'a'))
        t1.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if svc.stats()['streams'].get(r1['stream_id'], {}).get('decoded_batches', 0) >= 2:
                break
            time.sleep(0.01)
        r2 = svc.attach(dict(spec))
        assert r2['stream_id'] == r1['stream_id']
        _drain_in_threads([(_consume_rows, (r2, out, 'b'))], timeout=120)
        t1.join(120)
        assert not t1.is_alive()
        n = len(synthetic_dataset.data)
        assert len(out['a']) == 3 * n          # the first tenant lost nothing
        assert 0 < len(out['b']) < 3 * n       # the late joiner got a suffix
        assert set(map(_row_key, out['b'])) <= set(map(_row_key, out['a']))
        tenants = svc.stats()['streams'][r1['stream_id']]['tenants']
        assert tenants[r2['tenant_id']]['joined_shared']
    finally:
        svc.shutdown()


def test_detach_mid_epoch_never_stalls_the_others(tmp_path, synthetic_dataset):
    svc = _make_service(tmp_path)
    try:
        spec = _base_spec(synthetic_dataset.url, num_epochs=2)
        r1, r2 = svc.attach(dict(spec)), svc.attach(dict(spec))
        out = {}
        t1 = threading.Thread(target=_consume_rows, args=(r1, out, 'a'))
        t1.start()
        _consume_rows(r2, out, 'b', limit=5)
        assert svc.detach(r2['tenant_id'])
        assert not svc.detach(r2['tenant_id'])
        t1.join(120)
        assert not t1.is_alive()
        assert len(out['a']) == 2 * len(synthetic_dataset.data)
        assert len(out['b']) == 5
    finally:
        svc.shutdown()


def test_slow_consumer_is_evicted_not_stalling(tmp_path, scalar_dataset):
    svc = _make_service(tmp_path, ring_bytes=65536, evict_block_s=0.3)
    try:
        spec = _base_spec(scalar_dataset.url, batch_reader=True, num_epochs=30)
        r_fast, r_slow = svc.attach(dict(spec)), svc.attach(dict(spec))
        ring, facade = _facade(r_fast)
        reader = BatchResultsQueueReader(r_fast['client_plan']['transformed_schema'])
        batches = 0
        with pytest.raises(EmptyResultError):
            while True:
                reader.read_next(facade)
                batches += 1
        assert batches == 300  # the fast consumer got every batch
        slow_ring, slow_facade = _facade(r_slow)
        with pytest.raises(ConsumerEvictedError) as e:
            while True:
                slow_facade.get_results()
        assert e.value.tenant_id == r_slow['tenant_id']
        stats = svc.stats()
        assert stats['evictions'] == 1
        assert stats['streams'][r_slow['stream_id']]['tenants'][r_slow['tenant_id']]['evicted']
        ring.close()
        slow_ring.close()
    finally:
        svc.shutdown()


def test_multi_stream_fair_share_occupancy(tmp_path, synthetic_dataset, scalar_dataset):
    svc = _make_service(tmp_path)
    try:
        r1 = svc.attach(_base_spec(synthetic_dataset.url), weight=1)
        r2 = svc.attach(_base_spec(scalar_dataset.url, batch_reader=True), weight=2)
        assert r1['stream_id'] != r2['stream_id']
        out = {}

        def consume_batches():
            ring, facade = _facade(r2)
            reader = BatchResultsQueueReader(r2['client_plan']['transformed_schema'])
            got = []
            try:
                while True:
                    got.append(reader.read_next(facade))
            except EmptyResultError:
                pass
            out['b'] = got
            ring.close()

        _drain_in_threads([(_consume_rows, (r1, out, 'a')), (consume_batches, ())], timeout=120)
        assert len(out['a']) == len(synthetic_dataset.data)
        assert sum(len(b[0]) for b in out['b']) == 100
        occupancy = [s['fair_share'].get('occupancy', 0)
                     for s in svc.stats()['streams'].values()]
        assert 0.99 < sum(occupancy) <= 1.01
    finally:
        svc.shutdown()


@pytest.mark.parametrize('route', ['fused', 'blob'])
def test_blob_plane_is_exact_and_collected(tmp_path, monkeypatch, route):
    """Batches over the blob threshold ride /dev/shm blobs: the fused decode
    lands them there (SERVE_COLS) or, with that route off, the in-place
    reservation does (SERVE_BLOB); the values are exact and the daemon's GC
    removes every file once every consumer read past it."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_petastorm_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('B', [
        UnischemaField('i', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('t', np.uint8, (64, 64, 3), NdarrayCodec(), False),
    ])
    url = 'file://' + str(tmp_path / 'store')
    rng = np.random.default_rng(7)
    rows = [{'i': i, 't': rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)} for i in range(20)]
    write_petastorm_dataset(url, schema, iter(rows), rows_per_row_group=10)
    if route == 'blob':
        monkeypatch.setenv('PSTPU_SERVE_FUSED_BLOB', '0')
    from petastorm_tpu_torch.serve import client
    mapped = []
    map_blob = client._map_blob

    def counting_map_blob(path, size, tenant_id):
        mapped.append(path)
        return map_blob(path, size, tenant_id)

    monkeypatch.setattr(client, '_map_blob', counting_map_blob)
    before = read_routes.snapshot()
    svc = _make_service(tmp_path, blob_threshold_bytes=1, blob_gc_grace_s=0.05)
    blob_dir = svc._blob_dir
    try:
        assert blob_dir is not None
        spec = _base_spec(url)
        r1, r2 = svc.attach(dict(spec)), svc.attach(dict(spec))
        out = {}
        _drain_in_threads([(_consume_rows, (r1, out, 'a')), (_consume_rows, (r2, out, 'b'))],
                          timeout=60)
        assert len(out['a']) == len(out['b']) == 20
        for key in 'ab':
            by_id = {int(row.i): row for row in out[key]}
            for want in rows:
                np.testing.assert_array_equal(by_id[want['i']].t, want['t'])
                assert by_id[want['i']].t.flags.writeable
        after = read_routes.snapshot()
        routes = {k: v - before.get(k, 0) for k, v in after.items()}
        # each batch rode one blob, mapped by each consumer
        assert len(mapped) == 4 and len(set(mapped)) == 2
        assert routes.get('serve_fused_blob_batches_total', 0) == (2 if route == 'fused' else 0)
        kind = 'cols' if route == 'fused' else 'blob'
        assert out['a_frames'] == out['b_frames'] == dict({'data': 0, 'blob': 0, 'cols': 0},
                                                          **{kind: 2})
        deadline = time.monotonic() + 10
        while glob.glob(os.path.join(blob_dir, '*')) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not glob.glob(os.path.join(blob_dir, '*'))
        del out, by_id
    finally:
        svc.shutdown()
    assert not os.path.isdir(blob_dir)


def test_batch_reader_serve_on_a_plain_parquet_store(tmp_path, scalar_dataset):
    svc = _make_service(tmp_path)
    jax_svc = _make_service(tmp_path, package='jax', name='jax_svc')
    try:
        with make_batch_reader(scalar_dataset.url, serve=svc.service_dir, seed=1,
                               batch_size=16) as served:
            assert isinstance(served, ServedReader) and served.batched_output
            ours = [b._asdict() for b in served]
        with jax_make_batch_reader(scalar_dataset.url, serve=jax_svc.service_dir, seed=1,
                                   batch_size=16) as jax_served:
            theirs = [b._asdict() for b in jax_served]
    finally:
        svc.shutdown()
        _stop_jax_service(jax_svc)
    with make_batch_reader(scalar_dataset.url, seed=1, batch_size=16) as private:
        plain = [b._asdict() for b in private]
    assert [len(b['id']) for b in ours][:-1] == [16] * 6

    def rows(batches):
        return sorted(tuple(np.asarray(b[name][k]).tobytes() for name in sorted(b))
                      for b in batches for k in range(len(b['id'])))

    assert rows(ours) == rows(plain) == rows(theirs)
    assert len(rows(ours)) == 100


def test_torch_data_loader_consumes_a_served_reader(tmp_path, synthetic_dataset):
    svc = _make_service(tmp_path)
    try:
        with make_reader(synthetic_dataset.url, serve=svc.service_dir, seed=0,
                         output='columnar', serve_weight=2) as served:
            loader = TorchDataLoader(served, batch_size=25, shuffling_queue_capacity=50, seed=1)
            ids = sorted(int(i) for batch in loader for i in batch['id'])
            with pytest.raises(ServeError, match='state_dict'):
                loader.state_dict()
            with pytest.raises(ServeError, match='reset'):
                served.reset()
            diag = served.diagnostics
            assert diag['serve_tenant_weight'] == 2
            assert diag['serve_stream_decoded_batches'] == 10
            assert diag['serve_batches_received'] == 10
            assert served.quarantined_items == []
    finally:
        svc.shutdown()
    assert ids == sorted(int(r['id']) for r in synthetic_dataset.data)


class _FakeConn(object):
    """A control connection whose attach succeeds without a daemon."""

    def send(self, msg):
        self.msg = msg

    def recv(self):
        return {'ok': True}


def test_unsupported_combinations_are_refused(tmp_path, synthetic_dataset, monkeypatch):
    url, svc_dir = synthetic_dataset.url, str(tmp_path / 'never')
    with pytest.raises(ValueError, match='resume_state'):
        make_reader(url, serve=svc_dir, resume_state={'version': 1})
    with pytest.raises(ValueError, match='autotune'):
        make_reader(url, serve=svc_dir, autotune=True)
    with pytest.raises(ValueError, match='piece_filter'):
        make_batch_reader(url, serve=svc_dir, piece_filter=lambda p: True)
    for factory in (make_reader, make_batch_reader):
        with pytest.raises(ValueError, match='elastic is not supported with serve='):
            factory(url, serve=svc_dir, elastic=object())
    # remote stores are ported: as in the JAX package, the served spec
    # carries chunk_cache and the storage retry policy to the daemon, and
    # the daemon's plan resolves the cache for a remote store only
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig
    from petastorm_tpu_torch.retry import RetryPolicy
    from petastorm_tpu_torch.serve import client as serve_client
    specs = []
    monkeypatch.setattr(serve_client, 'make_served_reader',
                        lambda spec, *args, **kwargs: specs.append(spec))
    policy = RetryPolicy(max_attempts=2)
    for factory in (make_reader, make_batch_reader):
        factory(url, serve=svc_dir, chunk_cache='/tmp/chunks', storage_retry_policy=policy,
                chunk_cache_size_limit=1 << 20)
    assert [(s['chunk_cache'], s['storage_retry_policy'], s['chunk_cache_size_limit'])
            for s in specs] == [('/tmp/chunks', policy, 1 << 20)] * 2
    monkeypatch.undo()
    from petastorm_tpu_torch.serve.plan import build_read_plan
    assert build_read_plan(url, chunk_cache='/tmp/chunks').chunk_cache_config is None
    remote = build_read_plan('mock-remote://' + url[len('file://'):], chunk_cache='/tmp/chunks',
                             chunk_cache_size_limit=1 << 20)
    assert remote.chunk_cache_config == ChunkCacheConfig('/tmp/chunks',
                                                         size_limit_bytes=1 << 20)
    assert remote.worker_args['chunk_cache'] == remote.chunk_cache_config
    # the serve monitor is ported: the daemon side resolves it as the JAX
    # package's does, explicitly or from either variable, and the consumer
    # side is handed to the served reader's facade
    from petastorm_tpu_torch.analysis.protocol.monitor import ServeMonitor
    assert isinstance(ReaderService(svc_dir, monitor=True).monitor, ServeMonitor)
    assert ReaderService(svc_dir).monitor is None
    for name in ('PSTPU_SERVE_MONITOR', 'PSTPU_PROTOCOL_MONITOR'):
        monkeypatch.setenv(name, '1')
        assert isinstance(ReaderService(svc_dir).monitor, ServeMonitor)
        monkeypatch.delenv(name)
    handed = []
    monkeypatch.setattr(serve_client, 'connect_service', lambda *a, **k: _FakeConn())
    monkeypatch.setattr(serve_client, 'ServedReader',
                        lambda *args, **kwargs: handed.append(kwargs['monitor']))
    serve_client.make_served_reader({}, svc_dir, None, monitor=True)
    assert isinstance(handed[0], ServeMonitor)
    assert not os.path.exists(svc_dir)   # no daemon was started


def test_auto_service_dir_is_not_the_jax_packages(monkeypatch):
    for name in ('PSTPU_TORCH_SERVE_DIR', 'PSTPU_SERVE_DIR'):
        monkeypatch.delenv(name, raising=False)
    ours, theirs = default_service_dir(), jax_default_service_dir()
    assert ours != theirs
    assert os.path.basename(ours) == 'pstpu-torch-serve-{}'.format(os.getuid())
    monkeypatch.setenv('PSTPU_SERVE_DIR', '/tmp/shared-jax-dir')
    assert default_service_dir() == ours           # the JAX override is not the port's
    monkeypatch.setenv('PSTPU_TORCH_SERVE_DIR', '/tmp/port-dir')
    assert default_service_dir() == '/tmp/port-dir'
    assert jax_default_service_dir() == '/tmp/shared-jax-dir'


# -- the real daemon -----------------------------------------------------------------------

def _end_daemon(pid, timeout=30):
    """Wait for a spawned daemon to exit and reap it (it is this process's
    child); True when it is gone."""
    deadline = time.monotonic() + timeout
    while _pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    try:
        os.waitpid(pid, 0)
    except ChildProcessError:
        pass  # reaped already
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _daemon_shm_entries(pid):
    tag = '_{}_'.format(pid)
    return [e for e in os.listdir('/dev/shm') if e.startswith('pstpu') and tag in e]


def test_spawned_daemon_serves_and_exits_clean(tmp_path, synthetic_dataset):
    svc_dir = str(tmp_path / 'svc')
    with make_reader(synthetic_dataset.url, serve=svc_dir, seed=0, workers_count=2,
                     output='columnar') as served:
        pid = served.daemon_pid
        assert pid != os.getpid()
        ids = sorted(int(i) for b in served for i in b.id)
        # the daemon decodes on the host: no torch, no JAX library is mapped
        with open('/proc/{}/maps'.format(pid)) as f:
            libraries = {line.split()[-1] for line in f if line.rstrip().endswith('.so')
                         or '.so.' in line}
        assert not [p for p in libraries if re.search(r'/(torch|jax|jaxlib)/', p)]
        assert _daemon_shm_entries(pid)
    assert ids == sorted(int(r['id']) for r in synthetic_dataset.data)
    conn = connect_service(svc_dir)
    conn.send({'op': 'shutdown'})
    assert conn.recv()['ok']
    conn.close()
    assert _end_daemon(pid)
    assert _daemon_shm_entries(pid) == []
    assert read_endpoint(svc_dir) is None


def test_killed_daemon_raises_daemon_died(tmp_path, synthetic_dataset):
    svc_dir = str(tmp_path / 'svc')
    reader = make_reader(synthetic_dataset.url, serve=svc_dir, seed=0, num_epochs=None,
                         workers_count=1)
    pid = reader.daemon_pid
    try:
        for _, _row in zip(range(5), reader):
            pass
        os.kill(pid, signal.SIGKILL)
        with pytest.raises(ServeDaemonDiedError):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                next(reader)
    finally:
        reader.stop()
        reader.join()
        assert _end_daemon(pid)
        # a SIGKILLed daemon cannot unlink its ring and blob dir: remove them
        for entry in _daemon_shm_entries(pid):
            path = os.path.join('/dev/shm', entry)
            shutil.rmtree(path) if os.path.isdir(path) else os.unlink(path)


def test_next_daemon_reaps_a_killed_daemons_rings(tmp_path, synthetic_dataset):
    """Only its owner unlinks a broadcast ring, so a SIGKILLed daemon's
    rings outlive it; the next daemon's start removes every ring and blob
    dir whose owner pid is dead and whose age passed the sweep's grace, and
    keeps a live pid's ring and its own process's."""
    from petastorm_tpu_torch.workers.process_pool import _BLOB_SWEEP_GRACE_S
    svc_dir = str(tmp_path / 'svc')
    reader = make_reader(synthetic_dataset.url, serve=svc_dir, seed=0, num_epochs=None,
                         workers_count=1)
    pid = reader.daemon_pid
    sleeper = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])
    kept = ['/dev/shm/pstpu_bc_{}_keptg0'.format(p) for p in (sleeper.pid, os.getpid())]
    svc = None
    try:
        for _, _row in zip(range(5), reader):
            pass
        os.kill(pid, signal.SIGKILL)
        reader.stop()
        reader.join()
        assert _end_daemon(pid)
        left = _daemon_shm_entries(pid)
        assert [e for e in left if e.startswith('pstpu_bc_{}_'.format(pid))], left
        # past the grace: the sweep reaps only segments older than it
        old = time.time() - _BLOB_SWEEP_GRACE_S - 60
        for path in kept:
            open(path, 'wb').close()
        for path in [os.path.join('/dev/shm', e) for e in left] + kept:
            os.utime(path, (old, old))
        svc = _make_service(tmp_path, name='svc2')
        assert _daemon_shm_entries(pid) == []
        assert all(os.path.exists(path) for path in kept)
    finally:
        if svc is not None:
            svc.shutdown()
        reader.stop()
        sleeper.kill()
        sleeper.wait()
        for entry in _daemon_shm_entries(pid):
            path = os.path.join('/dev/shm', entry)
            shutil.rmtree(path) if os.path.isdir(path) else os.unlink(path)
        for path in kept:
            if os.path.exists(path):
                os.unlink(path)


def test_daemon_process_imports_no_torch_jax_or_reference(tmp_path, synthetic_dataset):
    """The daemon's entry point and a client of it, in one fresh interpreter:
    serving decodes on the host and imports neither torch nor JAX nor the
    JAX package."""
    code = '\n'.join([
        'import os, sys, threading, time',
        'from petastorm_tpu_torch.serve.__main__ import main',
        'svc = {!r}'.format(str(tmp_path / 'svc')),
        't = threading.Thread(target=main, args=(["--service-dir", svc, "--workers-count",'
        ' "2", "--idle-timeout", "0.5", "--ring-bytes", str(4 << 20)],))',
        't.start()',
        # the endpoint first: a client finding none would spawn a daemon itself
        'from petastorm_tpu_torch.serve.service import read_endpoint',
        'while (read_endpoint(svc) or {}).get("pid") != os.getpid():',
        '    time.sleep(0.01)',
        'from petastorm_tpu_torch import make_reader',
        'with make_reader({!r}, serve=svc, output="columnar") as r:'.format(synthetic_dataset.url),
        '    rows = sum(len(b.id) for b in r)',
        't.join(60)',
        'assert not t.is_alive()',
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in',
        '             ("torch", "jax", "jaxlib", "flax", "optax", "petastorm_tpu"))',
        'print(rows, bad)',
    ])
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split('\n')[-2] == '100 []'
    # the daemon in the interpreter served: no client spawned one (a spawned
    # daemon logs into the service directory)
    assert not (tmp_path / 'svc' / 'daemon.log').exists()
