"""Port parity: elastic pod sharding of petastorm_tpu_torch against the JAX
package, case for case with ``tests/test_elastic.py`` (without the protocol
monitor's and model checker's cases, which wait for their port).

Everything compared here is an integer, a string or a file name (hashes,
owners, orders, commit records, replay indices), so the tolerance is 0:
the same inputs go through the JAX function and its twin and the outputs
must be equal. The hosts of both packages share one coordination directory
in the cross-package cases. The store is the suite's 100-row
``synthetic_dataset`` (10 rows per row group), written by the JAX package;
every coordination directory is under ``tmp_path``, every registry, reader
and coordinator is closed through ``with`` or ``stop()``/``close()``, every
subprocess is waited for, and the module leaves no flight recorder, telemetry
state or thread behind."""

import errno
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import retry as jax_retry
from petastorm_tpu.elastic import ElasticConfig as JaxElasticConfig
from petastorm_tpu.elastic import MembershipRegistry as JaxMembershipRegistry
from petastorm_tpu.elastic import shardmap as jax_shardmap
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import retry
from petastorm_tpu_torch.elastic import (ElasticConfig, MembershipRegistry, ShardMap,
                                         global_order, resolve_elastic, shardmap)
from petastorm_tpu_torch.elastic.coordinator import ElasticCoordinator, ElasticVentilator
from petastorm_tpu_torch.faults import HostChurnPlan, count_committed, drive_host_churn
from petastorm_tpu_torch.workers import ProcessPoolOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# shard map: bit-identical to the JAX package's
# ---------------------------------------------------------------------------

#: host ids of the member sets: the reader's default names and others
HOST_IDS = ('h0', 'h1', 'host3', 'node-a-4711', 'h10')
MEMBER_SETS = [HOST_IDS[:n] for n in range(1, 6)] + [('h10', 'h1'), ('node-a-4711',)]


@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('num_items', [1, 10, 257])
@pytest.mark.parametrize('seed', [None, 0, 7, 2 ** 40])
def test_shard_map_equals_jax(seed, num_items, shuffle):
    for epoch in range(4):
        assert (global_order(num_items, seed, epoch, shuffle=shuffle)
                == jax_shardmap.global_order(num_items, seed, epoch, shuffle=shuffle))
        for members in MEMBER_SETS:
            ours = ShardMap(3, members, num_items, seed, epoch, shuffle=shuffle)
            theirs = jax_shardmap.ShardMap(3, members, num_items, seed, epoch, shuffle=shuffle)
            assert ours.members == theirs.members
            assert ours.order() == theirs.order()
            assert ours.describe() == theirs.describe()
            for item in range(num_items):
                assert ours.owner(item) == theirs.owner(item)
                assert ours.owner(item) == shardmap.owner_of(item, members, seed, epoch)
                assert ours.rank(item) == theirs.rank(item)
            for member in members:
                assert ours.owned_items(member) == theirs.owned_items(member)
            # the owners partition the items
            assert sorted(i for m in members for i in ours.owned_items(m)) == list(
                range(num_items))


@pytest.mark.parametrize('parts', [
    (), ('a', 1), ('ab', 'c'), ('a', 'bc'), ('pod', 3), (None,), (2 ** 40, -1, 'h0'),
    ('pstpu.elastic.owner', 7, 0, 'h1', 5), (('nested', 1), 'x'), (1.5, True)])
def test_stable_hash_equals_jax(parts):
    assert shardmap.stable_hash(*parts) == jax_shardmap.stable_hash(*parts)


def test_stable_hash_is_stable_across_hash_seeds():
    out = subprocess.run(
        [sys.executable, '-c', 'from petastorm_tpu_torch.elastic import stable_hash;'
         "print(stable_hash('pod', 3))"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONHASHSEED='271', PYTHONPATH=REPO))
    assert int(out.stdout) == jax_shardmap.stable_hash('pod', 3)


def test_rendezvous_reassigns_only_departed_hosts_items():
    before = ShardMap(1, ('h0', 'h1', 'h2'), num_items=40, seed=3, epoch=0)
    after = ShardMap(2, ('h0', 'h2'), num_items=40, seed=3, epoch=0)
    for i in range(40):
        if before.owner(i) != 'h1':
            assert after.owner(i) == before.owner(i)


def test_shard_map_rejects_empty_members():
    with pytest.raises(ValueError, match='at least one member'):
        ShardMap(1, (), num_items=4, seed=0, epoch=0)


def test_owned_items_are_rank_ordered():
    smap = ShardMap(1, ('h0', 'h1'), num_items=16, seed=9, epoch=0)
    for m in ('h0', 'h1'):
        ranks = [smap.rank(i) for i in smap.owned_items(m)]
        assert ranks == sorted(ranks)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

class _HttpError(OSError):
    pass


ERRORS = [
    OSError(errno.ECONNRESET, 'reset'), OSError(errno.ETIMEDOUT, 'x'),
    OSError(errno.EAGAIN, 'x'), OSError(errno.EBUSY, 'x'), OSError(errno.ENOSPC, 'disk full'),
    OSError('SlowDown: please reduce your request rate'), OSError('connection reset by peer'),
    OSError('curl error 56'), OSError('HTTP 503 Service Unavailable'),
    OSError('status code: 429'), OSError('error 500'), OSError('got 500 bytes, wanted 600'),
    OSError('short read of 12 bytes'), _HttpError('http: 502'), OSError('no such thing'),
    FileNotFoundError(errno.ENOENT, 'gone'), PermissionError(errno.EACCES, 'no'),
    IsADirectoryError('dir'), NotADirectoryError('file'), ConnectionResetError('peer'),
    TimeoutError('slow'), ValueError('timeout'), RuntimeError('connection reset'),
]


@pytest.mark.parametrize('exc', ERRORS, ids=lambda e: '{}:{}'.format(type(e).__name__, e))
def test_is_transient_io_error_equals_jax(exc):
    assert retry.is_transient_io_error(exc) == jax_retry.is_transient_io_error(exc)


def test_transient_table_has_both_verdicts():
    verdicts = [retry.is_transient_io_error(e) for e in ERRORS]
    assert any(verdicts) and not all(verdicts)


def test_backoff_within_jitter_bounds():
    policy = retry.RetryPolicy(initial_backoff_s=0.1, multiplier=2.0, max_backoff_s=0.5,
                               jitter=0.25)
    for attempt in range(1, 8):
        base = min(0.1 * 2.0 ** (attempt - 1), 0.5)
        draws = [policy.backoff_s(attempt) for _ in range(200)]
        assert all(base * 0.75 <= d <= base * 1.25 for d in draws)
        assert len(set(draws)) > 1
    # the draws come from the policy's own generator, not the module-global one
    state = random.getstate()
    policy.backoff_s(1)
    assert random.getstate() == state
    assert retry.RetryPolicy(jitter=0.0).backoff_s(3) == pytest.approx(0.4, abs=0)


def test_call_retries_transient_and_raises_permanent_at_once():
    policy = retry.RetryPolicy(max_attempts=4, initial_backoff_s=0.001, jitter=0.0)
    calls, reopened = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.ECONNRESET, 'reset')
        return 'ok'

    assert policy.call(flaky, on_retry=lambda: reopened.append(1)) == 'ok'
    assert len(calls) == 3 and len(reopened) == 2

    def missing():
        calls.append(1)
        raise FileNotFoundError(errno.ENOENT, 'gone')

    calls.clear()
    with pytest.raises(FileNotFoundError):
        policy.call(missing)
    assert len(calls) == 1

    def always():
        calls.append(1)
        raise OSError(errno.ETIMEDOUT, 'slow')

    calls.clear()
    with pytest.raises(OSError):
        policy.call(always)
    assert len(calls) == 4
    # a deadline shorter than the first sleep: no retry at all
    calls.clear()
    with pytest.raises(OSError):
        retry.RetryPolicy(initial_backoff_s=1.0, jitter=0.0).with_deadline(0.5).call(always)
    assert len(calls) == 1
    with pytest.raises(ValueError, match='max_attempts'):
        retry.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match='deadline_s'):
        retry.RetryPolicy(deadline_s=0)
    assert retry.RetryPolicy() == retry.RetryPolicy()


# ---------------------------------------------------------------------------
# membership: leases, expiry, flaky-fs hardening
# ---------------------------------------------------------------------------

def _write_lease(coord_dir, host, renewed, lease_s=0.5, machine='elsewhere', pid=1):
    members = os.path.join(coord_dir, 'members')
    os.makedirs(members, exist_ok=True)
    with open(os.path.join(members, host + '.lease'), 'w') as f:
        json.dump({'host': host, 'pid': pid, 'machine': machine, 'lease_s': lease_s,
                   'renewed': renewed}, f)


def test_lease_join_scan_leave(tmp_path):
    coord = str(tmp_path)
    with MembershipRegistry(coord, 'h0', lease_s=5.0) as reg:
        assert reg.alive_members() == ('h0',)
        assert reg.expired_members() == ()
    assert MembershipRegistry(coord, 'h1', lease_s=5.0).alive_members() == ()


def test_stale_lease_expires_and_rejoin_revives(tmp_path):
    coord = str(tmp_path)
    _write_lease(coord, 'ghost', renewed=time.time() - 60)
    reg = MembershipRegistry(coord, 'h0', lease_s=5.0)
    assert reg.expired_members() == ('ghost',)
    assert 'ghost' not in reg.alive_members()
    _write_lease(coord, 'ghost', renewed=time.time())
    assert 'ghost' in reg.alive_members()


def test_same_machine_dead_pid_is_dead_despite_fresh_lease(tmp_path):
    coord = str(tmp_path)
    dead = subprocess.Popen([sys.executable, '-c', 'pass'])
    dead.wait()
    _write_lease(coord, 'ghost', renewed=time.time(), machine=os.uname().nodename,
                 pid=dead.pid)
    assert 'ghost' in MembershipRegistry(coord, 'h0', lease_s=5.0).expired_members()


def test_heartbeat_keeps_short_lease_alive(tmp_path):
    with MembershipRegistry(str(tmp_path), 'h0', lease_s=0.2) as reg:
        time.sleep(1.0)  # many lease periods: only the heartbeat keeps it fresh
        assert reg.alive_members() == ('h0',)


def _transient_faults(monkeypatch, count):
    """The first ``count`` retried storage operations of this process raise
    a transient error (the JAX package's ``storage_fail_first``)."""
    fired = []
    lock = threading.Lock()

    def fault_point():
        with lock:
            if len(fired) >= count:
                return
            fired.append(1)
        raise OSError(errno.ECONNRESET, 'injected transient storage fault')

    monkeypatch.setattr(retry, 'FAULT_POINT', fault_point)
    return fired


def test_flaky_fs_does_not_masquerade_as_departure(tmp_path, monkeypatch):
    coord = str(tmp_path)
    with MembershipRegistry(coord, 'h0', lease_s=5.0):
        reg = MembershipRegistry(coord, 'peer', lease_s=5.0)
        fired = _transient_faults(monkeypatch, 3)
        assert reg.alive_members() == ('h0',)
        assert len(fired) == 3
        monkeypatch.setattr(retry, 'FAULT_POINT', None)


def test_leases_are_shared_with_the_jax_package(tmp_path):
    coord = str(tmp_path)
    with JaxMembershipRegistry(coord, 'jax-host', lease_s=5.0) as theirs:
        with MembershipRegistry(coord, 'torch-host', lease_s=5.0) as ours:
            assert ours.alive_members() == theirs.alive_members() == ('jax-host', 'torch-host')
            assert ([m.to_dict() for m in ours.scan(now=1e12)]
                    == [m.to_dict() for m in theirs.scan(now=1e12)])
        assert theirs.alive_members() == ('jax-host',)
    assert MembershipRegistry(coord, 'x').alive_members() == ()


# ---------------------------------------------------------------------------
# coordinator: pinning, adoption, exactly-once commit
# ---------------------------------------------------------------------------

def _make_coordinator(tmp_path, host='h0', num_items=6, lease_s=5.0, seed=0):
    cfg = resolve_elastic(ElasticConfig(coord_dir=str(tmp_path), host_id=host, lease_s=lease_s,
                                        monitor=False))
    return ElasticCoordinator(cfg, num_items=num_items, seed=seed)


def test_live_peers_inflight_is_pinned_dead_peers_is_adopted(tmp_path):
    coord = _make_coordinator(tmp_path, num_items=6)
    coord.start()
    try:
        _write_lease(str(tmp_path), 'peer', renewed=time.time())
        coord.poll(force=True)
        assert set(coord.members) == {'h0', 'peer'}
        coord.begin_epoch(0)
        pinned = coord.shard_map(0).owned_items('h0')[0]
        inflight_dir = os.path.join(str(tmp_path), 'epochs', '000000', 'inflight')
        os.makedirs(inflight_dir, exist_ok=True)
        with open(os.path.join(inflight_dir, 'peer.json'), 'w') as f:
            json.dump({'host': 'peer', 'generation': coord.generation, 'items': [int(pinned)]}, f)
        coord.poll(epoch=0, force=True)
        assert pinned not in coord.claimable_items(0)
        _write_lease(str(tmp_path), 'peer', renewed=time.time() - 60)
        coord.poll(epoch=0, force=True)
        assert set(coord.members) == {'h0'}
        assert pinned in coord.claimable_items(0)
    finally:
        coord.close()


def test_commit_markers_are_exactly_once(tmp_path):
    a = _make_coordinator(tmp_path, host='a', num_items=4)
    b = _make_coordinator(tmp_path, host='b', num_items=4)
    a.start()
    b.start()
    try:
        a.begin_epoch(0)
        b.begin_epoch(0)
        assert a.commit(0, 2) is True
        assert b.commit(0, 2) is False
        assert a.commit(0, 2) is False
        assert a.is_done(0, 2)
        assert b.is_done(0, 2)
        with open(os.path.join(str(tmp_path), 'commits', 'a.jsonl')) as f:
            records = [json.loads(line) for line in f]
        assert records == [{'epoch': 0, 'item': 2, 'rank': a.shard_map(0).rank(2),
                            'generation': a.generation, 'host': 'a'}]
        assert not os.path.exists(os.path.join(str(tmp_path), 'commits', 'b.jsonl'))
    finally:
        a.close()
        b.close()


def test_torn_generation_file_is_skipped_not_fatal(tmp_path):
    coord = _make_coordinator(tmp_path)
    coord.start()
    try:
        assert coord.generation == 1
        torn = os.path.join(str(tmp_path), 'generations', '00000005.json')
        with open(torn, 'w') as f:
            f.write('{"generation":')
        coord.poll(force=True)
        assert coord.generation == 1
        with open(torn, 'w') as f:
            json.dump({'generation': 5, 'members': ['h0'], 'proposed_by': 'peer'}, f)
        coord.poll(force=True)
        assert coord.generation == 5
        gen_dir = os.path.join(str(tmp_path), 'generations')
        assert all(n.endswith('.json') for n in os.listdir(gen_dir))
        for name in os.listdir(gen_dir):
            with open(os.path.join(gen_dir, name)) as f:
                json.load(f)
    finally:
        coord.close()


def test_feed_thread_crash_marks_ventilation_complete(tmp_path):
    from petastorm_tpu_torch import observability as obs
    coord = _make_coordinator(tmp_path, num_items=2)

    def boom(epoch):
        raise RuntimeError('injected feed-thread crash')

    coord.begin_epoch = boom
    before = obs.get_registry().value('elastic_ventilator_errors') or 0
    vent = ElasticVentilator(lambda **kw: None, [{'piece_index': i} for i in range(2)], coord)
    vent.start()
    try:
        deadline = time.time() + 30
        while not vent.completed() and time.time() < deadline:
            time.sleep(0.01)
        assert vent.completed(), 'feed-thread death left the ventilator hanging'
        assert obs.get_registry().value('elastic_ventilator_errors') == before + 1
    finally:
        vent.stop()
    # stop() left the pod: the lease is gone
    assert os.listdir(os.path.join(str(tmp_path), 'members')) == []


def test_persistent_marker_failure_keeps_item_uncommitted(tmp_path, monkeypatch):
    coord = _make_coordinator(tmp_path, num_items=2)
    coord.start()
    try:
        coord.begin_epoch(0)
        coord.note_ventilated(0, 1)
        _transient_faults(monkeypatch, 10)
        assert coord.commit(0, 1) is False
        monkeypatch.setattr(retry, 'FAULT_POINT', None)
        done_dir = os.path.join(str(tmp_path), 'epochs', '000000', 'done')
        assert os.listdir(done_dir) == []
        assert not coord.is_done(0, 1)
        assert 1 in coord.undone_items(0)
        assert not coord.epoch_complete(0)
        coord.poll(epoch=0, force=True)
        assert coord.is_done(0, 1)
        assert os.listdir(done_dir) == ['00000001']
        assert 1 not in coord.undone_items(0)
    finally:
        coord.close()


def test_generation_advances_monotonically_on_churn(tmp_path):
    coord = _make_coordinator(tmp_path)
    coord.start()
    try:
        g1 = coord.generation
        _write_lease(str(tmp_path), 'peer', renewed=time.time())
        coord.poll(force=True)
        g2 = coord.generation
        _write_lease(str(tmp_path), 'peer', renewed=time.time() - 60)
        coord.poll(force=True)
        g3 = coord.generation
        assert g1 < g2 < g3
        names = sorted(os.listdir(os.path.join(str(tmp_path), 'generations')))
        assert len(names) == g3
        with open(os.path.join(str(tmp_path), 'generations', names[1])) as f:
            assert json.load(f) == {'generation': 2, 'members': ['h0', 'peer'],
                                    'proposed_by': 'h0'}
        assert coord.status() == {'host': 'h0', 'generation': g3, 'members': ['h0'],
                                  'alive': ['h0']}
    finally:
        coord.close()


def test_monitor_is_refused_until_ported(tmp_path, monkeypatch):
    """The elastic monitor is ported: it resolves as the JAX package's does
    (explicit, or from either variable) and the coordinator feeds it."""
    from petastorm_tpu_torch.analysis.protocol.monitor import ElasticMonitor
    monkeypatch.delenv('PSTPU_ELASTIC_MONITOR', raising=False)
    monkeypatch.delenv('PSTPU_PROTOCOL_MONITOR', raising=False)
    cfg = resolve_elastic(ElasticConfig(coord_dir=str(tmp_path), host_id='h0', monitor=True))
    assert isinstance(cfg.monitor, ElasticMonitor)
    mine = ElasticMonitor(name='mine')
    assert resolve_elastic(ElasticConfig(coord_dir=str(tmp_path), host_id='h0',
                                         monitor=mine)).monitor is mine
    assert resolve_elastic(ElasticConfig(coord_dir=str(tmp_path), host_id='h0')).monitor is None
    for name in ('PSTPU_ELASTIC_MONITOR', 'PSTPU_PROTOCOL_MONITOR'):
        monkeypatch.setenv(name, '1')
        assert isinstance(resolve_elastic(ElasticConfig(coord_dir=str(tmp_path),
                                                        host_id='h0')).monitor, ElasticMonitor)
        monkeypatch.setenv(name, '0')
        assert resolve_elastic(ElasticConfig(coord_dir=str(tmp_path), host_id='h0')).monitor \
            is None
        monkeypatch.delenv(name)
    coord = ElasticCoordinator(cfg, num_items=4, seed=0)
    coord.start()
    try:
        coord.begin_epoch(0)
        for item in coord.claimable_items(0):
            coord.note_ventilated(0, item)
            assert coord.commit(0, item)
    finally:
        coord.close()
    snap = cfg.monitor.snapshot
    assert snap['generation'] >= 1 and snap['delivered'] == 4
    assert snap['events_checked'] > 0


# ---------------------------------------------------------------------------
# reader integration
# ---------------------------------------------------------------------------

def _load_commits(coord):
    """``(epoch, item) -> [commit records]`` over every host's log, and the
    records in each log's order."""
    commits, ordered = {}, []
    commits_dir = os.path.join(coord, 'commits')
    for name in sorted(os.listdir(commits_dir)):
        with open(os.path.join(commits_dir, name)) as f:
            for line in f:
                rec = json.loads(line)
                commits.setdefault((rec['epoch'], rec['item']), []).append(rec)
                ordered.append(rec)
    return commits, ordered


def _assert_epoch_once(coord, epoch=0, items=10):
    done = os.listdir(os.path.join(coord, 'epochs', '{:06d}'.format(epoch), 'done'))
    assert sorted(done) == ['{:08d}'.format(i) for i in range(items)]
    commits, _ = _load_commits(coord)
    keys = [k for k in commits if k[0] == epoch]
    assert len(keys) == items
    assert all(len(commits[k]) == 1 for k in keys), 'double commit'


POOLS = [('make_reader', 'dummy'), ('make_reader', 'thread'), ('make_reader', 'process'),
         ('make_batch_reader', 'thread')]


@pytest.mark.parametrize('factory,pool', POOLS)
def test_single_host_elastic_reader_covers_dataset(synthetic_dataset, tmp_path, factory, pool):
    coord = str(tmp_path / 'coord')
    cfg = ElasticConfig(coord_dir=coord, host_id='h0')
    pool_type = ProcessPoolOptions(results_timeout_s=60) if pool == 'process' else pool
    make = make_reader if factory == 'make_reader' else make_batch_reader
    with make(synthetic_dataset.url, schema_fields=['id'], reader_pool_type=pool_type, seed=7,
              workers_count=2, elastic=cfg) as reader:
        if factory == 'make_reader':
            ids = [int(row.id) for row in reader]
        else:
            ids = [int(i) for batch in reader for i in batch.id]
        assert reader.elastic_coordinator.status()['members'] == ['h0']
    assert sorted(ids) == sorted(r['id'] for r in synthetic_dataset.data)
    _assert_epoch_once(coord)
    # the commit log is the seeded global order's ranks
    _, ordered = _load_commits(coord)
    rank = {item: r for r, item in enumerate(global_order(10, 7, 0))}
    assert all(rec['rank'] == rank[rec['item']] for rec in ordered)
    assert os.listdir(os.path.join(coord, 'members')) == []


def _consume_pod(url, coord, hosts, results, errors):
    def consume(host, package):
        try:
            config, make = ((ElasticConfig, make_reader) if package == 'torch'
                            else (JaxElasticConfig, jax_make_reader))
            cfg = config(coord_dir=coord, host_id=host, lease_s=5.0, poll_s=0.05)
            with make(url, schema_fields=['id'], reader_pool_type='dummy', seed=21,
                      elastic=cfg) as reader:
                results[host] = [int(row.id) for row in reader]
        except Exception as e:  # surfaced by the caller's assert
            errors.append((host, e))

    threads = [threading.Thread(target=consume, args=hp) for hp in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize('packages', [('torch', 'torch'), ('jax', 'torch')])
def test_two_hosts_split_the_epoch(synthetic_dataset, tmp_path, packages):
    """Two in-process hosts (threads) split one epoch: two port hosts, or a
    JAX host and a port host in one coordination directory."""
    coord = str(tmp_path / 'coord')
    results, errors = {}, []
    hosts = [('h{}'.format(i), package) for i, package in enumerate(packages)]
    _consume_pod(synthetic_dataset.url, coord, hosts, results, errors)
    assert not errors, errors
    delivered = results['h0'] + results['h1']
    assert set(delivered) == {r['id'] for r in synthetic_dataset.data}, 'pod-wide coverage hole'
    _assert_epoch_once(coord)
    _, ordered = _load_commits(coord)
    rank = {item: r for r, item in enumerate(global_order(10, 21, 0))}
    assert all(rec['rank'] == rank[rec['item']] for rec in ordered)


def test_elastic_argument_validation(synthetic_dataset, tmp_path):
    url = synthetic_dataset.url
    cases = [
        (dict(elastic=True, cur_shard=0, shard_count=2), 'replaces static sharding'),
        (dict(elastic=True, resume_state={'version': 2}), 'not supported with elastic'),
        (dict(elastic=True, serve=str(tmp_path)), 'not supported with serve'),
        (dict(elastic=3), 'must be True or an ElasticConfig'),
    ]
    for factories in ((make_reader, jax_make_reader),
                      (make_batch_reader, jax_make_batch_reader)):
        for kwargs, match in cases:
            messages = []
            for make in factories:
                with pytest.raises(ValueError, match=match) as info:
                    make(url, reader_pool_type='dummy', **kwargs)
                messages.append(str(info.value))
            assert messages[0] == messages[1]
    for config in (ElasticConfig, JaxElasticConfig):
        with pytest.raises(ValueError, match='lease_s must be positive'):
            config(lease_s=0)
        with pytest.raises(ValueError, match='poll_s must be positive'):
            config(poll_s=-1)
    assert not os.path.exists(os.path.join(synthetic_dataset.path, '_elastic'))


def test_state_dict_equals_jax(synthetic_dataset, tmp_path):
    states = {}
    for package, (config, make) in (('torch', (ElasticConfig, make_reader)),
                                    ('jax', (JaxElasticConfig, jax_make_reader))):
        cfg = config(coord_dir=str(tmp_path / package), host_id='h0')
        with make(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                  seed=7, num_epochs=2, elastic=cfg) as reader:
            it = iter(reader)
            for _ in range(25):
                next(it)
            states[package] = reader.state_dict()
    assert states['torch'] == states['jax']
    assert len(states['torch']['ventilator']['replay_indices']) == 8
    assert states['torch']['iterations_remaining'] == 1


def test_elastic_off_is_structurally_free(synthetic_dataset):
    code = (
        'import sys\n'
        'from petastorm_tpu_torch import make_reader\n'
        'with make_reader({url!r}, schema_fields=["id"], reader_pool_type="dummy", '
        'seed=1) as r:\n'
        '    next(iter(r))\n'
        'assert not any(m.startswith("petastorm_tpu_torch.elastic") for m in sys.modules), '
        '"elastic package loaded on the plain path"\n'
        'import os\n'
        'assert not os.path.exists(os.path.join({path!r}, "_elastic"))\n'
        'print("FREE")\n'.format(url=synthetic_dataset.url, path=synthetic_dataset.path))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'FREE' in out.stdout


# ---------------------------------------------------------------------------
# churn: SIGKILL one host mid-epoch while another joins (real processes)
# ---------------------------------------------------------------------------

CHAOS_SEED = 5


def _spawn_host(url, coord, host, outdir):
    return subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.elastic._hostproc', '--url', url,
         '--coord', coord, '--host', host, '--out', os.path.join(outdir, host + '.jsonl'),
         '--seed', str(CHAOS_SEED), '--lease-s', '1.0', '--sleep-per-row', '0.02'],
        env=dict(os.environ, PYTHONPATH=REPO))


def _end(procs):
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_kill_and_join_mid_epoch_is_exactly_once(synthetic_dataset, tmp_path):
    coord = str(tmp_path / 'coord')
    url = synthetic_dataset.url
    procs = {h: _spawn_host(url, coord, h, str(tmp_path)) for h in ('h0', 'h1')}
    try:
        plan = HostChurnPlan(kill_host='h1', kill_after_commits=3, join_host='h2')
        timeline = drive_host_churn(coord, procs, plan,
                                    spawn_joiner=lambda: _spawn_host(url, coord, 'h2',
                                                                     str(tmp_path)),
                                    timeout_s=120)
        rcs = {h: p.wait(timeout=180) for h, p in procs.items()}
    finally:
        _end(procs)
    assert timeline['killed'] == 'h1' and timeline['joined'] == 'h2'
    assert timeline['commits_at_kill'] >= 3
    assert rcs['h1'] == -signal.SIGKILL
    assert rcs['h0'] == 0 and rcs['h2'] == 0, 'survivor epoch did not terminate'
    _assert_epoch_once(coord)
    assert count_committed(coord) == 10
    assert len([n for n in os.listdir(os.path.join(coord, 'generations'))
                if n.endswith('.json') and n.split('.')[0].isdigit()]) >= 3
    commits, _ = _load_commits(coord)
    rank = {item: r for r, item in enumerate(global_order(10, CHAOS_SEED, 0))}
    for (_epoch, item), (rec,) in commits.items():
        assert rec['rank'] == rank[item]
    # the killed host's lease stays (nobody cleans up after a SIGKILL), with
    # its staged renewal when the kill landed between the write and the
    # rename; the survivors left
    members = sorted(os.listdir(os.path.join(coord, 'members')))
    assert [n for n in members if n.endswith('.lease')] == ['h1.lease']
    assert set(members) - {'h1.lease', 'h1.lease.tmp.{}'.format(procs['h1'].pid)} == set()


def test_solo_run_commits_in_the_jax_order(synthetic_dataset, tmp_path):
    logs = {}
    for package, (config, make) in (('torch', (ElasticConfig, make_reader)),
                                    ('jax', (JaxElasticConfig, jax_make_reader))):
        coord = str(tmp_path / package)
        with make(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='dummy',
                  seed=CHAOS_SEED, elastic=config(coord_dir=coord, host_id='solo')) as reader:
            for _ in reader:
                pass
        _, ordered = _load_commits(coord)
        logs[package] = ordered
    assert logs['torch'] == logs['jax']
    assert [rec['item'] for rec in logs['torch']] == global_order(10, CHAOS_SEED, 0)


def test_hostproc_emits_start_done_exit(synthetic_dataset, tmp_path):
    coord = str(tmp_path / 'coord')
    proc = _spawn_host(synthetic_dataset.url, coord, 'only', str(tmp_path))
    try:
        assert proc.wait(timeout=180) == 0
    finally:
        _end({'only': proc})
    with open(os.path.join(str(tmp_path), 'only.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [r['event'] for r in records] == ['start', 'done', 'exit']
    assert records[0] == {'event': 'start', 'host': 'only', 'pid': proc.pid}
    done = records[1]
    assert done['rows'] == 100 and done['members'] == ['only'] and done['generation'] >= 1
    assert sorted(done['values']) == sorted(r['id'] for r in synthetic_dataset.data)


def test_hostproc_stops_gracefully_on_sigterm(synthetic_dataset, tmp_path):
    """SIGTERM ends a host that would run many epochs: it writes its done and
    exit lines and leaves the pod."""
    coord = str(tmp_path / 'coord')
    out = os.path.join(str(tmp_path), 'h0.jsonl')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.elastic._hostproc', '--url',
         synthetic_dataset.url, '--coord', coord, '--host', 'h0', '--out', out,
         '--num-epochs', '1000', '--sleep-per-row', '0.01'],
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        deadline = time.monotonic() + 60
        while count_committed(coord) < 2:
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        _end({'h0': proc})
    with open(out) as f:
        events = [json.loads(line)['event'] for line in f]
    assert events == ['start', 'done', 'exit']
    assert os.listdir(os.path.join(coord, 'members')) == []
