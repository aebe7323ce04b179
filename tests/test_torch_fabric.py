"""The port's chunk fabric (``petastorm_tpu_torch/fabric/``) held against the
JAX package's (``tests/test_fabric.py`` is the twin):

* the wire protocol: frames and messages byte-equal to the JAX package's,
  each side reading the other's, a truncated stream, bad magic and an
  oversize frame refused, the end-to-end ``Deadline``;
* the circuit breaker: scripted transitions equal to the JAX breaker's;
* rendezvous ranking equal to the JAX ranking for the same digests and peers;
* the fabric monitor: the same verdict and message as the JAX monitor;
* the chunk store's fabric hook: single-flight ``ensure`` (exactly one
  population per host, through the hook too) and ``pin_for_send`` against
  the evictor;
* client against server under every network fault: verified peer bytes, a
  miss without breaker penalty, corrupt, reset, truncated and stalled
  payloads and refused connects all degrading to the fallback, the breaker
  shedding a dead peer and closing again through a half-open probe;
* the spec and the checker: the default scope's counts and every mutation's
  counterexample equal to the JAX spec's, walks equal and accepted by the
  monitor, the CLI's exit codes;
* pods: the healthy two-host epoch, the chaos drill of ``docs/fabric.md``
  (a port peer process SIGKILLed mid-transfer), a port client fetching from
  a JAX server and the reverse with byte-equal mirrors, clients of both
  packages in one process, and the process pool's shipped fetch-only config.
"""

import hashlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import fabric as jax_fabric
from petastorm_tpu import faults as jax_faults
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.analysis.protocol import fabric_spec as JFB
from petastorm_tpu.analysis.protocol import monitor as jax_monitor
from petastorm_tpu.chunkstore import ChunkCacheConfig as JaxChunkCacheConfig
from petastorm_tpu.errors import ProtocolViolation as JaxProtocolViolation
from petastorm_tpu.fabric import protocol as JP
from petastorm_tpu.fabric.breaker import CircuitBreaker as JaxCircuitBreaker
from petastorm_tpu.fabric.peers import PeerInfo as JaxPeerInfo
from petastorm_tpu.fabric.peers import rank_peers as jax_rank_peers
from petastorm_tpu.observability import diagnose as jax_diagnose
from petastorm_tpu_torch import fabric, faults, make_reader
from petastorm_tpu_torch.analysis.protocol import fabric_spec as FB
from petastorm_tpu_torch.analysis.protocol import monitor
from petastorm_tpu_torch.analysis.protocol.monitor import FabricMonitor
from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, cache_diagnostics
from petastorm_tpu_torch.chunkstore import store as store_mod
from petastorm_tpu_torch.chunkstore.store import ChunkStore
from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
from petastorm_tpu_torch.errors import PetastormTpuError, ProtocolViolation
from petastorm_tpu_torch.etl import write_petastorm_dataset
from petastorm_tpu_torch.fabric import protocol as P
from petastorm_tpu_torch.fabric.breaker import CircuitBreaker
from petastorm_tpu_torch.fabric.client import stats_file_name
from petastorm_tpu_torch.fabric.peers import PeerInfo, rank_peers
from petastorm_tpu_torch.fabric.server import FabricServer
from petastorm_tpu_torch.native import is_available
from petastorm_tpu_torch.observability import diagnose
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers import ProcessPoolOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(not is_available(),
                                  reason='chunk mirrors need the native page scanner')


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


@pytest.fixture(autouse=True)
def _leave_no_fabric_state():
    """Each test uninstalls what it installed: both packages' ``PEER_SOURCE``
    hooks and network plans, and no fabric thread (server, handler, lease
    heartbeat) outlives the test."""
    from petastorm_tpu.chunkstore import store as jax_store_mod

    before = set(threading.enumerate())
    yield
    leftovers = {'port hook': store_mod.PEER_SOURCE, 'jax hook': jax_store_mod.PEER_SOURCE,
                 'port node': fabric.installed_node(), 'jax node': jax_fabric.installed_node(),
                 'port net plan': faults.get_net_plan(), 'jax net plan': jax_faults.get_net_plan()}
    fabric.uninstall()
    jax_fabric.uninstall()
    faults.uninstall_net()
    jax_faults.uninstall_net()
    assert all(v is None for v in leftovers.values()), leftovers
    prefixes = ('pstpu-torch-fabric', 'pstpu-fabric', 'pstpu-elastic-heartbeat')
    deadline = time.monotonic() + 10
    while [t for t in threading.enumerate()
           if t not in before and t.is_alive() and t.name.startswith(prefixes)]:
        assert time.monotonic() < deadline, [t.name for t in threading.enumerate()]
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _wire(module, body):
    """The bytes ``module.send_frame`` puts on the wire for ``body``."""
    a, b = _pair()
    try:
        module.send_frame(a, body, module.Deadline(5.0), 1.0)
        a.close()
        out = b''
        while True:
            part = b.recv(1 << 16)
            if not part:
                return out
            out += part
    finally:
        b.close()


MESSAGES = {'request': lambda m: m.encode_request('file|123|456|0+4096', 4096),
            'ok': lambda m: m.encode_ok(42, 'ab' * 32),
            'miss': lambda m: m.encode_miss(),
            'error': lambda m: m.encode_error('x' * 2000)}


@pytest.mark.parametrize('message', sorted(MESSAGES))
def test_frames_are_the_jax_wire_format(message):
    body = MESSAGES[message](P)
    assert body == MESSAGES[message](JP)
    wire = _wire(P, body)
    assert wire == _wire(JP, body) == P.MAGIC + struct.pack('>I', len(body)) + body
    for sender, receiver in ((P, JP), (JP, P)):
        a, b = _pair()
        try:
            sender.send_frame(a, body, sender.Deadline(5.0), 1.0)
            got = receiver.decode_message(receiver.recv_frame(b, receiver.Deadline(5.0), 1.0))
        finally:
            a.close()
            b.close()
        assert got == json.loads(body)
    assert P.VERSION == JP.VERSION and P.MAX_FRAME_BYTES == JP.MAX_FRAME_BYTES


def test_message_encodings():
    ok = P.decode_message(P.encode_ok(42, 'ab' * 32))
    assert ok == {'v': 1, 'status': 'ok', 'length': 42, 'sha256': 'ab' * 32}
    assert P.decode_message(P.encode_miss())['status'] == 'miss'
    err = P.decode_message(P.encode_error('x' * 2000))
    assert err['status'] == 'error' and len(err['message']) == 512
    assert P.decode_message(P.encode_request('k', 7)) == {'v': 1, 'op': 'get', 'key': 'k',
                                                          'length': 7}
    for bad in (b'\xff\xfe', b'not json', b'[1, 2]'):
        with pytest.raises(P.FabricProtocolError):
            P.decode_message(bad)


def test_truncated_stream_is_protocol_error():
    """EOF mid-payload raises; it never returns short bytes."""
    a, b = _pair()
    try:
        a.sendall(b'abc')
        a.close()
        with pytest.raises(P.FabricProtocolError, match='3 of 10 bytes'):
            P.recv_exactly(b, 10, P.Deadline(5.0), 1.0)
    finally:
        b.close()


def test_bad_magic_rejected():
    a, b = _pair()
    try:
        a.sendall(struct.pack('>4sI', b'NOPE', 4) + b'body')
        with pytest.raises(P.FabricProtocolError, match='magic'):
            P.recv_frame(b, P.Deadline(5.0), 1.0)
    finally:
        a.close()
        b.close()


def test_oversized_frame_rejected():
    a, b = _pair()
    try:
        a.sendall(struct.pack('>4sI', P.MAGIC, P.MAX_FRAME_BYTES + 1))
        with pytest.raises(P.FabricProtocolError, match='exceeds'):
            P.recv_frame(b, P.Deadline(5.0), 1.0)
        a.sendall(struct.pack('>4sI', P.MAGIC, 65))
        with pytest.raises(P.FabricProtocolError, match='exceeds'):
            P.recv_frame(b, P.Deadline(5.0), 1.0, max_bytes=64)
    finally:
        a.close()
        b.close()


def test_errors_are_rooted_in_the_ports_errors():
    assert issubclass(P.FabricTimeout, P.FabricError)
    assert issubclass(P.FabricProtocolError, P.FabricError)
    assert issubclass(P.FabricError, PetastormTpuError)


def test_content_hash_is_sha256():
    assert P.content_hash(b'abc') == hashlib.sha256(b'abc').hexdigest() == JP.content_hash(b'abc')


def test_deadline_budget():
    clock = [0.0]
    d = P.Deadline(10.0, clock=lambda: clock[0])
    assert d.remaining() == pytest.approx(10.0)
    # a per-op timeout is capped by the op cap and by what remains
    assert d.op_timeout(2.0) == pytest.approx(2.0)
    clock[0] = 9.5
    assert d.op_timeout(2.0) == pytest.approx(0.5)
    assert not d.expired
    clock[0] = 10.5
    assert d.expired
    with pytest.raises(P.FabricTimeout):
        d.op_timeout(2.0)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

BREAKER_SCRIPTS = {
    'trip': (3, 5.0, ['allow', 'fail', 'fail', 'fail', 'allow', 'fail', 'state']),
    'half_open_single_flight': (1, 5.0, ['fail', 't4.9', 'allow', 't5.1', 'allow', 'state',
                                         'allow', 'ok', 'state', 'allow']),
    'half_open_failure_reopens': (3, 1.0, ['fail', 'fail', 'fail', 't1.5', 'allow', 'fail',
                                           'state', 'allow', 't2.6', 'allow', 'ok']),
    'success_resets_count': (2, 5.0, ['fail', 'ok', 'fail', 'state', 'fail', 'state']),
    'cooldown_restarts': (2, 2.0, ['fail', 'fail', 't1.0', 'allow', 't2.5', 'allow', 'fail',
                                   't4.0', 'allow', 't4.6', 'allow', 'state']),
}


def _run_breaker(cls, threshold, reset_s, script):
    clock = [0.0]
    b = cls(failure_threshold=threshold, reset_after_s=reset_s, clock=lambda: clock[0])
    out = []
    for op in script:
        if op == 'allow':
            out.append(b.allow())
        elif op == 'fail':
            out.append(b.record_failure())
        elif op == 'ok':
            out.append(b.record_success())
        elif op == 'state':
            out.append(b.state)
        else:
            clock[0] = float(op[1:])
    return out


@pytest.mark.parametrize('name', sorted(BREAKER_SCRIPTS))
def test_breaker_transitions_equal_jax(name):
    threshold, reset_s, script = BREAKER_SCRIPTS[name]
    ours = _run_breaker(CircuitBreaker, threshold, reset_s, script)
    assert ours == _run_breaker(JaxCircuitBreaker, threshold, reset_s, script)
    expected = {
        'trip': [True, False, False, True, False, False, fabric.OPEN],
        'half_open_single_flight': [True, False, True, fabric.HALF_OPEN, False, None,
                                    fabric.CLOSED, True],
        'half_open_failure_reopens': [False, False, True, True, True, fabric.OPEN, False,
                                      True, None],
        'success_resets_count': [False, None, False, fabric.CLOSED, True, fabric.OPEN],
        'cooldown_restarts': [False, True, False, True, True, False, True, fabric.HALF_OPEN],
    }[name]
    assert ours == expected


def test_breaker_refuses_a_zero_threshold():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)


# ---------------------------------------------------------------------------
# rendezvous ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n_peers', [1, 2, 4, 7])
def test_rank_peers_equals_jax_and_spreads_load(n_peers):
    hosts = ['p{}'.format(i) for i in range(n_peers)] + ['h-{}'.format(i * 7) for i in range(2)]
    ours = [PeerInfo(h, '127.0.0.1', 9000 + i) for i, h in enumerate(hosts)]
    theirs = [JaxPeerInfo(h, '127.0.0.1', 9000 + i) for i, h in enumerate(hosts)]
    first = {}
    for i in range(64):
        digest = ChunkStore.digest('file|/d/part-{}.parquet|1|2+{}'.format(i % 5, i * 4096))
        ranked = [p.host for p in rank_peers(digest, ours)]
        assert ranked == [p.host for p in jax_rank_peers(digest, theirs)]
        assert sorted(ranked) == sorted(hosts)
        assert [p.host for p in rank_peers(digest, list(reversed(ours)))] == ranked
        first[ranked[0]] = first.get(ranked[0], 0) + 1
    # every peer is the best for some chunks
    assert len(first) == len(hosts)


# ---------------------------------------------------------------------------
# runtime monitor
# ---------------------------------------------------------------------------

MONITOR_CASES = {
    'double_populate': [('on_populate', 'd1', True), ('on_populate', 'd1', True)],
    'invalidation_reopens': [('on_populate', 'd1', True), ('on_invalidate', 'd1'),
                             ('on_populate', 'd1', True)],
    'unverified_bytes': [('on_populate', 'd1', False)],
    'request_to_open_breaker': [('on_request', 'pA', True), ('on_request', 'pA', False)],
    'unknown_outcome': [('on_outcome', 'k', 'peer'), ('on_outcome', 'k', 'fallback'),
                        ('on_outcome', 'k', 'error'), ('on_outcome', 'k', 'gave-up')],
    'healthy_fetches': [('on_request', 'pA', True), ('on_invalidate', 'd1'),
                        ('on_populate', 'd1', True), ('on_outcome', 'k1', 'peer'),
                        ('on_populate', 'd2', True), ('on_outcome', 'k2', 'fallback')],
}


def _monitor_verdict(module, error, steps):
    m = module.FabricMonitor('t')
    try:
        for name, *args in steps:
            getattr(m, name)(*args)
    except error as e:
        return 'raised', str(e), m.events_checked
    return 'accepted', m.snapshot, m.events_checked


@pytest.mark.parametrize('case', sorted(MONITOR_CASES))
def test_monitor_verdicts_equal_jax(case):
    ours = _monitor_verdict(monitor, ProtocolViolation, MONITOR_CASES[case])
    assert ours == _monitor_verdict(jax_monitor, JaxProtocolViolation, MONITOR_CASES[case])
    accepted = case in ('invalidation_reopens', 'healthy_fetches')
    assert ours[0] == ('accepted' if accepted else 'raised')


# ---------------------------------------------------------------------------
# chunk store: single flight and send pins
# ---------------------------------------------------------------------------

def _gated_fetch(calls, gate, payload):
    def fetch(deadline_s=None):
        calls.append(deadline_s)
        gate.wait(timeout=5.0)  # hold the leader so followers queue
        return payload
    fetch.supports_deadline = True
    return fetch


@pytest.mark.parametrize('through_fabric', [False, True])
def test_concurrent_ensure_fetches_exactly_once(tmp_path, through_fabric):
    """N threads demanding one chunk make one fetch and one mirror write;
    the rest count hits, with the fabric's hook installed too (an empty pod:
    the client falls back to the object store once)."""
    store = ChunkStore(str(tmp_path / 'c'))
    calls, gate = [], threading.Event()
    client = None
    if through_fabric:
        client = fabric.FabricClient(store, _StaticPeers('pSelf', []), str(tmp_path / 'coord'),
                                     monitor=FabricMonitor('t'))
        fabric.install(client)
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            store.ensure('k', 64, _gated_fetch(calls, gate, b'x' * 64)))) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        gate.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        fabric.uninstall()
    assert len(calls) == 1 and len(results) == 6
    assert len({r[0] for r in results}) == 1
    assert sum(r[2] for r in results) == 1
    snap = store.stats_snapshot()
    assert (snap['misses'], snap['hits']) == (1, 5)
    if through_fabric:
        # the remaining budget rode into the fallback
        assert 0 < calls[0] <= client.deadline_s
        assert client.stats()['peers'] == {'-': {'hits': 0, 'failures': 0, 'fallbacks': 1,
                                                 'bytes': 0, 'latency_sum': 0.0,
                                                 'latency_n': 0}}
        assert client.monitor.snapshot == {'populated': 1, 'events_checked': 3}
        client.close()


def test_a_followers_none_counts_a_hit(tmp_path):
    """The client's single-flight follower returns None: the store re-stats
    the mirror its leader wrote and counts a hit; without a mirror it
    raises."""
    store = ChunkStore(str(tmp_path / 'c'))
    path, _, _ = store.ensure('k', 8, lambda: b'y' * 8)
    os.unlink(path)

    def follower(key, length, fetch_fn):
        with open(path, 'wb') as f:
            f.write(b'y' * length)
        return None

    store_mod.PEER_SOURCE = follower
    try:
        assert store.ensure('k', 8, lambda: b'z' * 8)[2] is False
        assert store.stats_snapshot()['hits'] == 1
        with pytest.raises(IOError, match='no mirror'):
            store.ensure('other', 8, lambda: b'z' * 8)  # follower wrote the wrong file
    finally:
        store_mod.PEER_SOURCE = None


def test_send_pin_refuses_eviction_then_releases(tmp_path):
    """A mirror streamed to a peer survives the evictor: the send holds a
    pin, the skip is counted, and eviction proceeds once the send ends."""
    store = ChunkStore(str(tmp_path / 'c'), size_limit_bytes=150)
    path_a, _, _ = store.ensure('a', 100, lambda: b'a' * 100)
    os.utime(path_a, ns=(1, 1))  # the LRU victim
    with store.pin_for_send('a') as pinned:
        assert pinned == path_a
        with store.pin_for_send('a') as again:  # a second send of the same chunk
            assert again == path_a
        store.ensure('b', 100, lambda: b'b' * 100)  # 200 > 150: wants 'a'
        assert os.path.exists(path_a), 'the evictor truncated an in-flight send'
        assert store.stats_snapshot()['evict_skipped_pinned'] == 1
    store.ensure('c', 100, lambda: b'c' * 100)
    assert not os.path.exists(path_a)
    assert store.stats_snapshot()['chunks_evicted'] >= 1
    assert store._send_pins == {}


def test_send_pin_rides_a_live_mapping(tmp_path):
    """With a mapping live the send borrows the mapping's slot: the mapping
    dropped mid-send, the evictor still refuses until the send ends."""
    import gc
    store = ChunkStore(str(tmp_path / 'c'), size_limit_bytes=150)
    mm = store.mmap_chunk('a', 100, lambda: b'a' * 100)
    os.utime(store._entry_path(store.digest('a')), ns=(1, 1))
    with store.pin_for_send('a') as pinned:
        assert pinned is not None and store._send_pins == {}
        del mm
        store._strong.clear()
        gc.collect()
        store.ensure('b', 100, lambda: b'b' * 100)
        assert os.path.exists(pinned)
    gc.collect()
    store.ensure('c', 100, lambda: b'c' * 100)
    assert not os.path.exists(pinned)


def test_pin_for_send_reports_absent_chunk(tmp_path):
    store = ChunkStore(str(tmp_path / 'c'))
    with store.pin_for_send('never-populated') as pinned:
        assert pinned is None
    assert store._send_pins == {}


# ---------------------------------------------------------------------------
# client against a live server: the degradation matrix
# ---------------------------------------------------------------------------

class _StaticPeers(object):
    """A peer registry with a fixed peer list and no membership."""

    def __init__(self, host_id, peerset):
        self.host_id = host_id
        self._peers = list(peerset)

    def alive_peers(self):
        return list(self._peers)


def _serving_pair(tmp_path, chunks=('k1', 'k2', 'k3'), length=4096):
    """A populated served store, an empty local store and a server."""
    served = ChunkStore(str(tmp_path / 'served'))
    payloads = {}
    for i, key in enumerate(chunks):
        payloads[key] = bytes([i % 251]) * length
        served.ensure(key, length, lambda i=i: payloads[chunks[i]])
    local = ChunkStore(str(tmp_path / 'local'))
    return served, local, FabricServer(served).start(), payloads


def _client_for(local, server, tmp_path, **kwargs):
    peerset = [PeerInfo('pA', server.endpoint[0], server.endpoint[1])]
    defaults = dict(deadline_s=5.0, io_timeout_s=1.0, connect_timeout_s=1.0,
                    failure_threshold=3, breaker_reset_s=5.0)
    defaults.update(kwargs)
    return fabric.FabricClient(local, _StaticPeers('pSelf', peerset), str(tmp_path / 'coord'),
                               **defaults)


def _stats_file(tmp_path, host='pSelf'):
    with open(os.path.join(str(tmp_path / 'coord'), 'fabric', 'stats',
                           stats_file_name(host))) as f:
        return json.load(f)


def test_peer_fetch_verified_end_to_end(tmp_path):
    served, local, server, payloads = _serving_pair(tmp_path)
    fallback_calls = []
    try:
        mon = FabricMonitor('t')
        with _client_for(local, server, tmp_path, monitor=mon) as client:
            data = client.fetch('k1', 4096, lambda: fallback_calls.append(1) or payloads['k1'])
            # through the store: the mirror gets the peer's bytes
            fabric.install(client)
            try:
                path, _, fetched = local.ensure('k2', 4096, lambda: fallback_calls.append(1))
            finally:
                fabric.uninstall()
        assert data == payloads['k1'] and fetched
        with open(path, 'rb') as f:
            assert f.read() == payloads['k2']
        assert not fallback_calls, 'the peer path touched the object store'
        assert mon.snapshot == {'populated': 2, 'events_checked': 8}
    finally:
        server.stop()
    assert os.listdir(os.path.join(str(tmp_path / 'coord'), 'fabric', 'stats')) == [
        stats_file_name('pSelf')]
    snap = _stats_file(tmp_path)
    assert snap['peers']['pA']['hits'] == 2 and snap['peers']['pA']['bytes'] == 8192
    assert snap['peers']['pA']['fallbacks'] == 0
    assert snap['breakers'] == {'pA': fabric.CLOSED} and snap['host'] == 'pSelf'


def test_peer_miss_falls_back_without_breaker_penalty(tmp_path):
    served, local, server, payloads = _serving_pair(tmp_path)
    try:
        with _client_for(local, server, tmp_path, failure_threshold=1) as client:
            for _ in range(3):
                assert client.fetch('absent-key', 128, lambda: b'f' * 128) == b'f' * 128
            # a miss: a healthy peer that does not mirror this chunk
            assert client._breaker_for('pA').state == fabric.CLOSED
            stats = client.stats()['peers']['pA']
            assert (stats['hits'], stats['failures'], stats['fallbacks']) == (0, 0, 3)
            # a length the mirror does not hold is a miss too
            assert client.fetch('k1', 100, lambda: b'g' * 100) == b'g' * 100
    finally:
        server.stop()


@pytest.mark.parametrize('fault, plan', [
    ('corrupt', dict(corrupt_payloads=1)), ('reset', dict(reset_payloads=1)),
    ('truncate', dict(truncate_payloads=1)), ('refuse', dict(refuse_connects=1)),
    ('reset_and_truncate', dict(reset_payloads=1, truncate_payloads=1))])
def test_network_faults_degrade_to_the_fallback(tmp_path, fault, plan):
    """A corrupt, reset, truncated or refused transfer is discarded: the
    fallback's bytes win, the peer is charged a failure, and the next fetch
    rides the peer again."""
    served, local, server, payloads = _serving_pair(tmp_path)
    faults.install_net(faults.NetFaultPlan(**plan))
    n_faults = sum(plan.values())
    try:
        mon = FabricMonitor('t')
        with _client_for(local, server, tmp_path, monitor=mon) as client:
            for key in ('k1', 'k2')[:n_faults]:
                fallback = b'F' * 4096
                assert client.fetch(key, 4096, lambda: fallback) == fallback
            assert client._breaker_for('pA').state == fabric.CLOSED  # threshold 3
            assert client.fetch('k3', 4096, lambda: b'never') == payloads['k3']
            stats = client.stats()['peers']['pA']
        assert (stats['hits'], stats['failures'], stats['fallbacks']) == (1, n_faults, n_faults)
        assert mon.snapshot['populated'] == n_faults + 1
    finally:
        faults.uninstall_net()
        server.stop()


def test_stalled_peer_bounded_by_deadline(tmp_path):
    """A stalled transfer costs at most the deadline, then degrades; the
    fallback gets what remains of the budget, or its own policy without."""
    served, local, server, payloads = _serving_pair(tmp_path)
    faults.install_net(faults.NetFaultPlan(stall_payloads=1, stall_s=30.0))
    seen = []

    def fallback(deadline_s=None):
        seen.append(deadline_s)
        return payloads['k1']
    fallback.supports_deadline = True
    try:
        with _client_for(local, server, tmp_path, deadline_s=1.0, io_timeout_s=0.3) as client:
            t0 = time.monotonic()
            assert client.fetch('k1', 4096, fallback) == payloads['k1']
            elapsed = time.monotonic() - t0
    finally:
        faults.uninstall_net()
        server.stop()
    assert elapsed < 10.0
    assert seen == [None] or 0 < seen[0] < 1.0


def test_breaker_opens_sheds_and_recovers(tmp_path, monkeypatch):
    """A dead peer costs K connection attempts, then none (the open breaker
    sends every fetch to the fallback); after the cooldown one half-open
    probe to a live server closes it again."""
    served, local, server, payloads = _serving_pair(tmp_path)
    endpoint = server.endpoint
    server.stop()  # the peer now refuses connections
    attempts = []
    real = faults.on_net_connect
    monkeypatch.setattr(faults, 'on_net_connect', lambda: attempts.append(1) or real())
    clock = [0.0]
    with fabric.FabricClient(local, _StaticPeers('pSelf', [PeerInfo('pA', *endpoint)]),
                             str(tmp_path / 'coord'), deadline_s=5.0, io_timeout_s=1.0,
                             connect_timeout_s=0.5, failure_threshold=2,
                             breaker_reset_s=5.0) as client:
        client._breakers['pA'] = CircuitBreaker(2, 5.0, clock=lambda: clock[0])
        for i in range(5):
            assert client.fetch('k-{}'.format(i), 64, lambda: b'z' * 64) == b'z' * 64
        assert client._breaker_for('pA').state == fabric.OPEN
        assert len(attempts) == 2, 'an open breaker must shed load (no round trip)'
        revived = FabricServer(served, port=endpoint[1]).start()
        try:
            clock[0] = 6.0
            assert client.fetch('k1', 4096, lambda: b'never') == payloads['k1']
            assert client._breaker_for('pA').state == fabric.CLOSED
        finally:
            revived.stop()
        stats = client.stats()['peers']
    # the shed fetches picked no peer: their fallbacks are the '-' row's
    assert (stats['pA']['hits'], stats['pA']['failures'], stats['pA']['fallbacks']) == (1, 2, 2)
    assert stats['-']['fallbacks'] == 3
    assert len(attempts) == 3


def test_server_answers_errors_and_serves_both_packages(tmp_path):
    """A port server answers a JAX client's request, refuses a malformed
    one with an error frame, and a JAX server serves the port's client."""
    served, local, server, payloads = _serving_pair(tmp_path)
    try:
        for body, status in ((P.encode_request('k1', 0), 'error'),
                             (json.dumps({'v': 1, 'op': 'put'}).encode(), 'error'),
                             (P.encode_request('zz', 8), 'miss')):
            with socket.create_connection(server.endpoint, timeout=5) as sock:
                P.send_frame(sock, body, P.Deadline(5), 1.0)
                assert P.decode_message(P.recv_frame(sock, P.Deadline(5), 1.0))['status'] \
                    == status
        from petastorm_tpu.chunkstore.store import ChunkStore as JaxChunkStore
        jax_local = JaxChunkStore(str(tmp_path / 'jax_local'))
        jax_client = jax_fabric.FabricClient(
            jax_local, _StaticPeers('jSelf', [JaxPeerInfo('pA', *server.endpoint)]),
            str(tmp_path / 'coord'))
        assert jax_client.fetch('k2', 4096, lambda: b'never') == payloads['k2']
        jax_client.close()
    finally:
        server.stop()
    jax_served = type(jax_local)(str(tmp_path / 'jax_served'))
    jax_served.ensure('k3', 4096, lambda: payloads['k3'])
    jax_server = jax_fabric.FabricServer(jax_served).start()
    try:
        with _client_for(local, jax_server, tmp_path) as client:
            assert client.fetch('k3', 4096, lambda: b'never') == payloads['k3']
    finally:
        jax_server.stop()


def test_net_plan_shots_coordinate_across_processes(tmp_path):
    """With a ``state_dir`` the shots are claimed through sentinel files, so
    two plans (two processes) share one budget, and JAX's plan shares it."""
    state = str(tmp_path / 'shots')
    os.makedirs(state)
    a = faults.NetFaultPlan(reset_payloads=2, state_dir=state)
    b = faults.NetFaultPlan(reset_payloads=2, state_dir=state)
    j = jax_faults.NetFaultPlan(reset_payloads=2, state_dir=state)
    fired = []
    for plan, module in ((a, faults), (j, jax_faults), (b, faults)):
        module.install_net(plan)
        try:
            fired.append(module.net_payload_action())
        finally:
            module.uninstall_net()
    assert fired == [('reset', None), ('reset', None), None]
    plan = faults.install_net(faults.NetFaultPlan(stall_payloads=1, stall_s=0.5,
                                                  corrupt_payloads=1, refuse_connects=1))
    try:
        assert [faults.net_payload_action() for _ in range(3)] == [
            ('stall', 0.5), ('corrupt', None), None]
        with pytest.raises(ConnectionRefusedError):
            faults.on_net_connect()
        faults.on_net_connect()
        assert faults.get_net_plan() is plan
    finally:
        faults.uninstall_net()
    assert faults.get_net_plan() is None and faults.net_payload_action() is None


# ---------------------------------------------------------------------------
# executable spec and model checker
# ---------------------------------------------------------------------------

def _spec_result(module, **kwargs):
    result = module.check(module.FabricSpecConfig(**dict(module.DEFAULT_FABRIC_SCOPE, **kwargs)),
                          budget_s=300)
    out = result.to_dict()
    out.pop('elapsed_s')
    return out, result


@pytest.fixture(scope='module')
def default_scope():
    """The default scope, checked once by each package."""
    return _spec_result(FB), _spec_result(JFB)


def test_default_scope_counts_equal_jax(default_scope):
    (ours, result), (theirs, _) = default_scope
    assert ours == theirs
    assert result.exhausted and result.violation is None
    assert result.states >= FB.DEFAULT_FABRIC_STATE_FLOOR == JFB.DEFAULT_FABRIC_STATE_FLOOR
    assert (result.states, result.transitions, result.terminal_states, result.depth) == (
        435631, 2381129, 7107, 16)
    assert FB.DEFAULT_FABRIC_SCOPE == JFB.DEFAULT_FABRIC_SCOPE
    assert FB.INVARIANTS == JFB.INVARIANTS and FB.MUTATIONS == JFB.MUTATIONS


@pytest.mark.parametrize('mutation, invariant', [
    ('skip_hash_check', 'hash_verified'), ('double_populate', 'populate_once'),
    ('request_open_peer', 'breaker_discipline'), ('no_fallback', 'fetch_termination')])
def test_every_mutation_gives_the_jax_counterexample(mutation, invariant):
    ours, result = _spec_result(FB, mutation=mutation)
    assert ours == _spec_result(JFB, mutation=mutation)[0]
    assert result.violation == invariant and result.trace
    if mutation != 'no_fallback':  # a liveness defect has no event to observe
        with pytest.raises(ProtocolViolation):
            FB.replay_into_monitor(result.trace, FabricMonitor('t'))


@pytest.mark.parametrize('scope', [
    dict(peers=1, chunks=1, crashes=0, faults=0, fb_fails=0, breaker_k=1),
    dict(peers=2, chunks=2, crashes=1, faults=1, fb_fails=1, breaker_k=1),
    dict(peers=2, chunks=3, crashes=1, faults=2, fb_fails=0, breaker_k=3)])
def test_small_scopes_equal_jax(scope):
    ours = FB.check(FB.FabricSpecConfig(**scope)).to_dict()
    theirs = JFB.check(JFB.FabricSpecConfig(**scope)).to_dict()
    ours.pop('elapsed_s')
    theirs.pop('elapsed_s')
    assert ours == theirs and ours['exhausted'] and ours['violation'] is None
    cfg = FB.FabricSpecConfig(**scope)
    init = FB.initial_state(cfg)
    assert FB.successors(init, cfg) == JFB.successors(init, JFB.FabricSpecConfig(**scope))


def test_spec_config_refusals_equal_jax():
    for kwargs in (dict(peers=0), dict(chunks=0), dict(crashes=-1), dict(breaker_k=0),
                   dict(mutation='nope')):
        for module in (FB, JFB):
            with pytest.raises(ValueError):
                module.FabricSpecConfig(**kwargs)


def test_random_walks_equal_jax_and_pass_the_monitor():
    """Healthy walks never trip the monitor, across seeds; each walk is
    the JAX spec's walk for that seed."""
    cfg = FB.FabricSpecConfig(**FB.DEFAULT_FABRIC_SCOPE)
    jcfg = JFB.FabricSpecConfig(**JFB.DEFAULT_FABRIC_SCOPE)
    checked = 0
    for seed in range(25):
        trace, violation = FB.random_walk(cfg, seed=seed)
        assert (trace, violation) == JFB.random_walk(jcfg, seed=seed)
        assert violation is None, 'seed {}: a healthy walk hit {}'.format(seed, violation)
        mon = FabricMonitor('walk-{}'.format(seed))
        FB.replay_into_monitor(trace, mon)
        jmon = jax_monitor.FabricMonitor('walk-{}'.format(seed))
        JFB.replay_into_monitor(trace, jmon)
        assert mon.snapshot == jmon.snapshot
        checked += mon.events_checked
    assert checked > 0


CLI = [sys.executable, '-m', 'petastorm_tpu_torch.analysis.protocol.modelcheck', '--fabric']


def test_modelcheck_cli_exit_code_contract(default_scope):
    """``--fabric`` keeps the checker's contract: 0 exhausted and clean, 1 a
    counterexample, 2 a usage error, 3 below the floor or out of budget."""
    (ours, _), _ = default_scope
    clean = subprocess.run(CLI + ['--min-states', str(FB.DEFAULT_FABRIC_STATE_FLOOR), '--json'],
                           capture_output=True, text=True, timeout=420)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    printed = json.loads(clean.stdout)
    printed.pop('elapsed_s')
    assert printed == ours
    bad = subprocess.run(CLI + ['--mutate', 'double_populate'], capture_output=True, text=True,
                         timeout=420)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert 'counterexample' in bad.stdout and 'populate_once' in bad.stdout
    usage = subprocess.run(CLI + ['--elastic'], capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and 'mutually exclusive' in usage.stderr
    assert subprocess.run(CLI + ['--mutate', 'bogus'], capture_output=True,
                          timeout=120).returncode == 2
    floor = subprocess.run(CLI + ['--min-states', '99999999'], capture_output=True, text=True,
                           timeout=420)
    assert floor.returncode == 3 and 'below the declared floor' in floor.stderr
    short = subprocess.run(CLI + ['--budget-s', '0.01'], capture_output=True, text=True,
                           timeout=120)
    assert short.returncode == 3 and 'NOT exhausted' in short.stdout


# ---------------------------------------------------------------------------
# pods: stores read through the fabric
# ---------------------------------------------------------------------------

def _write_raw_store(tmp_path, rows=48, image_size=16):
    schema = Unischema('Raw', [
        UnischemaField('image', np.uint8, (image_size, image_size, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    data = [{'image': rng.integers(0, 255, (image_size, image_size, 3), np.uint8),
             'label': int(i)} for i in range(rows)]
    store = str(tmp_path / 'raw')
    write_petastorm_dataset('file://' + store, schema, iter(data), rows_per_row_group=8,
                            compression='none')
    return store, data


def _chunk_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith('.chunk'):
                with open(os.path.join(dirpath, name), 'rb') as f:
                    out[name[:-len('.chunk')]] = f.read()
    return out


def _warm(url, cache, package='torch'):
    factory = make_reader if package == 'torch' else jax_make_reader
    with factory(url, reader_pool_type='dummy', shuffle_row_groups=False,
                 chunk_cache=cache) as reader:
        for _ in reader:
            pass


def _populated(cache):
    diag = cache_diagnostics(cache)
    return diag['chunk_cache_misses'] + diag['chunk_cache_prefetch_chunks']


def _peer_totals(stats):
    return (sum(s['hits'] for s in stats['peers'].values()),
            sum(s['fallbacks'] for s in stats['peers'].values()))


@needs_native
def test_healthy_two_host_fabric_copies_chunks_once(tmp_path):
    """No faults: host 2's epoch sources every chunk from host 1's mirror:
    peer hits equal its populations, no fallback, mirrors byte-equal."""
    store_path, data = _write_raw_store(tmp_path, rows=24)
    url = 'mock-remote://' + store_path
    coord = str(tmp_path / 'coord')
    cache_1 = ChunkCacheConfig(str(tmp_path / 'cache1'))
    cache_2 = ChunkCacheConfig(str(tmp_path / 'cache2'))
    _warm(url, cache_1)
    with fabric.start_node(fabric.FabricConfig(coord, 'h1', cache_1)), \
            fabric.start_node(fabric.FabricConfig(coord, 'h2', cache_2),
                              monitor=FabricMonitor('healthy')) as node_2:
        assert [p.host for p in node_2.client._peers.alive_peers()] == ['h1']
        fabric.install(node_2)
        try:
            with make_reader(url, reader_pool_type='thread', workers_count=2,
                             shuffle_row_groups=False, num_epochs=1,
                             chunk_cache=cache_2) as reader:
                labels = sorted(int(r.label) for r in reader)
        finally:
            fabric.uninstall()
        assert labels == [row['label'] for row in data]
    with open(os.path.join(coord, 'fabric', 'stats', stats_file_name('h2'))) as f:
        stats = json.load(f)
    assert stats['peers']['h1']['hits'] == _populated(cache_2)
    assert _peer_totals(stats) == (_populated(cache_2), 0)
    assert _chunk_files(cache_2.root) == _chunk_files(cache_1.root)
    assert not os.listdir(os.path.join(coord, 'members'))  # both left the pod


@needs_native
def test_chaos_drill_sigkill_and_network_faults(tmp_path):
    """The drill of ``docs/fabric.md``: three hosts on one mock-remote store.
    Peer A (a port peer process) stalls every payload and is SIGKILLed
    mid-transfer; peer B serves one reset and one truncated payload; host C
    reads an epoch through the thread pool with the monitor armed. C ends
    with byte-correct rows, mirrors byte-equal to B's, one population per
    chunk, and peer hits and fallbacks accounting for every population."""
    store_path, data = _write_raw_store(tmp_path)
    url = 'mock-remote://' + store_path
    coord = str(tmp_path / 'coord')
    marker, ready = str(tmp_path / 'pA-request'), str(tmp_path / 'pA-ready')
    env = dict(os.environ, PYTHONPATH=REPO, PSTPU_FLIGHT='0')
    proc_a = subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.fabric._peerproc', '--url', url,
         '--coord', coord, '--host', 'pA', '--cache-root', str(tmp_path / 'cacheA'),
         '--lease-s', '2.0', '--stall-s', '30.0', '--request-marker', marker,
         '--ready-file', ready], env=env)
    cache_b = ChunkCacheConfig(str(tmp_path / 'cacheB'))
    cache_c = ChunkCacheConfig(str(tmp_path / 'cacheC'))
    node_b = node_c = None
    killed = []

    def killer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.path.exists(marker):
                os.kill(proc_a.pid, signal.SIGKILL)  # A is stalling inside a send
                killed.append(True)
                return
            time.sleep(0.05)

    drill = FabricMonitor('drill')
    try:
        _warm(url, cache_b)
        node_b = fabric.start_node(fabric.FabricConfig(coord, 'pB', cache_b, lease_s=2.0))
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert proc_a.poll() is None, 'peer A died during warm-up'
            assert time.monotonic() < deadline, 'peer A never became ready'
            time.sleep(0.1)
        faults.install_net(faults.NetFaultPlan(reset_payloads=1, truncate_payloads=1))
        kill_thread = threading.Thread(target=killer, daemon=True)
        kill_thread.start()
        node_c = fabric.start_node(
            fabric.FabricConfig(coord, 'pC', cache_c, lease_s=2.0, deadline_s=1.5,
                                io_timeout_s=0.5, connect_timeout_s=0.5, failure_threshold=3,
                                breaker_reset_s=5.0), monitor=drill)
        fabric.install(node_c)
        with make_reader(url, reader_pool_type='thread', workers_count=3,
                         shuffle_row_groups=False, num_epochs=1, chunk_cache=cache_c) as reader:
            rows = {int(r.label): r.image for r in reader}
        kill_thread.join(timeout=60)
    finally:
        fabric.uninstall()
        faults.uninstall_net()
        for node in (node_c, node_b):
            if node is not None:
                node.stop()
        proc_a.kill()
        proc_a.wait(timeout=30)

    assert sorted(rows) == [row['label'] for row in data]
    for row in data:
        np.testing.assert_array_equal(rows[row['label']], row['image'])
    assert killed and os.path.exists(marker), 'peer A was never asked and killed'
    files_b, files_c = _chunk_files(cache_b.root), _chunk_files(cache_c.root)
    assert files_c and all(files_c[d] == files_b[d] for d in files_c)
    populated = _populated(cache_c)
    assert populated == len(files_c)
    _warm(url, cache_c)  # a second epoch over the warm mirror populates nothing
    assert _populated(cache_c) == populated
    with open(os.path.join(coord, 'fabric', 'stats', stats_file_name('pC'))) as f:
        stats = json.load(f)
    peer_hits, fallbacks = _peer_totals(stats)
    assert peer_hits + fallbacks == populated
    assert peer_hits > 0 and fallbacks > 0
    assert stats['peers'].get('pA', {}).get('hits', 0) == 0
    assert stats['peers'].get('pA', {}).get('failures', 0) >= 1
    assert drill.snapshot['populated'] == populated
    # the pod's table names the dead peer's failures
    table = diagnose.fabric_peer_table(coord)
    assert table == jax_diagnose.fabric_peer_table(coord)
    assert table['pA']['failures'] >= 1 and table['pB']['hits'] == stats['peers']['pB']['hits']


@needs_native
@pytest.mark.parametrize('server_package', ['jax', 'torch'])
def test_fetch_across_packages_with_byte_equal_mirrors(tmp_path, server_package):
    """A port client fetches from a JAX host's mirror and a JAX client from a
    port host's: every chunk a peer copy, the mirrors byte-equal, each
    package's stats file read by both packages' ``diagnose``."""
    store_path, data = _write_raw_store(tmp_path, rows=24)
    url = 'mock-remote://' + store_path
    coord = str(tmp_path / 'coord')
    client_package = 'torch' if server_package == 'jax' else 'jax'
    pkg = {'torch': (fabric, ChunkCacheConfig), 'jax': (jax_fabric, JaxChunkCacheConfig)}
    srv_fabric, srv_cache_cls = pkg[server_package]
    cli_fabric, cli_cache_cls = pkg[client_package]
    srv_cache = srv_cache_cls(str(tmp_path / 'served'))
    cli_cache = cli_cache_cls(str(tmp_path / 'fetched'))
    _warm(url, srv_cache, server_package)
    server_node = srv_fabric.start_node(srv_fabric.FabricConfig(coord, 'srv', srv_cache))
    try:
        client_node = cli_fabric.start_node(cli_fabric.FabricConfig(coord, 'cli', cli_cache,
                                                                    serve=False))
        cli_fabric.install(client_node)
        try:
            factory = make_reader if client_package == 'torch' else jax_make_reader
            with factory(url, reader_pool_type='thread', workers_count=2,
                         shuffle_row_groups=False, num_epochs=1, chunk_cache=cli_cache) as reader:
                rows = {int(r.label): r.image for r in reader}
        finally:
            cli_fabric.uninstall()
            client_node.stop()
    finally:
        server_node.stop()
    for row in data:
        np.testing.assert_array_equal(rows[row['label']], row['image'])
    served, fetched = _chunk_files(srv_cache.root), _chunk_files(cli_cache.root)
    assert fetched and all(fetched[d] == served[d] for d in fetched)
    name = stats_file_name('cli') if client_package == 'torch' else 'cli-pid{}.json'.format(
        os.getpid())
    with open(os.path.join(coord, 'fabric', 'stats', name)) as f:
        stats = json.load(f)
    assert _peer_totals(stats) == (len(fetched), 0)
    assert diagnose.fabric_peer_table(coord) == jax_diagnose.fabric_peer_table(coord)


def test_clients_of_both_packages_in_one_process_keep_files_of_their_own(tmp_path):
    """A JAX client and a port client of one host id in one process write
    two stats files, and both packages' ``diagnose --fabric`` merge both."""
    served, local, server, payloads = _serving_pair(tmp_path)
    from petastorm_tpu.chunkstore.store import ChunkStore as JaxChunkStore
    coord = str(tmp_path / 'coord')
    try:
        port_client = fabric.FabricClient(local, _StaticPeers('h0', [
            PeerInfo('pA', *server.endpoint)]), coord)
        jax_client = jax_fabric.FabricClient(JaxChunkStore(str(tmp_path / 'jax')), _StaticPeers(
            'h0', [JaxPeerInfo('pA', *server.endpoint)]), coord)
        assert port_client.fetch('k1', 4096, lambda: b'never') == payloads['k1']
        assert jax_client.fetch('k1', 4096, lambda: b'never') == payloads['k1']
        assert jax_client.fetch('k2', 4096, lambda: b'never') == payloads['k2']
        port_client.close()
        jax_client.close()
    finally:
        server.stop()
    files = sorted(os.listdir(os.path.join(coord, 'fabric', 'stats')))
    assert files == sorted([stats_file_name('h0'), 'h0-pid{}.json'.format(os.getpid())])
    table = diagnose.fabric_peer_table(coord)
    assert table == jax_diagnose.fabric_peer_table(coord)
    assert (table['pA']['hits'], table['pA']['bytes']) == (3, 3 * 4096)


def test_install_and_shippable_config(tmp_path):
    cache = ChunkCacheConfig(str(tmp_path / 'c'))
    assert fabric.shippable_config() is None and fabric.installed_node() is None
    with fabric.start_node(fabric.FabricConfig(str(tmp_path / 'coord'), 'h0', cache,
                                               lease_s=1.0, deadline_s=3.0)) as node:
        fabric.install(node)
        try:
            assert store_mod.PEER_SOURCE == node.client.fetch
            assert fabric.installed_node() is node
            shipped = fabric.shippable_config()
            assert (shipped.serve, shipped.join, shipped.host_id, shipped.cache) == (
                False, False, 'h0', cache)
            assert shipped.deadline_s == 3.0 and shipped.lease_s == 1.0
            ours = {k: v for k, v in vars(shipped).items() if k != 'cache'}
            jax_cfg = jax_fabric.FabricConfig(str(tmp_path / 'coord'), 'h0', None, lease_s=1.0,
                                              deadline_s=3.0).for_worker()
            assert ours == {k: v for k, v in vars(jax_cfg).items() if k != 'cache'}
            with open(os.path.join(str(tmp_path / 'coord'), 'members', 'h0.lease')) as f:
                assert json.load(f)['notes'] == {'fabric': list(node.server.endpoint)}
            fabric.install(node.client)  # a bare client: nothing to ship
            assert fabric.shippable_config() is None
        finally:
            fabric.uninstall()
    assert store_mod.PEER_SOURCE is None
    assert not os.listdir(os.path.join(str(tmp_path / 'coord'), 'members'))


@needs_native
def test_process_pool_ships_the_fetch_only_config(tmp_path):
    """The installed node's fetch-only config reaches the spawned workers:
    each installs a node without server or lease, and their stats files
    show the peer copies; the rows are the store's, as a multiset."""
    store_path, data = _write_raw_store(tmp_path, rows=32)
    url = 'mock-remote://' + store_path
    coord = str(tmp_path / 'coord')
    served = ChunkCacheConfig(str(tmp_path / 'served'))
    mine = ChunkCacheConfig(str(tmp_path / 'mine'))
    _warm(url, served)
    with fabric.start_node(fabric.FabricConfig(coord, 'peer', served)), \
            fabric.start_node(fabric.FabricConfig(coord, 'me', mine, serve=False)) as node:
        fabric.install(node)
        try:
            with make_reader(url, reader_pool_type=ProcessPoolOptions(results_timeout_s=60),
                             workers_count=2, shuffle_row_groups=False, num_epochs=1,
                             chunk_cache=mine) as reader:
                labels = sorted(int(r.label) for r in reader)
        finally:
            fabric.uninstall()
    assert labels == [row['label'] for row in data]
    stats_dir = os.path.join(coord, 'fabric', 'stats')
    worker_files = [n for n in os.listdir(stats_dir)
                    if n.startswith('me-pid') and n != stats_file_name('me')]
    assert worker_files, os.listdir(stats_dir)
    hits = fallbacks = 0
    for name in worker_files:
        with open(os.path.join(stats_dir, name)) as f:
            h, fb = _peer_totals(json.load(f))
        hits, fallbacks = hits + h, fallbacks + fb
    assert hits > 0 and fallbacks == 0
    # every chunk the workers or the consumer populated came from the peer
    table = diagnose.fabric_peer_table(coord)
    assert table['peer']['hits'] == _populated(mine)
    assert sorted(os.listdir(os.path.join(coord, 'members'))) == []

