"""Port parity: the broadcast ring of petastorm_tpu_torch against the JAX
package's, case for case with the ring units of ``tests/test_serve.py``.

Each case runs on both packages' bindings (each over its own ring library),
and on the port's ring attached by the JAX binding and the reverse: the
segment layout is one, so a ring created by either package reads the same in
the other. Every ring is closed (its creator unlinks the name) and the module
leaves no ``/dev/shm`` segment of its own behind."""

import os
import threading
import time

import pytest

from petastorm_tpu.native import shm_ring as jax_shm_ring
from petastorm_tpu_torch.native import shm_ring

RINGS = {'jax': jax_shm_ring, 'torch': shm_ring}
#: (creating package, attaching package)
PAIRS = [('jax', 'jax'), ('torch', 'torch'), ('torch', 'jax'), ('jax', 'torch')]


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


@pytest.fixture
def ring_name(request):
    name = '/pstpu_t_tbc_{}_{}'.format(os.getpid(), abs(hash(request.node.name)) % 10 ** 8)
    yield name
    assert not os.path.exists('/dev/shm' + name), 'ring segment left behind'


def _rings(pair, name, capacity):
    creator, attacher = (RINGS[p] for p in pair)
    ring = creator.BcastRing.create(name, capacity)
    return ring, attacher.BcastRing.attach(name), RINGS[pair[1]]


def test_header_mirrors_are_one_layout():
    assert shm_ring.BCAST_HEADER_BYTES == jax_shm_ring.BCAST_HEADER_BYTES
    assert shm_ring.BcastHeaderStruct._fields_ == jax_shm_ring.BcastHeaderStruct._fields_
    assert shm_ring.BCAST_MAX_CONSUMERS == jax_shm_ring.BCAST_MAX_CONSUMERS == 8
    assert (shm_ring.BCAST_ATTACHED, shm_ring.BCAST_EVICTED) == (
        jax_shm_ring.BCAST_ATTACHED, jax_shm_ring.BCAST_EVICTED)


@pytest.mark.parametrize('pair', PAIRS, ids=['-'.join(p) for p in PAIRS])
def test_min_head_reclamation_and_tokens(pair, ring_name):
    ring, consumer, consumer_pkg = _rings(pair, ring_name, 4096)
    try:
        t1, t2 = ring.join(), ring.join()
        payload = b'x' * 900
        wrote = 0
        while ring.try_write(payload):
            wrote += 1
        assert wrote >= 3
        # each consumer's cursor advance is its release: the bytes come back
        # only once the last attached consumer passed them
        assert not ring.try_write(payload)
        assert bytes(consumer.try_read_view(t1)) == payload
        assert not ring.try_write(payload)     # t2 still holds the bytes
        assert bytes(consumer.try_read_view(t2)) == payload
        assert ring.try_write(payload)         # reclaimed exactly then
        assert ring.min_head() <= ring.tail()
        # a leave frees the slot for a new grant; the stale token is refused
        consumer.leave(t2)
        t3 = ring.join()
        with pytest.raises(consumer_pkg.BcastConsumerGone) as e:
            consumer.try_read_view(t2)
        assert not e.value.evicted
        assert ring.consumer_count() == 2
        assert t3 != t2
        assert ring.state(t1) == 1
        consumer.close()
    finally:
        ring.close()


@pytest.mark.parametrize('pair', PAIRS, ids=['-'.join(p) for p in PAIRS])
def test_eviction_unblocks_the_producer(pair, ring_name):
    ring, consumer, consumer_pkg = _rings(pair, ring_name, 4096)
    try:
        fast, slow = ring.join(), ring.join()
        payload = b'y' * 1500
        assert ring.try_write(payload)
        assert consumer.try_read_view(fast) is not None
        assert ring.try_write(payload)
        assert consumer.try_read_view(fast) is not None
        assert not ring.try_write(payload)  # the slow consumer holds 2 messages
        assert ring.lag(slow) > ring.lag(fast)
        assert ring.evict(slow)
        assert ring.state(slow) == 2
        assert ring.try_write(payload)      # the others flow again
        with pytest.raises(consumer_pkg.BcastConsumerGone) as e:
            consumer.try_read_view(slow)
        assert e.value.evicted
        consumer.close()
    finally:
        ring.close()


@pytest.mark.parametrize('pair', PAIRS, ids=['-'.join(p) for p in PAIRS])
def test_writev_and_reserve_reach_every_consumer(pair, ring_name):
    ring, consumer, _ = _rings(pair, ring_name, 1 << 16)
    try:
        tokens = [ring.join() for _ in range(3)]
        assert ring.try_writev([b'head', b'', bytearray(b'-body-'), b'tail'])
        region = ring.try_reserve(64)
        region[:5] = b'slot!'
        ring.commit(5)
        region = ring.try_reserve(32)
        ring.abort()                        # nothing became visible
        assert ring.try_write(b'last')
        for token in tokens:
            got = [bytes(consumer.read_view(token, timeout_s=1)) for _ in range(3)]
            assert got == [b'head-body-tail', b'slot!', b'last']
            assert consumer.try_read_view(token) is None
            assert consumer.read_view(token, timeout_s=0.01) is None
        with pytest.raises(ValueError):
            ring.try_write(b'z' * (1 << 17))   # can never fit
        consumer.close()
    finally:
        ring.close()


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_every_slot_taken_refuses_a_join(package, ring_name):
    ring = RINGS[package].BcastRing.create(ring_name, 4096)
    try:
        tokens = [ring.join() for _ in range(RINGS[package].BCAST_MAX_CONSUMERS)]
        assert len(set(tokens)) == 8
        with pytest.raises(OSError):
            ring.join()
        assert ring.consumer_count() == 8
    finally:
        ring.close()
    assert ring.consumer_count() == 0 and ring.min_head() == 0   # a closed ring


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_idle_wait_escalates_and_counts_spins(package):
    if package == 'jax':
        from petastorm_tpu import observability as pkg_obs
    else:
        from petastorm_tpu_torch import observability as pkg_obs
    saved = pkg_obs.configure(None)
    pkg_obs.configure('counters')
    pkg_obs.get_registry().reset()
    try:
        idle = RINGS[package].IdleWait(spins=8, yields=4, sleep_s=0.0001, max_sleep_s=0.0004)
        t0 = time.monotonic()
        for _ in range(8):
            idle.wait()          # the spin tier: no sleep
        assert time.monotonic() - t0 < 0.05
        for _ in range(10):
            idle.wait()          # the yield, then the sleep tier
        idle.reset()
        assert pkg_obs.snapshot()['counters'].get('ring_idle_spins', 0) == 8
    finally:
        pkg_obs.configure(saved)
