"""The port's shared-memory ring (``native/shm_ring.cpp`` + ``shm_ring.py``)
and slot-lifetime registry (``native/lifetime.py``) against the JAX
package's: the C++ is the JAX package's below the port's header, each
package loads its own library, a ring created by one package carries
messages written by the other, and the lifetime cases of the JAX suite hold
for the port's registry, FIFO ledger and ``PROT_NONE`` guard."""

import gc
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from petastorm_tpu.native import shm_ring as jax_shm_ring
from petastorm_tpu.native.lifetime import SlotRegistry as JaxSlotRegistry
from petastorm_tpu_torch.native import build, shm_ring
from petastorm_tpu_torch.native.lifetime import (COUNTER_KEYS, RingBorrowLedger, SlotRegistry,
                                                 buffer_region, registry)
from petastorm_tpu_torch.native.shm_ring import IdleWait, ShmRing
from petastorm_tpu_torch.workers.protocol import MSG_DATA, MSG_DONE, ring_header, ring_unpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_names = iter(range(1 << 30))


def _name(tag='t'):
    return '/pstpu_tr_{}_{}_{}'.format(os.getpid(), tag, next(_names))


@pytest.fixture
def ring():
    r = ShmRing.create(_name(), 1 << 16)
    yield r
    r.close()


# -- the library ---------------------------------------------------------------------

def test_ring_source_is_the_jax_packages_below_the_header():
    with open(build.RING_SOURCE) as ours, \
            open(os.path.join(REPO, 'petastorm_tpu', 'native', 'shm_ring.cpp')) as theirs:
        body = theirs.read()
        assert ours.read().endswith(body[body.index('#include <atomic>'):])


def test_each_package_loads_its_own_library():
    assert shm_ring.is_available() and jax_shm_ring.is_available()
    assert os.path.dirname(build.RING_OUTPUT) == os.path.join(REPO, '.torch_build', 'native')
    assert not any(f.endswith('.so') for f in os.listdir(os.path.dirname(shm_ring.__file__)))
    # same exported symbols, distinct files: each ctypes handle is its own
    assert shm_ring._lib._name == build.RING_OUTPUT != jax_shm_ring._lib._name
    mtime = os.path.getmtime(build.RING_OUTPUT)
    assert build.build_ring() == build.RING_OUTPUT  # fresh: not rebuilt
    assert os.path.getmtime(build.RING_OUTPUT) == mtime


def test_ring_header_mirror_passes_the_abi_rules_and_catches_drift(tmp_path):
    from petastorm_tpu.analysis import run_analysis

    native = os.path.join(REPO, 'petastorm_tpu_torch', 'native')
    assert shm_ring.RING_HEADER_BYTES == jax_shm_ring.RING_HEADER_BYTES == 64
    mutant = tmp_path / 'native'
    mutant.mkdir()
    for name in ('shm_ring.py', 'shm_ring.cpp'):
        with open(os.path.join(native, name)) as f:
            (mutant / name).write_text(f.read())
    assert run_analysis([str(tmp_path)], select=['PT9']) == []
    text = (mutant / 'shm_ring.cpp').read_text()
    (mutant / 'shm_ring.cpp').write_text(text.replace('  uint64_t capacity;\n  uint64_t magic;',
                                                      '  uint32_t capacity;\n  uint64_t magic;',
                                                      1))
    assert 'PT900' in {f.code for f in run_analysis([str(tmp_path)], select=['PT9'])}


def test_wire_constants_are_the_jax_packages():
    from petastorm_tpu.workers import protocol as jax_protocol
    from petastorm_tpu_torch.workers import protocol

    names = ['CONTROL_FINISHED', 'RING_HEADER_LEN'] + [
        n for n in dir(protocol) if n.startswith('MSG_')]
    assert len(names) == 9
    for name in names:
        assert getattr(protocol, name) == getattr(jax_protocol, name), name
    for kind, d in ((protocol.MSG_DATA, 7), (protocol.MSG_HEARTBEAT, None)):
        assert ring_header(kind, d) == jax_protocol.ring_header(kind, d)
    ids = protocol.DispatchIds()
    assert [ids.next() for _ in range(3)] == [0, 1, 2]


# -- one process ---------------------------------------------------------------------

def test_round_trip_in_one_process():
    name = _name('rt')
    consumer = ShmRing.create(name, 1 << 16)
    producer = ShmRing.attach(name)
    try:
        a = np.arange(5000, dtype=np.uint8)
        assert producer.write2(ring_header(MSG_DATA, 3), a.tobytes())
        assert ring_unpack(consumer.try_read_view())[:2] == (MSG_DATA, 3)
        assert producer.writev([ring_header(MSG_DONE, None), a, np.ones(4)])
        kind, d, payload = ring_unpack(consumer.try_read_view())
        assert (kind, d) == (MSG_DONE, None)
        assert bytes(payload) == a.tobytes() + np.ones(4).tobytes()
        view = producer.try_reserve(100)
        view[:3] = b'abc'
        producer.abort()
        assert not consumer.has_message() and consumer.try_read_zero_copy() is None
        view = producer.try_reserve(a.nbytes)
        np.frombuffer(view, np.uint8)[:] = a[::-1]
        producer.commit(a.nbytes)
        assert consumer.has_message()
        got, span, borrowed = consumer.try_read_zero_copy()
        assert borrowed and bytes(got) == a[::-1].tobytes() and not consumer.has_message()
        assert span >= a.nbytes + 8
        with pytest.raises(ValueError, match='ring_bytes'):
            producer.try_reserve(1 << 17)
        with pytest.raises(ValueError, match='ring_bytes'):
            producer.writev([bytes(1 << 17)])
        consumer.release(span)
    finally:
        producer.close()
        consumer.close()


def test_attach_and_create_failures_raise():
    with pytest.raises(OSError, match='attach failed'):
        ShmRing.attach(_name('missing'))
    with pytest.raises(OSError, match='create failed'):
        ShmRing.create(_name('small'), 1024)  # below the 4096-byte minimum


@pytest.mark.parametrize('creator', ['jax', 'torch'])
def test_a_ring_of_one_package_carries_the_others_messages(creator):
    """Same layout, same framing: a ring created by either package is
    attached by the other, and write2, writev and in-place reservations
    cross in both directions."""
    packages = {'jax': jax_shm_ring.ShmRing, 'torch': ShmRing}
    other = 'torch' if creator == 'jax' else 'jax'
    name = _name('x' + creator)
    consumer = packages[creator].create(name, 1 << 16)
    producer = packages[other].attach(name)
    try:
        a = np.random.default_rng(1).integers(0, 256, 3000, dtype=np.uint8)
        assert producer.write2(ring_header(MSG_DATA, 11), a.tobytes())
        assert producer.writev([ring_header(MSG_DATA, 12), a, a[:10]])
        view = producer.reserve(a.nbytes)
        view[:] = a.tobytes()
        producer.commit(a.nbytes)
        got = [ring_unpack(consumer.try_read_view()) for _ in range(2)]
        assert [g[:2] for g in got] == [(MSG_DATA, 11), (MSG_DATA, 12)]
        assert bytes(got[0][2]) == a.tobytes()
        assert bytes(got[1][2]) == a.tobytes() + a[:10].tobytes()
        view, span, borrowed = consumer.try_read_zero_copy()
        assert borrowed and bytes(view) == a.tobytes()
        consumer.release(span)
        assert consumer.try_read_view() is None
    finally:
        producer.close()
        consumer.close()


def test_idle_wait_escalates_and_resets(monkeypatch):
    sleeps, yields = [], []
    monkeypatch.setattr(shm_ring.time, 'sleep', sleeps.append)
    monkeypatch.setattr(shm_ring.os, 'sched_yield', lambda: yields.append(1))
    idle = IdleWait(spins=2, yields=2, sleep_s=0.001, max_sleep_s=0.004)
    for _ in range(8):
        idle.wait()
    assert len(yields) == 2 and sleeps == [0.001, 0.002, 0.004, 0.004]
    idle.reset()
    idle.wait()
    assert len(sleeps) == 4


# -- slot units (the JAX suite's cases on the port's registry) -------------------------

def test_last_borrow_death_fires_release_once():
    reg = SlotRegistry()
    fired = []
    slot = reg.open_slot(on_release=lambda: fired.append(1))
    a = np.arange(8)
    b = {'nested': [a[2:]]}  # derived view: its base rides along
    slot.adopt(a)
    slot.adopt(b)
    slot.seal()
    assert slot.live == 2 and fired == []
    del a
    gc.collect()
    assert fired == []  # the slice in b keeps its base alive
    del b
    gc.collect()
    assert fired == [1]
    assert reg.counters()['lifetime_live_borrows'] == 0


def test_seal_with_no_borrows_releases_immediately():
    reg = SlotRegistry()
    fired = []
    slot = reg.open_slot(on_release=lambda: fired.append(1))
    slot.seal()
    assert fired == [1] and slot.released


def test_release_now_is_idempotent_and_reclaim_agrees():
    reg = SlotRegistry()
    fired = []
    slot = reg.open_slot(on_release=lambda: fired.append(1))
    slot.release_now()
    slot.release_now()
    assert fired == [1]
    assert slot.try_reclaim() is True
    assert fired == [1]
    assert reg.counters()['lifetime_blocked_reclaims'] == 0


def test_try_reclaim_refuses_while_borrows_live():
    reg = SlotRegistry()
    slot = reg.open_slot()
    arr = np.zeros(4)
    slot.adopt(arr)
    slot.seal()
    assert slot.try_reclaim() is False
    assert reg.counters()['lifetime_blocked_reclaims'] == 1
    del arr
    gc.collect()
    assert slot.try_reclaim() is True


def test_force_reclaim_over_live_borrow_counts_guard_fault(monkeypatch):
    monkeypatch.delenv('PSTPU_LIFETIME_GUARD', raising=False)
    reg = SlotRegistry()
    fired = []
    slot = reg.open_slot(on_release=lambda: fired.append(1))
    arr = np.zeros(4)
    slot.adopt(arr)
    slot.seal()
    slot.force_reclaim()
    assert fired == [1]
    assert reg.counters()['lifetime_guard_faults'] == 1
    del arr  # the late finalizer must not fire again
    gc.collect()
    assert fired == [1]


def test_buffer_region_resolves_arrays_and_views():
    arr = np.arange(16, dtype=np.uint8)
    addr, nbytes = buffer_region(arr)
    assert addr == arr.ctypes.data and nbytes == 16
    assert buffer_region(memoryview(arr)) == (addr, 16)
    assert buffer_region(object()) is None


@pytest.mark.parametrize('pool', ['thread', 'dummy', 'process'])
def test_pool_diagnostics_carry_the_lifetime_family(pool):
    from petastorm_tpu_torch.workers import DummyPool, ProcessPool, ThreadPool

    make = {'thread': lambda: ThreadPool(1), 'dummy': DummyPool,
            'process': lambda: ProcessPool(1)}[pool]
    assert set(COUNTER_KEYS) <= set(make().diagnostics)


def test_a_slice_of_a_delivered_view_keeps_the_borrow():
    """Delivered columns are reshaped ``np.frombuffer`` views, and numpy
    collapses view chains: a user's slice has the frombuffer array as its
    base, not the delivered array. The port's slot holds the borrow on that
    root, so the slice keeps it; the JAX package's registry releases the
    slot while the slice still reads the ring's bytes."""
    msg = bytearray(64)
    results = {}
    for name, reg in (('torch', SlotRegistry()), ('jax', JaxSlotRegistry())):
        fired = []
        slot = reg.open_slot(on_release=lambda fired=fired: fired.append(1))
        delivered = np.frombuffer(memoryview(msg), dtype=np.uint8).reshape(8, 8)
        user_slice = delivered[2:4]
        slot.adopt({'image': delivered})
        slot.seal()
        del delivered
        gc.collect()
        results[name] = list(fired)
        del user_slice
        gc.collect()
        assert fired == [1]
    assert results == {'torch': [], 'jax': [1]}


def test_object_columns_hold_their_cells():
    reg = SlotRegistry()
    fired = []
    slot = reg.open_slot(on_release=lambda: fired.append(1))
    buf = bytearray(32)
    col = np.empty(2, dtype=object)
    col[0] = np.frombuffer(memoryview(buf)[:16], np.uint8).reshape(4, 4)
    col[1] = np.frombuffer(memoryview(buf)[16:], np.uint8).reshape(4, 4)
    cell = col[1]
    slot.adopt({'image': col})
    slot.seal()
    del col
    gc.collect()
    assert fired == []  # the cell a user kept holds the slot
    del cell
    gc.collect()
    assert fired == [1]


# -- the FIFO ledger over arbitrary finalizer order -----------------------------------

def _take_all(ring, ledger):
    out = []
    while True:
        item = ring.try_read_zero_copy()
        if item is None:
            return out
        view, span, borrowed = item
        slot = ledger.take(view, span, borrowed)
        out.append((bytes(view), slot))


def test_ledger_retires_fifo_despite_out_of_order_release(ring):
    ledger = RingBorrowLedger(ring, registry_=SlotRegistry())
    for i in range(3):
        assert ring.try_write(bytes([i]) * 64)
    taken = _take_all(ring, ledger)
    assert [p[0] for p, _ in taken] == [0, 1, 2]
    taken[2][1].release_now()
    taken[1][1].release_now()
    assert ledger.live == 1  # the head may not pass the unreleased first span
    taken[0][1].release_now()
    assert ledger.live == 0
    assert ring.try_write(b'z' * 1024)


def test_ledger_defers_close_until_drained(ring):
    reg = SlotRegistry()
    ledger = RingBorrowLedger(ring, registry_=reg)
    assert ring.try_write(b'x' * 32)
    (_, slot), = _take_all(ring, ledger)
    closed = []
    assert ledger.close_when_drained(lambda: closed.append(1)) is False
    assert closed == [] and reg.counters()['lifetime_blocked_reclaims'] == 1
    slot.release_now()
    assert closed == [1]


def test_ledger_closes_immediately_when_empty(ring):
    ledger = RingBorrowLedger(ring, registry_=SlotRegistry())
    closed = []
    assert ledger.close_when_drained(lambda: closed.append(1)) is True
    assert closed == [1]


def test_has_message_skips_peeked_but_unreleased(ring):
    ledger = RingBorrowLedger(ring, registry_=SlotRegistry())
    assert ring.try_write(b'a' * 16) and ring.try_write(b'b' * 16)
    assert ring.has_message()
    taken = _take_all(ring, ledger)
    assert len(taken) == 2
    assert not ring.has_message()
    for _, slot in taken:
        slot.release_now()
    assert not ring.has_message()


def test_ledger_release_order_fuzz(ring):
    hyp = pytest.importorskip('hypothesis')
    from hypothesis import strategies as st

    @hyp.given(st.permutations(range(8)), st.integers(16, 512))
    @hyp.settings(max_examples=25, deadline=None)
    def run(order, size):
        reg = SlotRegistry()
        ledger = RingBorrowLedger(ring, registry_=reg)
        payloads = [bytes([i]) * size for i in range(8)]
        for p in payloads:
            assert ring.try_write(p)
        taken = _take_all(ring, ledger)
        assert [p for p, _ in taken] == payloads
        for i in order:
            taken[i][1].release_now()
        assert ledger.live == 0
        assert reg.counters()['lifetime_live_borrows'] == 0
        assert not ring.has_message()

    run()


def test_process_global_registry_is_one_object():
    assert registry() is registry()


# -- the PROT_NONE guard -----------------------------------------------------------------

_GUARD_PROBE = textwrap.dedent('''
    import mmap
    import numpy as np
    from petastorm_tpu_torch.native.lifetime import SlotRegistry, buffer_region
    mm = mmap.mmap(-1, 4096)
    arr = np.frombuffer(mm, dtype=np.uint8)
    reg = SlotRegistry()
    slot = reg.open_slot(guard_region=buffer_region(arr), label='probe')
    view = arr[:64]
    slot.adopt(view)
    slot.seal()
    slot.force_reclaim()  # live borrow: counted, and PROT_NONE under the guard
    assert reg.counters()['lifetime_guard_faults'] == 1
    print('PRE-TOUCH', flush=True)
    print(int(view[0]))  # use after release: dies here under the guard
    print('POST-TOUCH', flush=True)
''')


@pytest.mark.parametrize('guard', [True, False])
def test_guard_faults_use_after_release(guard):
    env = dict(os.environ, PSTPU_LIFETIME_GUARD='1' if guard else '0',
               PYTHONPATH=os.pathsep.join([REPO] + sys.path))
    res = subprocess.run([sys.executable, '-c', _GUARD_PROBE], capture_output=True, text=True,
                         env=env, timeout=120, cwd=REPO)
    assert 'PRE-TOUCH' in res.stdout
    if guard:
        assert 'POST-TOUCH' not in res.stdout and res.returncode != 0  # SIGSEGV, not an exit
    else:
        assert res.returncode == 0 and 'POST-TOUCH' in res.stdout, res.stderr
