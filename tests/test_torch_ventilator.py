"""Port parity: the ventilator of petastorm_tpu_torch against the JAX
package's, case for case with ``tests/test_ventilator.py``, plus its item
tagging and read-position states: for one seed both ventilate the same items
in the same order, tag them with the same seqs, and take and resume the same
state dicts."""

import threading
import time

import pytest

from petastorm_tpu.workers import ConcurrentVentilator as JaxConcurrentVentilator
from petastorm_tpu_torch.errors import EmptyResultError
from petastorm_tpu_torch.test_util.stub_workers import IdentityWorker
from petastorm_tpu_torch.workers import ConcurrentVentilator, DummyPool, ThreadPool


def _drain(pool, limit=None):
    results = []
    while limit is None or len(results) < limit:
        try:
            results.append(pool.get_results())
        except EmptyResultError:
            break
    return results


def test_ventilator_feeds_all_items():
    pool = ThreadPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(40)])
    pool.start(IdentityWorker, ventilator=vent)
    assert sorted(_drain(pool)) == list(range(40))
    pool.stop()
    pool.join()


def test_bounded_in_flight():
    observed_max = [0]
    in_flight = [0]
    lock = threading.Lock()

    class TrackingPool(ThreadPool):
        def ventilate(self, *args, **kwargs):
            with lock:
                in_flight[0] += 1
                observed_max[0] = max(observed_max[0], in_flight[0])
            super().ventilate(*args, **kwargs)

    class CountingWorker(IdentityWorker):
        def process(self, value):
            with lock:
                in_flight[0] -= 1
            self.publish(value)

    pool = TrackingPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(50)],
                                max_ventilation_queue_size=5)
    pool.start(CountingWorker, ventilator=vent)
    assert len(_drain(pool)) == 50
    assert observed_max[0] <= 5 + 2  # the decrement happens when processing starts
    pool.stop()
    pool.join()


def test_multiple_iterations():
    pool = ThreadPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(10)], iterations=3)
    pool.start(IdentityWorker, ventilator=vent)
    assert sorted(_drain(pool)) == sorted(list(range(10)) * 3)
    pool.stop()
    pool.join()


def test_infinite_iterations_and_stop():
    pool = ThreadPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(5)],
                                iterations=None, max_ventilation_queue_size=10)
    pool.start(IdentityWorker, ventilator=vent)
    assert len(_drain(pool, limit=50)) == 50
    pool.stop()
    pool.join()


def _order(cls, seed, n=100, **kwargs):
    """The ventilated item values (with their seqs when tagged), in order,
    each processed as soon as it is ventilated."""
    order = []

    def ventilate(value, _seq=None):
        order.append(value if _seq is None else (value, _seq))
        vent.processed_item()

    vent = cls(ventilate, [{'value': i} for i in range(n)], randomize_item_order=True,
               random_seed=seed, **kwargs)
    vent.start()
    deadline = time.monotonic() + 30
    while not vent.completed() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert vent.completed()
    return order, vent


@pytest.mark.parametrize('tag_items', [False, True])
def test_randomized_order_seeded_matches_jax(tag_items):
    orders = [_order(cls, 7, iterations=2, tag_items=tag_items)[0]
              for cls in (ConcurrentVentilator, JaxConcurrentVentilator)]
    assert orders[0] == orders[1]
    values = [o[0] if tag_items else o for o in orders[0]]
    assert values[:100] != sorted(values[:100])
    if tag_items:
        assert [o[1] for o in orders[0]] == list(range(200))


def test_unseeded_orders_differ():
    assert _order(ConcurrentVentilator, None)[0] != _order(ConcurrentVentilator, None)[0]


def test_reset_replays_items():
    pool = ThreadPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(10)])
    pool.start(IdentityWorker, ventilator=vent)
    assert sorted(_drain(pool)) == list(range(10))
    vent.reset()
    assert sorted(_drain(pool)) == list(range(10))
    pool.stop()
    pool.join()


def test_reset_while_running_raises():
    vent = ConcurrentVentilator(lambda value: time.sleep(0.001),
                                [{'value': i} for i in range(1000)], max_ventilation_queue_size=1)
    vent.start()
    with pytest.raises(RuntimeError):
        vent.reset()
    vent.stop()


def test_bad_iterations_rejected():
    with pytest.raises(ValueError):
        ConcurrentVentilator(lambda: None, [], iterations=0)
    with pytest.raises(ValueError):
        ConcurrentVentilator(lambda: None, [], iterations=-1)


def _partial_state(cls, delivered, ventilated=12):
    """A seeded ventilator over 10 items x 2 epochs that ventilated
    ``ventilated`` items, of which the seqs ``delivered`` were delivered."""
    seqs = []
    gate = threading.Semaphore(0)

    def ventilate(value, _seq):
        seqs.append((value, _seq))
        gate.release()

    vent = cls(ventilate, [{'value': i} for i in range(10)], iterations=2,
               max_ventilation_queue_size=ventilated, randomize_item_order=True, random_seed=3,
               tag_items=True)
    vent.start()
    for _ in range(ventilated):
        assert gate.acquire(timeout=30)
    for seq in delivered:
        vent.mark_delivered(seq)
    state = vent.state_dict()
    vent.stop()
    return seqs, state


@pytest.mark.parametrize('delivered', [[], [0, 1, 2], list(range(12)), [11, 3, 5]])
def test_state_dict_matches_jax(delivered):
    port = _partial_state(ConcurrentVentilator, delivered)
    jax = _partial_state(JaxConcurrentVentilator, delivered)
    assert port == jax
    seqs, state = port
    # the undelivered items of the first 12, in seq order, then the rest of
    # epoch 2; one epoch left after it
    undelivered = [v for v, seq in seqs if seq not in delivered]
    assert state['replay_indices'][:len(undelivered)] == undelivered
    assert len(state['replay_indices']) == len(undelivered) + 8
    assert state['iterations_remaining'] == 0


def _resumed_values(cls, state):
    """The item values a ventilator resumed from ``state`` ventilates."""
    order, _ = _order(cls, 3, n=10, iterations=2, tag_items=True, resume_state=state)
    return [value for value, _ in order]


@pytest.mark.parametrize('taken_by', [ConcurrentVentilator, JaxConcurrentVentilator])
def test_resume_replays_then_continues_like_jax(taken_by):
    _, state = _partial_state(taken_by, [0, 1, 2, 3])
    port = _resumed_values(ConcurrentVentilator, state)
    assert port == _resumed_values(JaxConcurrentVentilator, state)
    assert port == state['replay_indices']


def test_resume_continues_the_seeded_epochs():
    # a state taken in epoch 1 resumes its tail, then epoch 2 drawn from the
    # saved RNG: the uninterrupted run's order
    full, _ = _order(ConcurrentVentilator, 3, n=10, iterations=2)
    seqs, state = _partial_state(ConcurrentVentilator, list(range(6)), ventilated=6)
    assert state['iterations_remaining'] == 1
    assert [v for v, _ in seqs] + _resumed_values(ConcurrentVentilator, state) == full


def test_resume_state_checks():
    with pytest.raises(ValueError, match='tag_items'):
        ConcurrentVentilator(lambda value: None, [{'value': 0}],
                             resume_state={'replay_indices': [], 'iterations_remaining': 0})
    with pytest.raises(ValueError, match='out of range'):
        ConcurrentVentilator(lambda value, _seq: None, [{'value': 0}], tag_items=True,
                             resume_state={'replay_indices': [3], 'iterations_remaining': 0})
    with pytest.raises(RuntimeError, match='tag_items'):
        ConcurrentVentilator(lambda value: None, [{'value': 0}]).state_dict()


@pytest.mark.parametrize('pool_cls', [ThreadPool, DummyPool])
def test_pools_report_seqs_and_delivered_completions(pool_cls):
    pool = pool_cls(2) if pool_cls is ThreadPool else pool_cls()
    done = []
    pool.done_callback = done.append
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(6)],
                                tag_items=True)
    pool.start(IdentityWorker, ventilator=vent)
    got = {}
    while True:
        try:
            value = pool.get_results()
        except EmptyResultError:
            break
        got[pool.last_result_seq] = value
    pool.stop()
    pool.join()
    assert sorted(got) == list(range(6)) and sorted(got.values()) == list(range(6))
    assert sorted(done) == list(range(6))
