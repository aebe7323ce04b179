"""Port parity: the worker pools take the JAX package's constructor
arguments, in the JAX order, and report ``results_qsize`` as the JAX pools
do.

Each case builds the JAX pool and the port's with the same positional and
keyword arguments, runs the same items through each package's
``IdentityWorker`` and compares what the pools report: ``results_qsize``
once the workers have settled and after the drain, the items delivered, the
protocol monitor and zero-copy settings a positional call reaches, and, for
a profiled thread pool, the cProfile table ``join`` prints (the JAX pool's
``join`` raises there on Python 3.12 instead; the test holds it to that)."""

import time

import pytest

from petastorm_tpu.errors import EmptyResultError as JaxEmptyResultError
from petastorm_tpu.test_util import stub_workers as jax_stub_workers
from petastorm_tpu.workers import dummy_pool as jax_dummy_pool
from petastorm_tpu.workers import process_pool as jax_process_pool
from petastorm_tpu.workers import thread_pool as jax_thread_pool
from petastorm_tpu_torch.errors import EmptyResultError
from petastorm_tpu_torch.test_util import stub_workers
from petastorm_tpu_torch.workers import DummyPool, ProcessPool, ThreadPool

PACKAGES = {
    'jax': {'DummyPool': jax_dummy_pool.DummyPool, 'ThreadPool': jax_thread_pool.ThreadPool,
            'ProcessPool': jax_process_pool.ProcessPool, 'worker': jax_stub_workers.IdentityWorker,
            'empty': JaxEmptyResultError},
    'torch': {'DummyPool': DummyPool, 'ThreadPool': ThreadPool, 'ProcessPool': ProcessPool,
              'worker': stub_workers.IdentityWorker, 'empty': EmptyResultError},
}

#: (pool class, positional arguments, keyword arguments)
CASES = {
    'dummy_positional': ('DummyPool', (1,), {}),
    'dummy_keywords': ('DummyPool', (), {'workers_count': 1, 'results_queue_size': None}),
    'dummy_policy': ('DummyPool', (2, 10, 'retry', 1), {}),
    'thread_positional': ('ThreadPool', (2, 50, False), {}),
    'thread_profiled': ('ThreadPool', (2, 50, True), {}),
    'thread_policy': ('ThreadPool', (2, 50, False, 'retry', 1, True), {}),
    'process_keywords': ('ProcessPool', (2,), {'results_timeout_s': 60,
                                               'protocol_monitor': True, 'zero_copy': False}),
    # every argument in the JAX order, so a monitor and zero-copy swapped
    # into each other's place would show
    'process_positional': ('ProcessPool', (1, 50, None, 60, 'shm', 4 << 20, 1 << 20, 'raise',
                                           None, True, 0.5, True, False), {}),
}

ITEMS = list(range(8))


def _settled(read, polls=10, interval_s=0.02, timeout_s=20):
    """``read()`` once it has returned the same value ``polls`` times in a
    row (the workers are done with the ventilated items)."""
    deadline = time.monotonic() + timeout_s
    last, same = read(), 0
    while same < polls and time.monotonic() < deadline:
        time.sleep(interval_s)
        value = read()
        same = same + 1 if value == last else 0
        last = value
    return last


def _run(package, case):
    kind, args, kwargs = CASES[case]
    names = PACKAGES[package]
    pool = names[kind](*args, **kwargs)
    pool.start(names['worker'])
    seen = {'monitor': pool.protocol_monitor is not None,
            'zero_copy': pool.diagnostics.get('zero_copy'),
            'workers_count': pool.workers_count}
    try:
        for item in ITEMS:
            pool.ventilate(item)
        seen['settled_qsize'] = _settled(lambda: pool.results_qsize)
        delivered = []
        while True:
            try:
                delivered.append(pool.get_results())
            except names['empty']:
                break
        seen['drained_qsize'] = pool.results_qsize
    finally:
        pool.stop()
        if (package, case) == ('jax', 'thread_profiled'):
            # the JAX join builds pstats.Stats from Stats objects, which
            # Python 3.12 refuses (petastorm_tpu/workers/thread_pool.py:256-258)
            with pytest.raises(TypeError, match='Cannot create or construct'):
                pool.join()
        else:
            pool.join()
    seen['delivered'] = sorted(delivered)
    return seen


@pytest.mark.parametrize('case', sorted(CASES))
def test_pools_take_the_jax_arguments(case, capsys):
    jax_seen = _run('jax', case)
    jax_out = capsys.readouterr().out
    seen = _run('torch', case)
    out = capsys.readouterr().out
    assert seen == jax_seen
    assert seen['delivered'] == ITEMS
    if case == 'thread_profiled':
        # the workers' cumulative profile, printed at join as the JAX pool
        # means to (it raises first, above)
        assert 'function calls' in out and 'cumulative' in out
        assert 'process' in out  # IdentityWorker.process ran under the profiler
    else:
        assert 'function calls' not in out
    assert 'function calls' not in jax_out


def test_results_qsize_counts_what_waits_in_each_pool():
    # a dummy pool runs its worker inside get_results: the item's completion
    # waits behind the payload it returned
    pool = DummyPool(1)
    pool.start(stub_workers.IdentityWorker)
    try:
        pool.ventilate(7)
        assert pool.results_qsize == 0
        assert pool.get_results() == 7
        assert pool.results_qsize == 1
        with pytest.raises(EmptyResultError):
            pool.get_results()
        assert pool.results_qsize == 0
    finally:
        pool.stop()
        pool.join()
    # a thread pool's queue holds a payload and a completion per item
    pool = ThreadPool(1, 50, False)
    pool.start(stub_workers.IdentityWorker)
    try:
        for item in ITEMS:
            pool.ventilate(item)
        assert _settled(lambda: pool.results_qsize) == 2 * len(ITEMS)
    finally:
        pool.stop()
        pool.join()


class SleepyWorker(stub_workers.IdentityWorker):
    """Publishes each value after a sleep, which releases the interpreter
    lock, so the workers' items overlap as a reader's do in Arrow or I/O."""

    def process(self, value):
        time.sleep(0.01)
        self.publish(value)


def test_profiled_thread_pool_delivers_items_that_overlap(capsys):
    items = list(range(50))
    pool = ThreadPool(4, 50, True)
    pool.start(SleepyWorker)
    try:
        for item in items:
            pool.ventilate(item)
        got = []
        while True:
            try:
                got.append(pool.get_results())
            except EmptyResultError:
                break
    finally:
        pool.stop()
        threads = list(pool._threads)
        pool.join()
    assert sorted(got) == items
    assert not any(t.is_alive() for t in threads)
    # every item ran under the profiler join printed
    process_rows = [line for line in capsys.readouterr().out.splitlines()
                    if line.rstrip().endswith('(process)')]
    assert sum(int(row.split()[0].split('/')[0]) for row in process_rows) == len(items)
