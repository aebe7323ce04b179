"""Port parity: the device infeed of petastorm_tpu_torch (stage_batch,
prefetch_to_device) against the JAX package's, on the CPU. The CUDA side
(pinned host memory, a side stream and an event per batch) runs on the card
in ``chip_smoke.py``, which checks the staged batch against the store."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from petastorm_tpu.jax import prefetch_to_device as jax_prefetch_to_device
from petastorm_tpu.jax.infeed import stage_batch as jax_stage_batch
from petastorm_tpu_torch.torch import prefetch_to_device, stage_batch


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


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    strings = np.empty(4, dtype=object)
    strings[:] = ['a', 'b', 'c', 'd']
    return {'image': rng.integers(0, 256, (4, 3, 3, 2), dtype=np.uint8),
            'u16': rng.integers(0, 2 ** 16, 4).astype(np.uint16),
            'u32': rng.integers(0, 2 ** 32, 4).astype(np.uint32),
            'f32': rng.standard_normal(4).astype(np.float32),
            'flag': rng.random(4) < 0.5,
            'name': strings,
            'nested': {'label': np.arange(4, dtype=np.int64)}}


def _flatten(batch, prefix=''):
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + '.')
        else:
            yield prefix + k, v


def test_stage_batch_matches_jax_stage_batch():
    batch = _batch()
    expected = dict(_flatten(jax_stage_batch(batch, jax.devices('cpu')[0])))
    staged = dict(_flatten(stage_batch(batch, 'cpu')))
    assert set(staged) == set(expected)
    for name, value in staged.items():
        if name == 'name':  # non-numeric columns stay numpy in both
            assert isinstance(value, np.ndarray) and value.dtype == object
            assert list(value) == list(expected[name])
            continue
        assert isinstance(value, torch.Tensor) and value.device.type == 'cpu', name
        np.testing.assert_array_equal(value.numpy(), np.asarray(expected[name]), err_msg=name)
    # torch's promotions of the unsigned types it cannot hold
    assert staged['u16'].dtype == torch.int32 and staged['u32'].dtype == torch.int64
    assert staged['image'].dtype == torch.uint8 and staged['flag'].dtype == torch.bool


@pytest.mark.parametrize('background', [True, False])
@pytest.mark.parametrize('size', [1, 2, 5])
def test_prefetch_matches_jax_prefetch(background, size):
    batches = [_batch(seed) for seed in range(4)]
    expected = list(jax_prefetch_to_device(iter(batches), jax.devices('cpu')[0], size=size,
                                           background=background))
    actual = list(prefetch_to_device(iter(batches), 'cpu', size=size, background=background))
    assert len(actual) == len(expected) == 4
    for a, e in zip(actual, expected):
        for (name, av), (_, ev) in zip(_flatten(a), _flatten(e)):
            np.testing.assert_array_equal(np.asarray(av), np.asarray(ev), err_msg=name)


@pytest.mark.parametrize('background', [True, False])
def test_prefetch_reraises_source_errors_on_consumer(background):
    def source():
        yield _batch()
        raise KeyError('broken store')

    # size 1: the synchronous mode stages ``size`` batches ahead of the first
    it = prefetch_to_device(source(), 'cpu', size=1, background=background)
    assert torch.equal(next(it)['image'], torch.from_numpy(_batch()['image']))
    with pytest.raises(KeyError, match='broken store'):
        next(it)


def test_prefetch_stops_its_thread_when_closed():
    def endless():
        while True:
            yield _batch()

    before = set(threading.enumerate())
    it = prefetch_to_device(endless(), 'cpu', size=2)
    next(it)
    started = [t for t in threading.enumerate()
               if t not in before and t.name == 'pstpu-torch-prefetch']
    assert len(started) == 1
    it.close()
    # the thread this iterator started, by identity: threads of other
    # iterators in the same process are not this test's
    assert not started[0].is_alive()
    with pytest.raises(ValueError, match='size'):
        prefetch_to_device(iter([]), 'cpu', size=0)
