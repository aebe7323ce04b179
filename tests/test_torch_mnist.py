"""Port parity: ``MnistCNN`` of petastorm_tpu_torch against the flax model of
``petastorm_tpu/models/mnist.py``, with the flax weights carried over by
``flax_to_torch``: the forward pass (float32 within 1e-5, bfloat16 within
2e-2, both of the logits' scale where it exceeds 1), five SGD steps of the
port's train step against JAX's ``make_train_step`` on the same batches
(losses and parameters within 1e-5), and the eval step."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import MnistCNN as JaxMnistCNN
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_eval_step as jax_make_eval_step
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu_torch.models import MnistCNN
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_eval_step, make_train_step

F32_TOL = 1e-5
BF16_TOL = 2e-2
STEP_TOL = 1e-5
BATCH = 16
LR = 0.05


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


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _flax_params(seed=0, dtype=jnp.float32):
    model = JaxMnistCNN(dtype=dtype)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28)), train=False)
    return model, jax.device_get(variables['params'])


def _batch(seed, shape=(BATCH, 28, 28)):
    rng = np.random.default_rng(seed)
    images = ((rng.integers(0, 256, shape).astype(np.float32) / 255.0 - 0.1307)
              / 0.3081).astype(np.float32)
    return images, rng.integers(0, 10, shape[0]).astype(np.int64)


def _ported(params, dtype=torch.float32):
    model = MnistCNN(dtype=dtype)
    model.load_state_dict(flax_to_torch({'params': params}))
    return model


def test_parameters_carry_over_by_name_and_shape():
    _, params = _flax_params()
    assert params['Dense_0']['kernel'].shape == (7 * 7 * 64, 128)
    state = flax_to_torch({'params': params})
    model = MnistCNN()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    # flax's default init: LeCun normal kernels, zero biases
    w = model.Dense_0.weight.detach().numpy()
    assert abs(w.std() * np.sqrt(7 * 7 * 64) - 1.0) < 0.05
    assert not model.Conv_1.bias.detach().any()


@pytest.mark.parametrize('layout', ['bhw', 'nhwc', 'uint8'])
def test_forward_matches_flax_in_float32(layout):
    jax_model, params = _flax_params(1)
    images, _ = _batch(2)
    if layout == 'nhwc':
        images = images[..., None]
    elif layout == 'uint8':
        images = np.random.default_rng(3).integers(0, 256, (BATCH, 28, 28, 1), dtype=np.uint8)
    expected = np.asarray(jax_model.apply({'params': params}, jnp.asarray(images)))
    model = _ported(params)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, 10)
    # float32 sums in another order: 1e-5 of the logits' scale (raw 0-255
    # pixels give logits near 50)
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(got.numpy(), expected, rtol=F32_TOL, atol=F32_TOL * scale)


def test_forward_matches_flax_in_bfloat16():
    jax_model, params = _flax_params(4, jnp.bfloat16)
    images, _ = _batch(5)
    expected = np.asarray(jax_model.apply({'params': params}, jnp.asarray(images)))
    assert expected.dtype == np.float32  # the head computes in float32
    model = _ported(params, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(got.numpy(), expected, rtol=BF16_TOL, atol=BF16_TOL * scale)


def test_five_sgd_steps_match_jax():
    jax_model, params = _flax_params(6)
    jax_state = jax_create_train_state(jax_model, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)),
                                       learning_rate=LR)
    jax_state = jax_state.replace(params=params)
    jax_step = jax_make_train_step(donate=False)
    state = create_train_state(_ported(params), device='cpu', learning_rate=LR)
    step = make_train_step()
    for i in range(5):
        images, labels = _batch(10 + i)
        jax_state, jax_metrics = jax_step(jax_state, jnp.asarray(images), jnp.asarray(labels))
        state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(metrics['loss'].item(), float(jax_metrics['loss']),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        assert metrics['accuracy'].item() == pytest.approx(float(jax_metrics['accuracy']))
    assert state.step == int(jax_state.step) == 5
    expected = flax_to_torch({'params': jax.device_get(jax_state.params)})
    got = state.module.state_dict()
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)
    # the steps moved the parameters
    assert not np.allclose(got['Dense_1.bias'].numpy(), 0)

    eval_images, eval_labels = _batch(99, (BATCH + 3, 28, 28))
    jax_eval = jax_make_eval_step()(jax_state, jnp.asarray(eval_images), jnp.asarray(eval_labels))
    port_eval = make_eval_step()(state, torch.from_numpy(eval_images),
                                 torch.from_numpy(eval_labels))
    np.testing.assert_allclose(port_eval['loss'].item(), float(jax_eval['loss']), rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert port_eval['accuracy'].item() == pytest.approx(float(jax_eval['accuracy']))
