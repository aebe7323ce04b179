"""Port parity: the ResNet of petastorm_tpu_torch against the JAX package's flax
ResNet, with the same weights (moved by ``flax_to_torch``) and the same
numpy inputs, in float32 on the CPU. Tolerance 1e-4: the two frameworks
sum convolutions and reductions in different orders in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models.resnet import BasicBlock as JaxBasicBlock
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_eval_step as jax_make_eval_step
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu_torch.models import BasicBlock, BottleneckBlock, ResNet, resnet50
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import (create_train_state, cross_entropy_loss,
                                              make_eval_step, make_train_step)

ATOL = 1e-4
NUM_CLASSES = 5
BLOCKS = {'bottleneck': (JaxBottleneckBlock, BottleneckBlock),
          'basic': (JaxBasicBlock, BasicBlock)}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """These models are tiny: two intra-op threads lose nothing, and keep
    this file from crowding out the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _models(block):
    jax_block, torch_block = BLOCKS[block]
    return (JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=jax_block, num_classes=NUM_CLASSES,
                      num_filters=8, dtype=jnp.float32),
            ResNet([1, 1, 1, 1], torch_block, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32))


def _random_variables(jax_model, size, seed=0):
    """flax variables with every leaf replaced by seeded numpy values: the
    zero-initialised bn3/bn2 scales would otherwise hide the block bodies."""
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ('var', 'scale'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        scale = 0.1 if name in ('bias', 'mean') else np.sqrt(2.0 / max(1, np.prod(x.shape[:-1])))
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, {k: dict(v) for k, v in variables.items()})


def _inputs(size, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, batch)
    return x, labels


def _assert_state_matches(torch_model, jax_variables):
    expected = flax_to_torch(jax_variables)
    actual = torch_model.state_dict()
    assert set(expected) == set(actual)
    for key, value in expected.items():
        np.testing.assert_allclose(actual[key].detach().cpu().numpy(), value.numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=key)


@pytest.mark.parametrize('block', sorted(BLOCKS))
@pytest.mark.parametrize('size', [32, 36])  # even and odd inputs to the stride-2 convs
@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_flax(block, size, train):
    jax_model, model = _models(block)
    variables = _random_variables(jax_model, size)
    model.load_state_dict(flax_to_torch(variables))
    x, _ = _inputs(size)
    if train:
        expected, _ = jax_model.apply(variables, jnp.asarray(x), train=True,
                                      mutable=['batch_stats'])
        model.train()
    else:
        expected = jax_model.apply(variables, jnp.asarray(x), train=False)
        model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, NUM_CLASSES)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize('block', sorted(BLOCKS))
def test_batchnorm_running_stats_match_flax(block):
    # flax updates the running variance with the BIASED batch variance
    jax_model, model = _models(block)
    variables = _random_variables(jax_model, 32)
    model.load_state_dict(flax_to_torch(variables))
    x, _ = _inputs(32)
    _, updates = jax_model.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    _assert_state_matches(model, {'params': variables['params'],
                                  'batch_stats': jax.device_get(updates['batch_stats'])})
    # the unbiased update nn.BatchNorm2d makes is measurably different
    bn = model.bn_init
    assert not torch.allclose(bn.var, torch.from_numpy(np.asarray(
        variables['batch_stats']['bn_init']['var'])))


@pytest.mark.parametrize('block', sorted(BLOCKS))
def test_sgd_step_matches_flax(block):
    # 64x64 inputs and a batch of 8 leave 32 values per channel to the
    # last stage's batch norms: well-conditioned gradients
    jax_model, model = _models(block)
    variables = _random_variables(jax_model, 64)
    x, labels = _inputs(64, batch=8)
    jax_state = jax_create_train_state(jax_model, jax.random.PRNGKey(0), jnp.asarray(x))
    jax_state = jax_state.replace(params=variables['params'],
                                  batch_stats=variables['batch_stats'])
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    # one step: from the second on, flax's float32 gradient of this random
    # network drifts from its own float64 gradient by more than ATOL (the
    # port's float32 gradient stays within 1e-6 of that float64 one), so
    # the momentum buffer is checked against optax on given gradients below
    jax_state, jax_metrics = jax_make_train_step(donate=False)(
        jax_state, jnp.asarray(x), jnp.asarray(labels))
    state, metrics = make_train_step()(state, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(metrics['loss'].item(), float(jax_metrics['loss']),
                               atol=ATOL, rtol=ATOL)
    assert metrics['accuracy'].item() == pytest.approx(float(jax_metrics['accuracy']))
    assert state.step == int(jax_state.step) == 1
    _assert_state_matches(model, jax.device_get({'params': jax_state.params,
                                                 'batch_stats': jax_state.batch_stats}))


def test_sgd_momentum_matches_optax():
    # the default optimizer against optax.sgd(0.1, momentum=0.9) over three
    # steps of the same seeded gradients: the momentum buffer's recurrence
    import optax
    rng = np.random.default_rng(3)
    param = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    tx = optax.sgd(0.1, momentum=0.9)
    jax_param = jnp.asarray(param)
    opt_state = tx.init(jax_param)
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(param))
    state = create_train_state(model, device='cpu')
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jax_param)
        jax_param = optax.apply_updates(jax_param, updates)
        model.weight.grad = torch.from_numpy(g.copy())
        state.optimizer.step()
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(jax_param),
                                   rtol=1e-6, atol=1e-6)


def test_eval_step_matches_flax():
    jax_model, model = _models('bottleneck')
    variables = _random_variables(jax_model, 32)
    x, labels = _inputs(32)
    jax_state = jax_create_train_state(jax_model, jax.random.PRNGKey(0), jnp.asarray(x))
    jax_state = jax_state.replace(params=variables['params'],
                                  batch_stats=variables['batch_stats'])
    expected = jax_make_eval_step()(jax_state, jnp.asarray(x), jnp.asarray(labels))
    model.load_state_dict(flax_to_torch(variables))
    metrics = make_eval_step()(create_train_state(model, device='cpu'),
                               torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(metrics['loss'].item(), float(expected['loss']), atol=ATOL)
    assert metrics['accuracy'].item() == pytest.approx(float(expected['accuracy']))


def test_cross_entropy_matches_optax():
    import optax
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    expected = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    out = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(out.item(), float(expected), rtol=1e-6)


def test_resnet50_layout_and_zero_init():
    model = resnet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: JaxResNet(stage_sizes=[3, 4, 6, 3],
                                              block_cls=JaxBottleneckBlock).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    # same tree: every flax leaf has a torch tensor of the transposed shape
    expected = flax_to_torch(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                    {k: dict(v) for k, v in shapes.items()}))
    actual = model.state_dict()
    assert set(expected) == set(actual)
    assert all(actual[k].shape == v.shape for k, v in expected.items())
    assert sum(p.numel() for p in model.parameters()) == 25557032
    assert torch.count_nonzero(model.stage1_block0.bn3.scale) == 0
    assert model.conv_init.weight.dtype == torch.float32
