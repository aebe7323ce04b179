"""The port's train steps on the CPU: the eager step, with its flip mask now
drawn before the step from the ``(preprocess_seed, step)`` generator, still
matches the JAX step given the same flips; that mask is the one the step's
generator gave inside the step before; and the graphed step refuses the CPU.
The graphed step itself runs on the card (``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import (_step_seed, create_train_state, make_train_step,
                                              step_flip_mask)
from petastorm_tpu_torch.ops import normalize_images, random_flip
from petastorm_tpu_torch.ops.augment import flip_with_mask

SIZE = 32
BATCH = 8
NUM_CLASSES = 5
SEED = 7
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, NUM_CLASSES, BATCH).astype(np.int32))


def test_step_mask_is_the_draw_the_step_made_in_step_before():
    images = torch.from_numpy(_batch(0)[0])
    for step in range(6):
        # what the step did inside itself before: a generator seeded from
        # (preprocess_seed, step), random_flip's draw from it
        generator = torch.Generator(device='cpu')
        generator.manual_seed(_step_seed(SEED, step))
        before = torch.rand(BATCH, generator=generator, device='cpu') < 0.5
        mask = step_flip_mask(SEED, step, BATCH, 'cpu')
        assert mask.dtype == torch.bool and torch.equal(mask, before)
        generator.manual_seed(_step_seed(SEED, step))
        assert torch.equal(random_flip(images, generator), flip_with_mask(images, mask))


def test_eager_step_hands_each_step_its_mask():
    torch.manual_seed(0)
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=4,
                   dtype=torch.float32)
    state = create_train_state(model, device='cpu')
    seen = []

    def preprocess(images, mask):
        seen.append(mask.clone())
        return normalize_images(flip_with_mask(images, mask), MEAN, STD, out_dtype=torch.float32)

    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED)
    for i in range(3):
        images, labels = _batch(i)
        step(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert state.step == 3
    for i, mask in enumerate(seen):
        assert torch.equal(mask, step_flip_mask(SEED, i, BATCH, 'cpu'))
    assert not all(torch.equal(seen[0], m) for m in seen[1:])


def test_eager_step_with_flips_matches_jax_step():
    # the same weights, batch and flips (the port's mask of step 0, handed to
    # the JAX preprocess) through one step of each package (one: from the
    # second on, the JAX float32 gradient drifts, see test_torch_resnet.py);
    # 1e-4 covers float32 sums in another order
    jax_model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                          num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(1),
                                              jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    jax_state = jax_create_train_state(jax_model, jax.random.PRNGKey(0),
                                       jnp.zeros((1, SIZE, SIZE, 3)))
    jax_state = jax_state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, mask: normalize_images(
        flip_with_mask(x, mask), MEAN, STD, out_dtype=torch.float32), preprocess_seed=SEED)
    images, labels = _batch(0)
    mask = step_flip_mask(SEED, 0, BATCH, 'cpu').numpy()
    assert mask.any() and not mask.all()

    def jax_preprocess(x, rng):
        flipped = jnp.where(mask[:, None, None, None], x[:, :, ::-1, :], x)
        return jax_normalize_images(flipped, MEAN, STD, out_dtype=jnp.float32)

    _, jax_metrics = jax_make_train_step(donate=False, preprocess_fn=jax_preprocess)(
        jax_state, jnp.asarray(images), jnp.asarray(labels))
    _, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(metrics['loss'].item(), float(jax_metrics['loss']),
                               atol=1e-4, rtol=1e-4)
    assert metrics['accuracy'].item() == pytest.approx(float(jax_metrics['accuracy']))
    # the flips matter: the unflipped batch gives another loss
    unflipped = create_train_state(ResNet([1, 1, 1, 1], BottleneckBlock,
                                          num_classes=NUM_CLASSES, num_filters=8,
                                          dtype=torch.float32), device='cpu')
    unflipped.model.load_state_dict(flax_to_torch(variables))
    _, plain = make_train_step(preprocess_fn=lambda x, mask: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))(unflipped, torch.from_numpy(images),
                                                 torch.from_numpy(labels))
    assert abs(plain['loss'].item() - metrics['loss'].item()) > 1e-6


def test_graphed_step_refuses_the_cpu(monkeypatch):
    with pytest.raises(RuntimeError, match='CUDA'):
        make_train_step(graphed=True)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    step = make_train_step(graphed=True)
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=4,
                   dtype=torch.float32)
    state = create_train_state(model, device='cpu')
    images, labels = _batch(0)
    with pytest.raises(RuntimeError, match='CUDA only'):
        step(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert state.step == 0
