"""The port's train steps on the CPU: the eager step, with its flip mask now
drawn before the step from the ``(preprocess_seed, step)`` generator, still
matches the JAX step given the same flips; that mask is the one the step's
generator gave inside the step before; a preprocess that draws more
(``RandomCropFlip``: flip mask and crop offsets) gets its draws from the same
generator, and the step matches the JAX step that crops at those offsets
with ``lax.dynamic_slice``; and the graphed step refuses the CPU. The
graphed step itself runs on the card (``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
from jax import lax
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
                                              step_draws, step_flip_mask)
from petastorm_tpu_torch.ops import RandomCropFlip, normalize_images, random_flip
from petastorm_tpu_torch.ops.augment import (crop_offsets, crop_with_offsets, flip_mask,
                                             flip_with_mask)

SIZE = 32
BATCH = 8
NUM_CLASSES = 5
SEED = 7
CROP = 24
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


def _twin_states():
    """Seeded flax variables and the JAX and port train states holding them
    (a tiny float32 ResNet)."""
    jax_model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                          num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(1),
                                              jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    jax_state = jax_create_train_state(jax_model, jax.random.PRNGKey(0),
                                       jnp.zeros((1, SIZE, SIZE, 3)))
    jax_state = jax_state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    return variables, jax_state, _port_state(variables)


def _port_state(variables):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    return create_train_state(model, device='cpu')


def test_eager_step_with_flips_matches_jax_step():
    # the same weights, batch and flips (the port's mask of step 0, handed to
    # the JAX preprocess) through one step of each package (one: from the
    # second on, the JAX float32 gradient drifts, see test_torch_resnet.py);
    # 1e-4 covers float32 sums in another order
    variables, jax_state, state = _twin_states()
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
    unflipped = _port_state(variables)
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


def _normalize32(images):
    return normalize_images(images, MEAN, STD, out_dtype=torch.float32)


def test_flip_only_draws_are_step_flip_masks():
    # a preprocess without draw() gets today's mask, bit for bit; a crop
    # preprocess draws the same mask first, then its offsets
    for step in range(6):
        mask = step_flip_mask(SEED, step, BATCH, 'cpu')
        (draw,) = step_draws(_normalize32, SEED, step, BATCH, SIZE, SIZE, 'cpu')
        assert draw.dtype == torch.bool and torch.equal(draw, mask)
        crop_mask, ys, xs = step_draws(RandomCropFlip(CROP, CROP), SEED, step, BATCH, SIZE, SIZE,
                                       'cpu')
        assert torch.equal(crop_mask, mask)
        generator = torch.Generator(device='cpu')
        generator.manual_seed(_step_seed(SEED, step))
        assert torch.equal(flip_mask(BATCH, generator), mask)
        expected_ys, expected_xs = crop_offsets(BATCH, SIZE, SIZE, CROP, CROP, generator)
        assert torch.equal(ys, expected_ys) and torch.equal(xs, expected_xs)
        assert int(ys.min()) >= 0 and int(ys.max()) <= SIZE - CROP


def test_eager_step_hands_each_step_its_crop_draws():
    torch.manual_seed(0)
    state = create_train_state(ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES,
                                      num_filters=4, dtype=torch.float32), device='cpu')
    seen = []

    class Recording(RandomCropFlip):
        def __call__(self, images, *draws):
            out = super().__call__(images, *draws)
            seen.append((tuple(d.clone() for d in draws), tuple(out.shape)))
            return out

    preprocess = Recording(CROP, CROP, then=_normalize32)
    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED)
    for i in range(3):
        images, labels = _batch(i)
        step(state, torch.from_numpy(images), torch.from_numpy(labels))
    for i, (draws, shape) in enumerate(seen):
        expected = step_draws(preprocess, SEED, i, BATCH, SIZE, SIZE, 'cpu')
        assert all(torch.equal(a, b) for a, b in zip(draws, expected))
        assert shape == (BATCH, CROP, CROP, 3)
    assert not torch.equal(seen[0][0][1], seen[1][0][1])


def test_eager_crop_step_matches_jax_step():
    # the port's crop offsets and flip mask of step 0 handed to a JAX
    # preprocess that crops with lax.dynamic_slice at those offsets, flips
    # and normalizes: one step of each package agrees within the flip
    # step's 1e-4
    variables, jax_state, state = _twin_states()
    preprocess = RandomCropFlip(CROP, CROP, then=_normalize32)
    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED)
    images, labels = _batch(0)
    mask, ys, xs = (d.numpy() for d in step_draws(preprocess, SEED, 0, BATCH, SIZE, SIZE, 'cpu'))
    assert mask.any() and not mask.all() and len(set(ys.tolist())) > 1

    def jax_preprocess(x, rng):
        crops = jax.vmap(lambda image, y, x0: lax.dynamic_slice(
            image, (y, x0, 0), (CROP, CROP, image.shape[-1])))(x, jnp.asarray(ys),
                                                                 jnp.asarray(xs))
        flipped = jnp.where(mask[:, None, None, None], crops[:, :, ::-1, :], crops)
        return jax_normalize_images(flipped, MEAN, STD, out_dtype=jnp.float32)

    _, jax_metrics = jax_make_train_step(donate=False, preprocess_fn=jax_preprocess)(
        jax_state, jnp.asarray(images), jnp.asarray(labels))
    _, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(metrics['loss'].item(), float(jax_metrics['loss']),
                               atol=1e-4, rtol=1e-4)
    assert metrics['accuracy'].item() == pytest.approx(float(jax_metrics['accuracy']))
    # the crop matters: the same flips on the uncropped batch give another loss
    uncropped = _port_state(variables)
    _, plain = make_train_step(preprocess_fn=lambda x, m: _normalize32(flip_with_mask(x, m)),
                               preprocess_seed=SEED)(uncropped, torch.from_numpy(images),
                                                     torch.from_numpy(labels))
    assert abs(plain['loss'].item() - metrics['loss'].item()) > 1e-6
    # and the apply is the ops' crop then flip
    cropped = flip_with_mask(crop_with_offsets(torch.from_numpy(images), torch.from_numpy(ys),
                                               torch.from_numpy(xs), CROP, CROP),
                             torch.from_numpy(mask))
    assert torch.equal(RandomCropFlip(CROP, CROP)(torch.from_numpy(images),
                                                  torch.from_numpy(mask), torch.from_numpy(ys),
                                                  torch.from_numpy(xs)), cropped)
