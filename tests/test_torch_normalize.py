"""Port parity: normalize_images and random_flip of petastorm_tpu_torch against
the JAX package's ops (the Pallas kernel in interpret mode), on inputs made
with numpy from a seed. On these CPU tensors the port runs the kernel's plain
version; the Triton kernel itself is held to that plain version on the card
in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.ops import random_flip as jax_random_flip
from petastorm_tpu_torch.ops import normalize_images, random_flip
from petastorm_tpu_torch.ops.augment import flip_with_mask

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)

SHAPES = [
    (4, 32, 32, 3),     # W*C = 96: one masked TPU lane block
    (2, 17, 224, 3),    # odd rows, W*C not a multiple of 512
    (1, 8, 128, 1),     # single channel
]


def _jax(images, mean, std, out_dtype):
    return np.asarray(jax_normalize_images(jnp.asarray(images), mean, std, out_dtype=out_dtype,
                                           interpret=True).astype(jnp.float32))


@pytest.mark.parametrize('shape', SHAPES)
def test_normalize_f32_matches_jax_kernel(shape, rng):
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    c = shape[-1]
    out = normalize_images(torch.from_numpy(images), MEAN[:c], STD[:c], out_dtype=torch.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), _jax(images, MEAN[:c], STD[:c], jnp.float32),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_normalize_bf16_matches_jax_kernel(shape, rng):
    # both round the same float32 value to bf16; 2e-2 is the JAX suite's
    # bf16 tolerance (the rounding of values up to ~2.2 in magnitude)
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    c = shape[-1]
    out = normalize_images(torch.from_numpy(images), MEAN[:c], STD[:c])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _jax(images, MEAN[:c], STD[:c], jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


def test_normalize_float_input_not_truncated(rng):
    images = rng.random((2, 8, 128, 3)).astype(np.float32)  # values in [0, 1)
    out = normalize_images(torch.from_numpy(images), 0.5, 0.5, out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), _jax(images, 0.5, 0.5, jnp.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), (images - 0.5) / 0.5, rtol=1e-5, atol=1e-5)


def test_normalize_scalar_stats_default_bf16(rng):
    images = rng.integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    out = normalize_images(torch.from_numpy(images), 127.5, 127.5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _jax(images, 127.5, 127.5, jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


def test_normalize_single_image_and_validation(rng):
    img = torch.from_numpy(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8))
    out = normalize_images(img, MEAN, STD, out_dtype=torch.float32)
    assert tuple(out.shape) == (8, 16, 3)
    np.testing.assert_allclose(out.numpy(), _jax(img.numpy(), MEAN, STD, jnp.float32),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='std must be non-zero'):
        normalize_images(img, MEAN, 0.0)
    with pytest.raises(ValueError, match='mean must be'):
        normalize_images(img, np.ones(4), STD)
    with pytest.raises(ValueError, match=r'\(B, H, W, C\)'):
        normalize_images(img[0], MEAN, STD)


def test_flip_with_mask_matches_jax_random_flip(rng):
    images = rng.integers(0, 256, (8, 4, 6, 3), dtype=np.uint8)
    key = jax.random.key(0)
    expected = np.asarray(jax_random_flip(jnp.asarray(images), key))
    # the mask random_flip draws: bernoulli(key, 0.5, (B,))
    mask = np.array(jax.random.bernoulli(key, 0.5, (images.shape[0],)))
    assert 0 < mask.sum() < len(mask)
    out = flip_with_mask(torch.from_numpy(images), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), expected)


def test_random_flip_statistics_and_determinism():
    n = 4000
    images = torch.zeros((n, 1, 2, 1), dtype=torch.uint8)
    images[:, :, 1] = 1  # a flipped image reads [1, 0]

    def flipped(prob, seed):
        g = torch.Generator().manual_seed(seed)
        return random_flip(images, g, prob=prob)[:, 0, 0, 0] == 1

    rate = flipped(0.5, 0).float().mean().item()
    assert abs(rate - 0.5) < 0.035  # > 4 standard deviations at n=4000
    assert abs(flipped(0.2, 1).float().mean().item() - 0.2) < 0.03
    assert not flipped(0.0, 2).any() and flipped(1.0, 3).all()
    assert torch.equal(flipped(0.5, 4), flipped(0.5, 4))
    with pytest.raises(ValueError, match=r'\(B, H, W, C\)'):
        random_flip(images[0], torch.Generator())
