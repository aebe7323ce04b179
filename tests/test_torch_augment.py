"""Port parity: ``random_crop``, ``mixup``, ``cutmix`` and ``_soft_labels``
of petastorm_tpu_torch against ``petastorm_tpu/ops/augment.py``.

``jax.random``'s bits cannot be drawn from a ``torch.Generator``, so each
case recomputes the JAX op's draws from its key with the calls the op makes
(``jax.random.split``, ``randint``, ``permutation``, ``beta``) and feeds
them to the port's apply: images must be equal exactly, soft labels within
1e-6. The port's own draws are checked for their range and their
statistics, and each op against its draw + apply."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import augment as jax_augment
from petastorm_tpu_torch.ops import augment
from petastorm_tpu_torch.ops import cutmix, mixup, random_crop

LABEL_TOL = 1e-6
SEEDS = range(12)


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


def _images(seed, shape=(6, 10, 12, 3), dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


def _labels(seed, batch, num_classes, soft=False):
    rng = np.random.default_rng(1000 + seed)
    if soft:
        return rng.dirichlet(np.ones(num_classes), batch).astype(np.float32)
    return rng.integers(0, num_classes, batch).astype(np.int32)


def _np(x):
    return np.array(jax.device_get(x))


def _crop_draws(key, b, h, w, crop_h, crop_w):
    ky, kx = jax.random.split(key)
    return (_np(jax.random.randint(ky, (b,), 0, h - crop_h + 1)),
            _np(jax.random.randint(kx, (b,), 0, w - crop_w + 1)))


def _mixup_draws(key, b, alpha):
    kperm, klam = jax.random.split(key)
    return _np(jax.random.permutation(kperm, b)), _np(jax.random.beta(klam, alpha, alpha))


def _cutmix_draws(key, b, h, w, alpha):
    kperm, klam, ky, kx = jax.random.split(key, 4)
    return (_np(jax.random.permutation(kperm, b)), _np(jax.random.beta(klam, alpha, alpha)),
            _np(jax.random.randint(ky, (), 0, h)), _np(jax.random.randint(kx, (), 0, w)))


@pytest.mark.parametrize('crop', [(6, 7), (10, 12), (1, 1), (10, 3)])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_random_crop_matches_jax(crop, dtype):
    for seed in SEEDS:
        images = _images(seed, dtype=dtype)
        b, h, w, _ = images.shape
        key = jax.random.PRNGKey(seed)
        expected = _np(jax_augment.random_crop(jnp.asarray(images), key, *crop))
        ys, xs = _crop_draws(key, b, h, w, *crop)
        got = augment.crop_with_offsets(torch.from_numpy(images), torch.from_numpy(ys),
                                        torch.from_numpy(xs), *crop)
        assert got.dtype == torch.from_numpy(images).dtype
        np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('soft', [False, True])
@pytest.mark.parametrize('alpha', [0.2, 1.0])
def test_mixup_matches_jax(dtype, soft, alpha):
    num_classes = 7
    for seed in SEEDS:
        images = _images(seed, dtype=dtype)
        labels = _labels(seed, images.shape[0], num_classes, soft)
        key = jax.random.PRNGKey(seed)
        exp_images, exp_labels = jax_augment.mixup(jnp.asarray(images), jnp.asarray(labels), key,
                                                   alpha=alpha, num_classes=num_classes)
        perm, lam = _mixup_draws(key, images.shape[0], alpha)
        got_images, got_labels = augment.mixup_with(
            torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(perm),
            torch.from_numpy(lam), num_classes=num_classes)
        assert got_images.dtype == torch.from_numpy(images).dtype
        np.testing.assert_array_equal(got_images.numpy(), _np(exp_images))
        assert got_labels.dtype == torch.float32
        np.testing.assert_allclose(got_labels.numpy(), _np(exp_labels), rtol=0, atol=LABEL_TOL)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('soft', [False, True])
@pytest.mark.parametrize('alpha', [1.0, 0.3])
def test_cutmix_matches_jax(dtype, soft, alpha):
    num_classes = 5
    clipped = 0
    for seed in range(40):
        images = _images(seed, shape=(5, 9, 13, 2), dtype=dtype)
        b, h, w, _ = images.shape
        labels = _labels(seed, b, num_classes, soft)
        key = jax.random.PRNGKey(seed)
        exp_images, exp_labels = jax_augment.cutmix(jnp.asarray(images), jnp.asarray(labels),
                                                    key, alpha=alpha, num_classes=num_classes)
        perm, lam, cy, cx = _cutmix_draws(key, b, h, w, alpha)
        got_images, got_labels = augment.cutmix_with(
            torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(perm),
            torch.from_numpy(lam), torch.from_numpy(cy), torch.from_numpy(cx),
            num_classes=num_classes)
        np.testing.assert_array_equal(got_images.numpy(), _np(exp_images))
        np.testing.assert_allclose(got_labels.numpy(), _np(exp_labels), rtol=0, atol=LABEL_TOL)
        cut_h = int(np.float32(np.sqrt(np.float32(1) - lam)) * np.float32(h))
        clipped += int(cy) - cut_h // 2 < 0 or int(cy) + cut_h // 2 > h
    # the realized (clipped) box, not lam, weighs the labels: some cases clip
    assert clipped


def test_cutmix_weighs_labels_by_the_realized_box():
    """A box centred on the corner is clipped to a quarter of its area: the
    partner's label weight is the pasted share of the image, not 1 - lam."""
    h = w = 8
    images = torch.zeros((2, h, w, 1), dtype=torch.uint8)
    images[1] = 1
    labels = torch.tensor([0, 1])
    perm = torch.tensor([1, 0])
    lam = torch.tensor(0.75)  # a 4x4 box: 1 - lam of the image if unclipped
    mixed, soft = augment.cutmix_with(images, labels, perm, lam, torch.tensor(0),
                                      torch.tensor(0), num_classes=2)
    assert int(mixed[0].sum()) == 4  # the 2x2 quarter of the box inside the image
    np.testing.assert_allclose(soft[0].numpy(), [1 - 4 / 64, 4 / 64], atol=LABEL_TOL)


@pytest.mark.parametrize('labels,num_classes', [
    (np.array([0, 3, 9, 4], np.int32), 10),
    (np.array([0, 10, -1, 12, 2], np.int32), 10),  # out of range: all-zero rows
    (np.array([1, 2], np.int64), 3),
    (np.random.default_rng(0).dirichlet(np.ones(4), 3).astype(np.float32), None),
    (np.random.default_rng(1).dirichlet(np.ones(4), 3).astype(np.float64), 4),
])
def test_soft_labels_match_jax(labels, num_classes):
    expected = _np(jax_augment._soft_labels(jnp.asarray(labels), num_classes))
    got = augment._soft_labels(torch.from_numpy(labels), num_classes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=LABEL_TOL)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize('case', ['crop_3d', 'crop_large', 'mixup_3d', 'cutmix_5d',
                                  'no_num_classes', 'labels_3d', 'flip_3d'])
def test_refusals_match_jax(case):
    imgs = np.zeros((2, 4, 4, 3), np.uint8)
    flat = np.zeros((4, 4, 3), np.uint8)
    five = np.zeros((1, 2, 4, 4, 3), np.uint8)
    labels = np.zeros(2, np.int32)
    key = jax.random.PRNGKey(0)
    g = torch.Generator()
    t = torch.from_numpy
    cases = {
        'crop_3d': (lambda: jax_augment.random_crop(jnp.asarray(flat), key, 2, 2),
                    lambda: random_crop(t(flat), g, 2, 2)),
        'crop_large': (lambda: jax_augment.random_crop(jnp.asarray(imgs), key, 5, 2),
                       lambda: random_crop(t(imgs), g, 5, 2)),
        'mixup_3d': (lambda: jax_augment.mixup(jnp.asarray(flat), jnp.asarray(labels), key,
                                               num_classes=2),
                     lambda: mixup(t(flat), t(labels), g, num_classes=2)),
        'cutmix_5d': (lambda: jax_augment.cutmix(jnp.asarray(five), jnp.asarray(labels), key,
                                                 num_classes=2),
                      lambda: cutmix(t(five), t(labels), g, num_classes=2)),
        'no_num_classes': (lambda: jax_augment.mixup(jnp.asarray(imgs), jnp.asarray(labels),
                                                     key),
                           lambda: mixup(t(imgs), t(labels), g)),
        'labels_3d': (lambda: jax_augment.cutmix(jnp.asarray(imgs),
                                                 jnp.zeros((2, 2, 2)), key),
                      lambda: cutmix(t(imgs), torch.zeros((2, 2, 2)), g)),
        'flip_3d': (lambda: jax_augment.random_flip(jnp.asarray(flat), key),
                    lambda: augment.random_flip(t(flat), g)),
    }
    jax_fn, torch_fn = cases[case]
    assert _message(torch_fn) == _message(jax_fn)


def test_crop_draws_cover_the_range_and_apply():
    g = torch.Generator().manual_seed(3)
    images = torch.from_numpy(_images(0, shape=(64, 10, 12, 3)))
    ys, xs = augment.crop_offsets(64, 10, 12, 6, 7, g)
    assert ys.dtype == torch.int64 and ys.shape == (64,)
    assert set(ys.tolist()) == set(range(5)) and set(xs.tolist()) == set(range(6))
    g.manual_seed(3)
    out = random_crop(images, g, 6, 7)
    np.testing.assert_array_equal(out.numpy(),
                                  augment.crop_with_offsets(images, ys, xs, 6, 7).numpy())
    for i in range(64):
        y, x = int(ys[i]), int(xs[i])
        np.testing.assert_array_equal(out[i].numpy(), images[i, y:y + 6, x:x + 7].numpy())


def test_mixup_and_cutmix_draws():
    g = torch.Generator().manual_seed(11)
    lams = []
    for _ in range(400):
        perm, lam = augment.mixup_draw(8, g, alpha=0.2)
        assert sorted(perm.tolist()) == list(range(8))
        assert lam.dtype == torch.float32 and lam.dim() == 0
        lams.append(float(lam))
    lams = np.array(lams)
    assert ((0 <= lams) & (lams <= 1)).all()
    # Beta(0.2, 0.2) piles its mass at both ends; its mean is 1/2
    assert abs(lams.mean() - 0.5) < 0.06
    assert ((lams < 0.1) | (lams > 0.9)).mean() > 0.5
    centres = []
    for _ in range(400):
        perm, lam, cy, cx = augment.cutmix_draw(8, 9, 13, g, alpha=1.0)
        centres.append((int(cy), int(cx)))
        assert 0 <= float(lam) <= 1
    ys, xs = zip(*centres)
    assert set(ys) == set(range(9)) and set(xs) == set(range(13))


def test_ops_equal_their_draw_and_apply():
    images = torch.from_numpy(_images(5, shape=(8, 12, 12, 3)))
    labels = torch.from_numpy(_labels(5, 8, 10))
    g = torch.Generator().manual_seed(21)
    mixed = mixup(images, labels, g, alpha=0.2, num_classes=10)
    g.manual_seed(21)
    perm, lam = augment.mixup_draw(8, g, alpha=0.2)
    expected = augment.mixup_with(images, labels, perm, lam, num_classes=10)
    for a, b in zip(mixed, expected):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    g.manual_seed(22)
    mixed = cutmix(images, labels, g, alpha=1.0, num_classes=10)
    g.manual_seed(22)
    expected = augment.cutmix_with(images, labels, *augment.cutmix_draw(8, 12, 12, g, 1.0),
                                   num_classes=10)
    for a, b in zip(mixed, expected):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
