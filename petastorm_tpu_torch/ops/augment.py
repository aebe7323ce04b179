"""On-device batch augmentation: twin of ``petastorm_tpu/ops/augment.py``
(random flip and crop, mixup, cutmix).

Randomness comes from an explicit ``torch.Generator`` on the images' device.
It cannot reproduce ``jax.random``'s bits, so every op is split in two: a
draw (:func:`flip_mask`, :func:`crop_offsets`, :func:`mixup_draw`,
:func:`cutmix_draw`) and an apply (:func:`flip_with_mask`,
:func:`crop_with_offsets`, :func:`mixup_with`, :func:`cutmix_with`). The
tests feed the applies the values the JAX ops drew and check the draws for
their statistics only; a train step captured in a CUDA graph can draw
outside the graph and feed the captured apply. The applies keep the JAX
ops' arithmetic: flip and crop per image; mixup and cutmix with ONE lambda
(and for cutmix one box) per batch, blended in float32.
"""

from __future__ import annotations

import torch


def _check_images(images):
    if images.dim() != 4:
        raise ValueError('images must be (B, H, W, C), got shape {}'.format(tuple(images.shape)))


def flip_with_mask(images, mask):
    """Mirror along the width axis the images of ``(B, H, W, C)`` ``images``
    where the boolean ``(B,)`` ``mask`` is set."""
    return torch.where(mask.to(images.device)[:, None, None, None], images.flip(2), images)


def flip_mask(batch, generator, prob=0.5):
    """The ``(batch,)`` boolean mask of :func:`random_flip`: one uniform draw
    per image from ``generator`` (on its device), set below ``prob``."""
    return torch.rand(batch, generator=generator, device=generator.device) < prob


def random_flip(images, generator, prob=0.5):
    """Per-image horizontal flip (width axis) with probability ``prob``.

    :param images: ``(B, H, W, C)`` batch
    :param generator: ``torch.Generator`` on the images' device
    """
    _check_images(images)
    return flip_with_mask(images, flip_mask(images.shape[0], generator, prob))


def _check_crop(images, crop_h, crop_w):
    _check_images(images)
    _, h, w, _ = images.shape
    if crop_h > h or crop_w > w:
        raise ValueError('crop ({}, {}) larger than image ({}, {})'.format(crop_h, crop_w, h, w))


def crop_offsets(batch, h, w, crop_h, crop_w, generator):
    """The ``(ys, xs)`` of :func:`random_crop`: each ``(batch,)`` int64,
    uniform in ``[0, h - crop_h]`` and ``[0, w - crop_w]``."""
    device = generator.device
    ys = torch.randint(0, h - crop_h + 1, (batch,), generator=generator, device=device)
    xs = torch.randint(0, w - crop_w + 1, (batch,), generator=generator, device=device)
    return ys, xs


def crop_with_offsets(images, ys, xs, crop_h, crop_w):
    """Image ``i`` of ``images`` cropped to ``[ys[i], ys[i] + crop_h)`` x
    ``[xs[i], xs[i] + crop_w)``: one gather, static shapes."""
    _check_crop(images, crop_h, crop_w)
    device = images.device
    rows = ys.to(device)[:, None] + torch.arange(crop_h, device=device)
    cols = xs.to(device)[:, None] + torch.arange(crop_w, device=device)
    batch = torch.arange(images.shape[0], device=device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop(images, generator, crop_h, crop_w):
    """Per-image random crop to ``(crop_h, crop_w)``, offsets drawn
    uniformly per image."""
    _check_crop(images, crop_h, crop_w)
    b, h, w, _ = images.shape
    ys, xs = crop_offsets(b, h, w, crop_h, crop_w, generator)
    return crop_with_offsets(images, ys, xs, crop_h, crop_w)


def _beta(alpha, generator):
    """One ``Beta(alpha, alpha)`` draw as a float32 0-d tensor on the
    generator's device: ``x / (x + y)`` of two ``Gamma(alpha)`` draws (in
    float64, so a small ``alpha``'s tiny draws do not underflow)."""
    gammas = torch._standard_gamma(
        torch.full((2,), float(alpha), dtype=torch.float64, device=generator.device),
        generator=generator)
    return (gammas[0] / gammas.sum()).to(torch.float32)


def mixup_draw(batch, generator, alpha=0.2):
    """The draws of :func:`mixup`: a permutation of ``batch`` and
    ``lam ~ Beta(alpha, alpha)`` (float32 0-d; :func:`mixup_with` keeps the
    larger of ``lam`` and ``1 - lam``)."""
    perm = torch.randperm(batch, generator=generator, device=generator.device)
    return perm, _beta(alpha, generator)


def _soft_labels(labels, num_classes):
    """``(B,)`` integer labels -> float32 one-hot ``(B, num_classes)`` (an
    out-of-range or negative label gives an all-zero row, as
    ``jax.nn.one_hot``); ``(B, num_classes)`` labels -> float32."""
    if labels.dim() == 1:
        if num_classes is None:
            raise ValueError('integer labels need num_classes for the soft-label blend')
        classes = torch.arange(num_classes, device=labels.device)
        return (labels[:, None] == classes).to(torch.float32)
    if labels.dim() == 2:
        return labels.to(torch.float32)
    raise ValueError('labels must be (B,) ints or (B, num_classes), got shape {}'.format(
        tuple(labels.shape)))


def _as_scalar(value, device):
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def mixup_with(images, labels, perm, lam, num_classes=None):
    """Batch mixup from its draws: ``lam = max(lam, 1 - lam)`` keeps the
    original image dominant; images blend ``lam * x + (1 - lam) * x[perm]``
    in float32 and return in their dtype (integer images rounded half to
    even); labels blend the same way as soft labels. Returns
    ``(mixed_images, mixed_labels)``."""
    _check_images(images)
    device = images.device
    perm = perm.to(device)
    lam = _as_scalar(lam, device)
    lam = torch.maximum(lam, 1.0 - lam)
    soft = _soft_labels(labels.to(device), num_classes)
    x = images.to(torch.float32)
    mixed = lam * x + (1.0 - lam) * x[perm]
    if not images.dtype.is_floating_point:
        mixed = torch.round(mixed)
    return mixed.to(images.dtype), lam * soft + (1.0 - lam) * soft[perm]


def mixup(images, labels, generator, alpha=0.2, num_classes=None):
    """Batch mixup (Zhang et al. 2018): each image blends with a permuted
    partner, ``lam ~ Beta(alpha, alpha)`` shared across the batch.

    ``labels``: integer ``(B,)`` (requires ``num_classes``; returns soft
    ``(B, num_classes)``) or already-soft ``(B, num_classes)``.
    """
    _check_images(images)
    perm, lam = mixup_draw(images.shape[0], generator, alpha)
    return mixup_with(images, labels, perm, lam, num_classes)


def cutmix_draw(batch, h, w, generator, alpha=1.0):
    """The draws of :func:`cutmix`: a permutation of ``batch``,
    ``lam ~ Beta(alpha, alpha)`` (float32 0-d) and the box centre ``cy`` in
    ``[0, h)``, ``cx`` in ``[0, w)`` (int64 0-d)."""
    device = generator.device
    perm = torch.randperm(batch, generator=generator, device=device)
    lam = _beta(alpha, generator)
    cy = torch.randint(0, h, (), generator=generator, device=device)
    cx = torch.randint(0, w, (), generator=generator, device=device)
    return perm, lam, cy, cx


def cutmix_with(images, labels, perm, lam, cy, cx, num_classes=None):
    """Batch CutMix from its draws: the box of sides
    ``int32(sqrt(1 - lam) * h)`` by ``... * w`` around ``(cy, cx)``, each
    edge clipped to the image, takes the permuted partner's pixels (a
    coordinate mask, static shapes); labels blend by the REALIZED box's
    share of the image, not by ``lam``."""
    _check_images(images)
    _, h, w, _ = images.shape
    device = images.device
    perm = perm.to(device)
    lam = _as_scalar(lam, device)
    cy = torch.as_tensor(cy, device=device).to(torch.int32)
    cx = torch.as_tensor(cx, device=device).to(torch.int32)
    cut_ratio = torch.sqrt(1.0 - lam)
    cut_h = (cut_ratio * h).to(torch.int32)
    cut_w = (cut_ratio * w).to(torch.int32)
    y0 = torch.clamp(cy - torch.div(cut_h, 2, rounding_mode='floor'), 0, h)
    y1 = torch.clamp(cy + torch.div(cut_h, 2, rounding_mode='floor'), 0, h)
    x0 = torch.clamp(cx - torch.div(cut_w, 2, rounding_mode='floor'), 0, w)
    x1 = torch.clamp(cx + torch.div(cut_w, 2, rounding_mode='floor'), 0, w)
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    mixed = torch.where(in_box[None, :, :, None], images[perm], images)
    box_frac = ((y1 - y0) * (x1 - x0)).to(torch.float32) / float(h * w)
    lam_adj = 1.0 - box_frac
    soft = _soft_labels(labels.to(device), num_classes)
    return mixed, lam_adj * soft + (1.0 - lam_adj) * soft[perm]


def cutmix(images, labels, generator, alpha=1.0, num_classes=None):
    """Batch CutMix (Yun et al. 2019): ONE random box per step, shared
    across the batch, is replaced in each image by its permuted partner's
    pixels; labels blend by the realized pasted-area fraction."""
    _check_images(images)
    b, h, w, _ = images.shape
    perm, lam, cy, cx = cutmix_draw(b, h, w, generator, alpha)
    return cutmix_with(images, labels, perm, lam, cy, cx, num_classes)
