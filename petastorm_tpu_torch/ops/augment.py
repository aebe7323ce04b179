"""On-device batch augmentation (twin of ``random_flip`` in
``petastorm_tpu/ops/augment.py``). Random crop, mixup and cutmix are not
ported yet.

Randomness comes from an explicit ``torch.Generator`` on the images' device.
It cannot reproduce ``jax.random``'s bits, so the tests feed
:func:`flip_with_mask` the mask the JAX op drew and check the sampling rate
for its statistics only. The mask is drawn apart from the flip
(:func:`flip_mask`), so that a train step captured in a CUDA graph can draw
it outside the graph and feed it to the captured flip.
"""

from __future__ import annotations

import torch


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
    if images.dim() != 4:
        raise ValueError('images must be (B, H, W, C), got shape {}'.format(tuple(images.shape)))
    return flip_with_mask(images, flip_mask(images.shape[0], generator, prob))
