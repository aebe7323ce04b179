"""The benchmark's image corpus: photo-like images made from a fixed data
seed, and their labels.

Copied from ``chip_smoke.py`` (``_photo``) so that a later change to that
script cannot move the yardstick. Both the stores' build code and
the reference read this module: the store holds what it makes, and the
reference makes the same pixels again from the seed.
"""

from __future__ import annotations

import zlib

import numpy as np

#: the corpus does not depend on a run's ``--seed``: like ImageNet, it is
#: fixed, and a run's seed picks the order, the weights and the flips
DATA_SEED = 20240607


def photo(rng, h, w):
    """A photo-like image: smooth gradients and mild noise, made from
    ``rng``."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def source_image(index, sides):
    """Image ``index`` of the corpus: height and width drawn uniformly from
    the closed range ``sides`` (a pair, equal for a fixed size), then the
    photo, all from ``(DATA_SEED, index)``."""
    rng = np.random.default_rng([DATA_SEED, index])
    lo, hi = int(sides[0]), int(sides[1])
    h, w = int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1))
    return photo(rng, h, w)


def noun_id(index, num_classes):
    """The synset id of row ``index``: ImageNet's classes, in turn."""
    return 'n{:08d}'.format(index % num_classes)


def label_of(noun, num_classes):
    """The example's label: crc32 of the synset id, modulo the classes."""
    return zlib.crc32(str(noun).encode()) % num_classes
