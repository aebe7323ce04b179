"""Materialize an ImageNet directory tree (or a synthetic stand-in) as a
dataset: twin of ``examples/imagenet/generate_petastorm_imagenet.py``.

With ``--imagenet-path`` it walks ``<root>/<noun_id>/*.jpg`` and writes one
row per image; with ``--synthetic`` (or no path) it writes photo-like
synthetic images for a number of synthetic synsets, from the same numpy
seed as the JAX generator, so both write the same rows.

    python -m petastorm_tpu_torch.examples.imagenet.generate_petastorm_imagenet \\
        --synthetic --output-url file:///tmp/imagenet_dataset
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from petastorm_tpu_torch.etl import write_petastorm_dataset
from petastorm_tpu_torch.examples.imagenet.schema import ImagenetSchema, make_imagenet_schema


def _iter_imagenet_dir(imagenet_root, noun_id_to_text=None):
    import cv2
    for noun_id in sorted(os.listdir(imagenet_root)):
        synset_dir = os.path.join(imagenet_root, noun_id)
        if not os.path.isdir(synset_dir):
            continue
        text = (noun_id_to_text or {}).get(noun_id, noun_id)
        for name in sorted(os.listdir(synset_dir)):
            if not name.lower().endswith(('.jpg', '.jpeg', '.png')):
                continue
            image = cv2.imread(os.path.join(synset_dir, name), cv2.IMREAD_COLOR)
            if image is None:
                continue
            yield {'noun_id': noun_id, 'text': text,
                   'image': cv2.cvtColor(image, cv2.COLOR_BGR2RGB)}


def synthetic_image(rng, h, w):
    """A photo-like image: smooth gradients and mild noise (pure noise would
    make PNG pick no row filters and decode faster than photographs)."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _iter_synthetic(num_synsets, images_per_synset, seed=0, min_dim=64, max_dim=160):
    rng = np.random.default_rng(seed)
    for s in range(num_synsets):
        noun_id = 'n{:08d}'.format(s)
        for _ in range(images_per_synset):
            h, w = int(rng.integers(min_dim, max_dim)), int(rng.integers(min_dim, max_dim))
            yield {'noun_id': noun_id, 'text': 'synthetic synset {}'.format(s),
                   'image': synthetic_image(rng, h, w)}


def imagenet_directory_to_petastorm_dataset(imagenet_path, output_url, row_group_size_mb=256,
                                            noun_id_to_text=None):
    write_petastorm_dataset(output_url, ImagenetSchema,
                            _iter_imagenet_dir(imagenet_path, noun_id_to_text),
                            row_group_size_mb=row_group_size_mb)


def generate_synthetic_imagenet(output_url, num_synsets=4, images_per_synset=8,
                                rows_per_row_group=16, seed=0, image_codec='png', min_dim=64,
                                max_dim=160):
    """``image_codec``: 'png' (the reference schema) or 'jpeg'; image sides
    are drawn in ``[min_dim, max_dim)``."""
    schema = ImagenetSchema if image_codec == 'png' else make_imagenet_schema(image_codec)
    write_petastorm_dataset(output_url, schema,
                            _iter_synthetic(num_synsets, images_per_synset, seed=seed,
                                            min_dim=min_dim, max_dim=max_dim),
                            rows_per_row_group=rows_per_row_group)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--imagenet-path', default=None,
                        help='root of an ImageNet directory tree (<root>/<noun_id>/*.jpg)')
    parser.add_argument('--output-url', default='file:///tmp/imagenet_dataset')
    parser.add_argument('--synthetic', action='store_true',
                        help='write synthetic images instead of reading --imagenet-path')
    parser.add_argument('--num-synsets', type=int, default=4)
    parser.add_argument('--images-per-synset', type=int, default=8)
    args = parser.parse_args()
    if args.synthetic or not args.imagenet_path:
        generate_synthetic_imagenet(args.output_url, args.num_synsets, args.images_per_synset)
    else:
        imagenet_directory_to_petastorm_dataset(args.imagenet_path, args.output_url)


if __name__ == '__main__':
    main()
