"""ResNet-50 on an ImageNet-Parquet dataset over a ``('data',)`` mesh: twin
of ``examples/imagenet/jax_resnet_example.py``.

Each rank's reader reads the row-group shard of its data coordinate;
worker threads decode and resize (``image_resize``); the loader collates
uint8 batches and stages this rank's rows on its card; the train step
flips and normalizes on the card (the Triton normalize kernel) inside the
step, which ``graphed=True`` replays as one CUDA graph. A world of one when
no process group exists; under ``torchrun`` one rank per card.

    python -m petastorm_tpu_torch.examples.imagenet.torch_resnet_example \\
        --dataset-url file:///tmp/imagenet_dataset
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch import TransformSpec, make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import resnet50
from petastorm_tpu_torch.models.train import (create_train_state, make_train_step,
                                              shard_train_state)
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.ops.augment import flip_with_mask
from petastorm_tpu_torch.parallel import (data_sharding, make_mesh, process_local_batch_size,
                                          reader_shard_for_process)
from petastorm_tpu_torch.torch import TorchDataLoader
from petastorm_tpu_torch.unischema import UnischemaField

# per-channel ImageNet statistics in 0-255 units (normalization runs on the card)
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


class _LabelFromNounId(object):
    """The batched transform: a module-level class (a process pool pickles
    the spec into its workers). Images arrive resized by the decode worker
    (``image_resize``); the label is the crc32 of the synset id (the same in
    every process, unlike ``hash()``) modulo the class count."""

    def __init__(self, num_classes):
        self.num_classes = num_classes

    def __call__(self, block):
        labels = np.fromiter(
            (zlib.crc32(str(n).encode()) % self.num_classes for n in block['noun_id']),
            dtype=np.int64, count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


def make_transform(image_size, num_classes):
    """Host side: uint8 out (4x fewer bytes to the card than float), decode
    and area resize fused in the native decoder, a batched label transform:
    no Python per row on the image path."""
    return TransformSpec(
        _LabelFromNounId(num_classes),
        edit_fields=[
            UnischemaField('image', np.uint8, (image_size, image_size, 3), None, False),
            UnischemaField('label', np.int64, (), None, False)],
        removed_fields=['noun_id', 'text'],
        batched=True,
        image_resize={'image': (image_size, image_size)})


def device_preprocess(images, flip_mask):
    """On the card, inside the step: the step's flip, then uint8 -> bf16
    normalize (the Triton kernel)."""
    return normalize_images(flip_with_mask(images, flip_mask), IMAGENET_MEAN, IMAGENET_STD,
                            out_dtype=torch.bfloat16)


def train(dataset_url, batch_size=64, steps=100, image_size=160, num_classes=1000,
          cache_location=None, seed=0, device=None, graphed=True):
    """``steps`` steps of ResNet-50 bf16 (SGD 0.1, momentum 0.9) over the
    mesh; ``batch_size`` is the global batch. Returns the state and every
    step's loss."""
    device = resolve_device(device)
    owns_group = not dist.is_initialized()
    mesh = make_mesh(('data',), device=device)
    try:
        torch.manual_seed(seed)
        state = create_train_state(resnet50(num_classes=num_classes, dtype=torch.bfloat16),
                                   device=device)
        state = shard_train_state(state, mesh)
        train_step = make_train_step(preprocess_fn=device_preprocess, preprocess_seed=seed,
                                     graphed=graphed)
        cache_kwargs = {}
        if cache_location:
            cache_kwargs = {'cache_type': 'local-disk', 'cache_location': cache_location,
                            'cache_size_limit': 10 << 30, 'cache_row_size_estimate': 200 << 10}
        cur_shard, shard_count = reader_shard_for_process(mesh)
        losses = []
        with make_reader(dataset_url, num_epochs=None, seed=seed, shuffle_row_groups=True,
                         transform_spec=make_transform(image_size, num_classes),
                         cur_shard=cur_shard, shard_count=shard_count, **cache_kwargs) as reader:
            loader = TorchDataLoader(reader, process_local_batch_size(batch_size, mesh),
                                     shuffling_queue_capacity=1024, seed=seed,
                                     to_device=data_sharding(mesh))
            for step, batch in enumerate(loader):
                state, metrics = train_step(state, batch['image'], batch['label'])
                losses.append(metrics['loss'])
                if step % 10 == 0:
                    print('step {}: loss={:.4f}'.format(step, float(metrics['loss'])))
                if step + 1 >= steps:
                    break
        return state, torch.stack(losses).tolist() if losses else []
    finally:
        if owns_group:
            dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/imagenet_dataset')
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--image-size', type=int, default=160)
    parser.add_argument('--num-classes', type=int, default=1000)
    parser.add_argument('--cache-location', default=None)
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    parser.add_argument('--eager', action='store_true', help='the eager step, not the graphed one')
    args = parser.parse_args()
    train(args.dataset_url, args.batch_size, args.steps, args.image_size, args.num_classes,
          args.cache_location, device=args.device, graphed=not args.eager)


if __name__ == '__main__':
    main()
