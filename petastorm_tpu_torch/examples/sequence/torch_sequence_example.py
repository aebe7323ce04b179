"""Long-context training end to end: columnar NGram windows feeding a
context-parallel sequence transformer over a ``('data', 'seq')`` mesh: twin
of ``examples/sequence/jax_sequence_example.py``.

    make_reader(output='columnar', ngram=...)   windows assembled in the
        |                                       decode workers
    TorchDataLoader + stack_ngram_time_axis     [B, T, F] on the host
        |
    stage features and labels only              batch split over 'data',
        |                                       time over 'seq'
    SequenceTransformer (ring or Ulysses)       exact attention over the
        |                                       seq group
    make_train_step(graphed=True)               one CUDA graph replay a step

The example's own flow: the window is stacked on the host and only the
features and the labels go to the card (two copies a batch), unlike the
port's ``pipeline_duty_cycle``, which stages every field of every offset.

    python -m petastorm_tpu_torch.examples.sequence.torch_sequence_example \\
        --dataset-url file:///tmp/sequence_dataset
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.examples.sequence.schema import TelemetrySchema
from petastorm_tpu_torch.models import make_sequence_transformer
from petastorm_tpu_torch.models.train import (create_train_state, make_train_step,
                                              shard_train_state)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel import (data_sharding, make_mesh, process_local_batch_size,
                                          reader_shard_for_process)
from petastorm_tpu_torch.torch import TorchDataLoader, stack_ngram_time_axis, stage_batch


def _world_size():
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', '1'))


def stage_windows(batch, features_sharding, labels_sharding, num_classes):
    """A host window batch -> ``(x, labels)`` on the card: the time axis
    stacked on the host, then ``features`` staged onto the sequence sharding
    and the labels (each window's sensor at t=0, modulo the classes) onto
    the data sharding."""
    stacked = stack_ngram_time_axis(batch)
    labels = np.asarray(stacked['sensor_id'][:, 0], np.int64) % num_classes
    x = stage_batch({'features': stacked['features']}, features_sharding)['features']
    return x, stage_batch({'labels': labels}, labels_sharding)['labels']


def train(dataset_url, steps=50, batch_size=16, window=8, seq_axis_size=None, num_classes=8,
          seed=0, context='ring', device=None, graphed=True, on_step=None):
    """``steps`` steps over the mesh; ``batch_size`` is the global batch.
    ``on_step(i, metrics, wait_s)`` is called after each step, ``wait_s``
    the seconds the loop waited for the step's batch (read, stack, stage).
    Returns the state and every step's loss."""
    device = resolve_device(device)
    feature_dim = TelemetrySchema.fields['features'].shape[0]
    n = _world_size()
    seq_size = seq_axis_size or (2 if n % 2 == 0 else 1)
    if batch_size % (n // seq_size) or window % seq_size:
        raise ValueError('batch_size must divide the data axis and window the seq axis')
    owns_group = not dist.is_initialized()
    mesh = make_mesh(('data', 'seq'), axis_shapes=(-1, seq_size), device=device)
    try:
        fields = {i: [TelemetrySchema.fields['timestamp'], TelemetrySchema.fields['features'],
                      TelemetrySchema.fields['sensor_id']] for i in range(window)}
        ngram = NGram(fields, delta_threshold=1,
                      timestamp_field=TelemetrySchema.fields['timestamp'])
        torch.manual_seed(seed)
        model = make_sequence_transformer(num_classes, window, feature_dim, mesh=mesh,
                                          context_parallelism=context)
        state = shard_train_state(create_train_state(model, device=device), mesh)
        step = make_train_step(graphed=graphed)
        features_sharding = data_sharding(mesh, seq_axis='seq')
        labels_sharding = data_sharding(mesh)
        cur_shard, shard_count = reader_shard_for_process(mesh)
        losses = []
        with make_reader(dataset_url, output='columnar', ngram=ngram, shuffle_row_groups=True,
                         seed=seed, num_epochs=None, cur_shard=cur_shard,
                         shard_count=shard_count) as reader:
            loader = TorchDataLoader(reader, batch_size=process_local_batch_size(batch_size, mesh),
                                     seed=seed)
            it = iter(loader)
            for i in range(steps):
                t0 = time.perf_counter()
                x, labels = stage_windows(next(it), features_sharding, labels_sharding,
                                          num_classes)
                wait_s = time.perf_counter() - t0
                state, metrics = step(state, x, labels)
                losses.append(metrics['loss'])
                if on_step is not None:
                    on_step(i, metrics, wait_s)
                if i % 10 == 0:
                    print('step {}: loss={:.4f}'.format(i, float(metrics['loss'])))
        return state, torch.stack(losses).tolist() if losses else []
    finally:
        if owns_group:
            dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/sequence_dataset')
    parser.add_argument('--steps', type=int, default=50)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--window', type=int, default=8)
    parser.add_argument('--context', choices=('ring', 'ulysses'), default='ring',
                        help='context-parallel attention strategy')
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    parser.add_argument('--eager', action='store_true', help='the eager step, not the graphed one')
    args = parser.parse_args()
    train(args.dataset_url, args.steps, args.batch_size, args.window, context=args.context,
          device=args.device, graphed=not args.eager)


if __name__ == '__main__':
    main()
