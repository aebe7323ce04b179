"""Entry points: the twin of the repository's ``__graft_entry__.py``.

``entry()`` returns the flagship model's forward step (ResNet-50, bf16, 1000
classes) with an example batch. ``dryrun_multichip(n)`` runs the product
path on tiny shapes in ``n`` spawned ranks on a ``('data', 'model')`` mesh,
the dp/tp leg of the JAX dry run as a pod host runs it: materialize a store
-> each rank's ``make_reader`` (thread pool, columnar blocks) on its reader
shard -> shuffling loader -> ``prefetch_to_device`` onto the mesh's data
sharding -> three sharded train steps (dp over ``data``, the classifier
head tensor-parallel over ``model``) with ``random_flip`` and ``normalize``
inside; then one batch through the process pool; then the sequence-parallel
(sp) leg on a ``('data', 'seq')`` mesh: each rank's columnar NGram windows
of a sequence store -> ``stack_ngram_time_axis`` -> its ``[B/data, T/seq,
F]`` slice -> one ring-attention transformer train step; then the
expert-parallel (ep) leg on a ``('data', 'expert')`` mesh: the same windows
staged ``P('data')`` (replicated over ``expert``) -> one train step of the
MoE sequence transformer, experts sharded over ``expert``; then the
pipeline-parallel (pp) leg: a batch of the sequence store through a GPipe
pipeline of gelu layers over a ``stage`` axis, held against running the
stages one after another. Every leg of the JAX dry run runs.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.device import resolve_device

#: the legs of the JAX dry run this one runs
LEGS_RUN = ('dp/tp', 'process pool', 'sp', 'ep', 'pp')

#: the legs it does not run yet, with the ROADMAP.md item that ports each
LEGS_NOT_PORTED = {}


def entry(device=None):
    """``(fn, example_args)``: ``fn(model, images)`` is the eval-mode forward
    of ResNet-50 (bf16 body, 1000 classes) on ``device`` (``None`` = CUDA);
    the example batch is ``(8, 64, 64, 3)`` float32 from a seed."""
    from petastorm_tpu_torch.models import resnet50

    device = resolve_device(device)
    torch.manual_seed(0)
    model = resnet50(num_classes=1000, dtype=torch.bfloat16)
    model.to(device=device, memory_format=torch.channels_last).eval()
    images = torch.from_numpy(np.random.default_rng(0).random((8, 64, 64, 3), dtype=np.float32))

    def forward(model, images):
        with torch.no_grad():
            return model(images)

    return forward, (model, images.to(device))


def dryrun_store(url, rows):
    """Write the dry run's store at ``url``: ``rows`` seeded 32x32x3 uint8
    images and labels of 16 classes, 8 rows per row group."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    rng = np.random.default_rng(0)
    schema = Unischema('DryRun', [
        UnischemaField('image', np.uint8, (32, 32, 3), NdarrayCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(), False),
    ])
    with materialize_dataset(url, schema, rows_per_row_group=8) as writer:
        for _ in range(rows):
            writer.write({'image': rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                          'label': int(rng.integers(0, 16))})


def dryrun_seq_store(url, n_ranks):
    """Write the sp leg's store at ``url``: int64 timestamps ``ts`` and
    seeded 8-dim float32 features ``f``, ``max(256, 32 x n_ranks)`` rows,
    32 per row group (``__graft_entry__.py``'s sequence store)."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    rng = np.random.default_rng(1)
    schema = Unischema('DrySeq', [
        UnischemaField('ts', np.int64, (), ScalarCodec(), False),
        UnischemaField('f', np.float32, (8,), NdarrayCodec(), False),
    ])
    with materialize_dataset(url, schema, rows_per_row_group=32) as writer:
        for i in range(max(256, 32 * n_ranks)):
            writer.write({'ts': i, 'f': rng.standard_normal(8).astype(np.float32)})


def _dryrun_sequence_parallel(world, device_type, url):
    """The sp leg on one rank: a ``('data', 'seq')`` mesh of the world, this
    rank's reader shard of columnar NGram windows (a 1-worker thread pool),
    ``stack_ngram_time_axis``, the features staged onto the sequence
    sharding and the labels (``ts[:, 0] % 4``) onto the data sharding, one
    train step of a one-layer ring-attention transformer (d_model 16, two
    heads). Returns the mesh and the loss."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.models.train import (create_train_state, make_train_step,
                                                  shard_train_state)
    from petastorm_tpu_torch.models.transformer import make_sequence_transformer
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.parallel import (data_sharding, make_global_batch, make_mesh,
                                              process_local_batch_size, reader_shard_for_process)
    from petastorm_tpu_torch.torch import TorchDataLoader, stack_ngram_time_axis

    seq_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(('data', 'seq'), axis_shapes=(-1, seq_axis), device=device_type)
    window = 2 * seq_axis  # T divisible by the seq axis
    batch = 2 * (world // seq_axis)
    ngram = NGram(fields={o: ['ts', 'f'] for o in range(window)}, delta_threshold=window,
                  timestamp_field='ts')
    torch.manual_seed(2)
    model = make_sequence_transformer(num_classes=4, seq_len=window, feature_dim=8, mesh=mesh,
                                      d_model=16, num_heads=2, num_layers=1,
                                      context_parallelism='ring')
    rows = data_sharding(mesh)
    state = shard_train_state(create_train_state(model, device=rows.device), mesh)
    cur_shard, shard_count = reader_shard_for_process(mesh)
    with make_reader(url, output='columnar', ngram=ngram, reader_pool_type='thread',
                     workers_count=1, seed=1, num_epochs=None, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = TorchDataLoader(reader, batch_size=process_local_batch_size(batch, mesh))
        windows = stack_ngram_time_axis(next(iter(loader)))
    x = make_global_batch({'f': windows['f']}, data_sharding(mesh, seq_axis='seq'))['f']
    y = make_global_batch({'y': windows['ts'][:, 0] % 4}, rows)['y']
    state, metrics = make_train_step()(state, x, y)
    return (world // seq_axis, seq_axis), metrics['loss'].item()


def _dryrun_expert_parallel(world, device_type, url):
    """The ep leg on one rank: a ``('data', 'expert')`` mesh of the world
    (an expert axis of 2 when the world is even), this rank's reader shard
    of columnar NGram windows of 4 (a 1-worker thread pool, seed 3), the
    features and labels (``ts[:, 0] % 4``) staged onto the data sharding
    (replicated over ``expert``), one train step of a one-layer MoE
    sequence transformer (d_model 16, two heads, two experts per expert
    rank) on the loss ``ce + 0.01 aux``. Returns the mesh and the loss;
    raises on a non-finite loss or gradient."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.models import MoESequenceTransformer
    from petastorm_tpu_torch.models.train import (create_train_state, make_train_step,
                                                  shard_train_state)
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.parallel import (data_sharding, make_global_batch, make_mesh,
                                              process_local_batch_size, reader_shard_for_process)
    from petastorm_tpu_torch.torch import TorchDataLoader, stack_ngram_time_axis

    expert_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(('data', 'expert'), axis_shapes=(-1, expert_axis), device=device_type)
    batch = 2 * (world // expert_axis)
    window = 4
    torch.manual_seed(3)
    model = MoESequenceTransformer(num_classes=4, num_experts=2 * expert_axis, seq_len=window,
                                   feature_dim=8, d_model=16, num_heads=2, num_layers=1,
                                   mesh=mesh)
    rows = data_sharding(mesh)
    state = shard_train_state(create_train_state(model, device=rows.device), mesh)
    ngram = NGram(fields={o: ['ts', 'f'] for o in range(window)}, delta_threshold=window,
                  timestamp_field='ts')
    cur_shard, shard_count = reader_shard_for_process(mesh)
    with make_reader(url, output='columnar', ngram=ngram, reader_pool_type='thread',
                     workers_count=1, seed=3, num_epochs=None, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = TorchDataLoader(reader, batch_size=process_local_batch_size(batch, mesh))
        windows = stack_ngram_time_axis(next(iter(loader)))
    staged = make_global_batch({'x': np.asarray(windows['f'], dtype=np.float32),
                                'y': windows['ts'][:, 0] % 4}, rows)
    state, metrics = make_train_step()(state, staged['x'], staged['y'])
    loss = metrics['loss'].item()
    if not math.isfinite(loss):
        raise RuntimeError('non-finite loss in the ep leg of the dry run: {}'.format(loss))
    if not all(bool(torch.isfinite(p.grad).all()) for p in state.module.parameters()):
        raise RuntimeError('non-finite MoE gradients in the ep leg of the dry run')
    return (world // expert_axis, expert_axis), loss


def gelu_stage(params, act):
    """The dry run's pipeline stage: ``gelu(act @ w + b)`` (tanh GELU, as
    ``jax.nn.gelu``)."""
    w, b = params
    return F.gelu(act @ w + b, approximate='tanh')


def _dryrun_pipeline_parallel(world, device_type, url):
    """The pp leg on one rank: a ``('data', 'stage')`` mesh with the JAX dry
    run's stage count (the world for 2, 4 or 8 ranks, else the largest of
    1, 2, 4, 8 that divides it), whose first data coordinate runs the leg
    (the other ranks sit it out); seeded stacked parameters ``w [S, 8, 8]``
    and ``b [S, 8]`` (seed 4), a batch of ``4 S`` rows of the sequence store's
    ``f`` (a 1-worker thread pool, seed 4) staged onto the data sharding
    (the same rows on every stage), ``2 S`` microbatches. Returns the stage
    count and the largest deviation from running the stages one after
    another; raises above 1e-4."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.parallel import data_sharding, make_global_batch, make_mesh
    from petastorm_tpu_torch.parallel.pipeline import make_pipelined_apply
    from petastorm_tpu_torch.torch import TorchDataLoader

    stages = world if world in (2, 4, 8) else max(s for s in (1, 2, 4, 8) if world % s == 0)
    mesh = make_mesh(('data', 'stage'), axis_shapes=(-1, stages), device=device_type)
    rows = data_sharding(mesh)
    if rows.index:
        return stages, None
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((stages, 8, 8)).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.standard_normal((stages, 8)).astype(np.float32) * 0.1)
    w, b = w.to(rows.device), b.to(rows.device)
    with make_reader(url, output='columnar', reader_pool_type='thread', workers_count=1, seed=4,
                     num_epochs=None) as reader:
        batch = next(iter(TorchDataLoader(reader, batch_size=4 * stages)))
    x = make_global_batch({'f': np.asarray(batch['f'], dtype=np.float32)}, rows)['f']
    apply = make_pipelined_apply(mesh, gelu_stage, num_microbatches=2 * stages)
    y = apply((w, b), x)
    ref = x
    for s in range(stages):
        ref = gelu_stage((w[s], b[s]), ref)
    err = float((y - ref).abs().max())
    if not err < 1e-4:
        raise RuntimeError('the pipeline deviates from sequential by {}'.format(err))
    return stages, err


def _model_axis(n_ranks):
    return 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1


def dryrun_preprocess(images, mask):
    """The dry run's device preprocess: the step's flip mask, then
    normalize to float32 around 127.5."""
    from petastorm_tpu_torch.ops import flip_with_mask, normalize_images
    return normalize_images(flip_with_mask(images, mask), 127.5, 127.5, out_dtype=torch.float32)


def _dryrun_rank(rank, world, device_type, url, seq_url):
    """One rank of the dry run (started by :func:`dryrun_multichip`)."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.models import resnet18
    from petastorm_tpu_torch.models.train import (ColumnParallelHead, create_train_state,
                                                  make_train_step, shard_train_state)
    from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel
    from petastorm_tpu_torch.parallel import (data_sharding, make_mesh, process_local_batch_size,
                                              reader_shard_for_process)
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

    model_axis = _model_axis(world)
    mesh = make_mesh(('data', 'model'), axis_shapes=(-1, model_axis), device=device_type)
    sharding = data_sharding(mesh)
    batch = 2 * (world // model_axis)  # 2 rows per data shard
    local = process_local_batch_size(batch, mesh)
    torch.manual_seed(0)
    state = create_train_state(resnet18(num_classes=16, dtype=torch.float32),
                               device=sharding.device)
    state = shard_train_state(state, mesh)
    step = make_train_step(preprocess_fn=dryrun_preprocess)
    cur_shard, shard_count = reader_shard_for_process(mesh)
    shard = {'cur_shard': cur_shard, 'shard_count': shard_count, 'seed': 0,
             'output': 'columnar'}
    with make_reader(url, reader_pool_type='thread', workers_count=2, num_epochs=None,
                     **shard) as reader:
        it = prefetch_to_device(TorchDataLoader(reader, batch_size=local,
                                                shuffling_queue_capacity=4 * local, seed=0),
                                sharding, size=2)
        try:
            for _ in range(3):
                b = next(it)
                state, metrics = step(state, b['image'], b['label'])
        finally:
            it.close()
        loss = metrics['loss'].item()
    # once through the process pool: spawned worker, ring transport,
    # NumpyBlockSerializer across the process boundary
    with make_reader(url, reader_pool_type='process', workers_count=1, **shard) as reader:
        b = next(iter(TorchDataLoader(reader, batch_size=local, to_device=sharding)))
        state, metrics = step(state, b['image'], b['label'])
        process_loss = metrics['loss'].item()
    if not (math.isfinite(loss) and math.isfinite(process_loss)):
        raise RuntimeError('non-finite loss in the dry run: {} (thread pool), {} (process '
                           'pool)'.format(loss, process_loss))
    head = state.module.head
    if model_axis > 1 and not (isinstance(head, ColumnParallelHead)
                               and head.weight.shape[0] == 16 // model_axis):
        raise RuntimeError('the head is not sharded on the model axis: {} {}'.format(
            type(head).__name__, tuple(head.weight.shape)))
    seq_mesh, seq_loss = _dryrun_sequence_parallel(world, device_type, seq_url)
    if not math.isfinite(seq_loss):
        raise RuntimeError('non-finite loss in the sp leg of the dry run: {}'.format(seq_loss))
    ep_mesh, ep_loss = _dryrun_expert_parallel(world, device_type, seq_url)
    pp_stages, pp_err = _dryrun_pipeline_parallel(world, device_type, seq_url)
    return {'mesh': (world // model_axis, model_axis), 'batch': batch, 'loss': loss,
            'process_loss': process_loss, 'head_rows': head.weight.shape[0],
            'seq_mesh': seq_mesh, 'seq_loss': seq_loss, 'ep_mesh': ep_mesh, 'ep_loss': ep_loss,
            'pp_stages': pp_stages, 'pp_err': pp_err,
            'launches': {'normalize': normalize_kernel.launches}}


def dryrun_multichip(n_devices, device=None):
    """The dry run on ``n_devices`` spawned ranks: NCCL with one card each on
    CUDA (``device=None``; raises when CUDA or the cards are missing), gloo
    with ``device='cpu'``. Prints and returns what ran: the mesh, the global
    batch, the losses, rank 0's normalize launches, the legs run and the
    legs not yet ported (none). The sp leg's mesh and loss are ``seq_mesh``
    and ``seq_loss``; the ep leg's ``ep_mesh`` and ``ep_loss``; the pp leg's
    stage count and deviation from sequential execution ``pp_stages`` and
    ``pp_err``."""
    from petastorm_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl' and torch.cuda.device_count() < n_devices:
        raise RuntimeError('dryrun_multichip({}) runs one NCCL rank per card and this host has '
                           '{} CUDA devices'.format(n_devices, torch.cuda.device_count()))
    store = tempfile.mkdtemp(prefix='pstpu_torch_dryrun_')
    try:
        url, seq_url = 'file://' + os.path.join(store, 'images'), 'file://' + os.path.join(
            store, 'seq')
        dryrun_store(url, 8 * (n_devices // _model_axis(n_devices)))
        dryrun_seq_store(seq_url, n_devices)
        result = spawn(_dryrun_rank, n_devices, (device.type, url, seq_url), backend=backend,
                       threads=1 if backend == 'gloo' else None, work_dir=store)[0]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    result.update(legs_run=list(LEGS_RUN), legs_not_ported=dict(LEGS_NOT_PORTED))
    print('dryrun_multichip OK: mesh=({}x{}), batch={}, loss={:.4f}, process_loss={:.4f}, '
          'seq_mesh=({}x{}), seq_loss={:.4f}, ep_mesh=({}x{}), ep_loss={:.4f}, pp_stages={}, '
          'pp_err={:.3g}; legs run: {}; not yet ported: {}'.format(
              result['mesh'][0], result['mesh'][1], result['batch'], result['loss'],
              result['process_loss'], result['seq_mesh'][0], result['seq_mesh'][1],
              result['seq_loss'], result['ep_mesh'][0], result['ep_mesh'][1], result['ep_loss'],
              result['pp_stages'], result['pp_err'], ', '.join(LEGS_RUN),
              ', '.join('{} (ROADMAP.md, "{}")'.format(k, v)
                        for k, v in LEGS_NOT_PORTED.items()) or 'none'))
    return result


if __name__ == '__main__':
    fn, args = entry()
    out = fn(*args)
    print('entry forward OK:', tuple(out.shape), out.dtype)
    dryrun_multichip(torch.cuda.device_count())
