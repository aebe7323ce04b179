"""Rank functions that the mesh tests and ``chip_smoke.py`` start with
:func:`petastorm_tpu_torch.parallel.launch.spawn`. They live in the package,
not in a test module, because a spawned rank re-imports its function's
module, and a test module imports JAX.

:func:`sharded_steps` is the sharded ResNet train step on a mesh of the
world, fed either a fixed global batch (each rank takes its data
coordinate's rows) or a store read through each rank's own reader shard,
loader and ``prefetch_to_device`` onto the mesh's data sharding. It
returns what the callers hold against one process stepping the global
batch: losses, the gathered parameters and statistics, the head's local
gradient, eval metrics, each step's batch and its digest, step seconds and
the rank's normalize launches.

:func:`attention_cases` runs the ring and Ulysses attention ops on a
``('data', 'seq')`` mesh, and :func:`sequence_steps` the sequence
transformer's sharded train step, fed fixed batches or the columnar NGram
windows of a store. :func:`moe_steps` does the same for the MoE sequence
transformer on a ``('data', 'expert')`` mesh, and :func:`pipeline_cases`
runs GPipe pipelines of gelu stages on a ``('stage',)`` mesh.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.models import BasicBlock, BottleneckBlock, ResNet
from petastorm_tpu_torch.models.train import (create_train_state, gather_state, make_eval_step,
                                              make_train_step, shard_train_state)
from petastorm_tpu_torch.entry import dryrun_preprocess
from petastorm_tpu_torch.ops import RandomCropFlip, flip_with_mask
from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel
from petastorm_tpu_torch.parallel import (data_sharding, make_global_batch, make_mesh,
                                          process_local_batch_size, reader_shard_for_process)

BLOCKS = {'basic': BasicBlock, 'bottleneck': BottleneckBlock}


def build_model(config, weights=None, seed=0):
    """A float32 ResNet from ``config`` (``stage_sizes``, ``block``,
    ``num_classes``, ``num_filters``), loaded with ``weights`` (a
    ``state_dict`` of numpy arrays) or initialised from ``seed``."""
    torch.manual_seed(seed)
    model = ResNet(config['stage_sizes'], BLOCKS[config['block']],
                   num_classes=config['num_classes'], num_filters=config['num_filters'],
                   dtype=torch.float32)
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()})
    return model


def flip_only(images, mask):
    return flip_with_mask(images, mask)


class RecordingCropFlip(RandomCropFlip):
    """:class:`~petastorm_tpu_torch.ops.augment.RandomCropFlip` that keeps
    every draw it is called with (``seen``: one tuple of numpy arrays per
    step)."""

    def __init__(self, crop_h, crop_w, then=None):
        super().__init__(crop_h, crop_w, then)
        self.seen = []

    def __call__(self, images, *draws):
        self.seen.append(tuple(d.detach().to('cpu', copy=True).numpy() for d in draws))
        return super().__call__(images, *draws)


def digest(images, labels):
    """A digest of one staged batch's rows, in order."""
    h = hashlib.sha1(images.detach().cpu().numpy().tobytes())
    h.update(labels.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def state_digest(state):
    h = hashlib.sha1()
    for name, value in sorted(state.items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(value).tobytes())
    return h.hexdigest()


def _group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _store_batches(spec, mesh, sharding):
    """This rank's batches: its reader shard (the data coordinate), a
    2-worker thread pool, the loader and ``prefetch_to_device`` onto the
    data sharding."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

    cur_shard, shard_count = reader_shard_for_process(mesh)
    local = process_local_batch_size(spec['global_batch'], mesh)
    with make_reader(spec['url'], reader_pool_type='thread', workers_count=2, seed=0,
                     output='columnar', num_epochs=None, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = TorchDataLoader(reader, batch_size=local,
                                 shuffling_queue_capacity=4 * local, seed=0)
        it = prefetch_to_device(loader, sharding, size=2)
        try:
            for _ in range(spec['steps']):
                yield next(it)
        finally:
            it.close()


def _fixed_batches(spec, sharding):
    batch = len(spec['images']) // sharding.size
    rows = slice(sharding.index * batch, (sharding.index + 1) * batch)
    images = torch.from_numpy(np.ascontiguousarray(spec['images'][rows])).to(sharding.device)
    labels = torch.from_numpy(np.ascontiguousarray(spec['labels'][rows])).to(sharding.device)
    for _ in range(spec['steps']):
        yield {'image': images, 'label': labels}


def sharded_steps(rank, world, spec):
    """``spec['steps']`` sharded train steps on a ``('data', 'model')``
    mesh of ``spec['axis_shapes']`` over ``spec['device']``.

    ``spec``: ``model`` (:func:`build_model`'s config), ``weights`` or
    ``seed``, ``lr``, ``flip_seed`` (``None``: no preprocess; else the
    step's preprocess seed, with ``preprocess`` ``'flip'``,
    ``'flip_normalize'`` or ``'crop_flip'``: a :class:`RecordingCropFlip` to
    ``crop`` x ``crop``, whose draws are returned as ``draws``), ``record`` (the steps after which the gathered
    state is kept), ``eval`` (an eval step after the last), ``tf32``,
    ``cudnn`` (``False``: PyTorch's own convolutions on a card) and
    either ``images``/``labels`` (a fixed global batch) or ``url``/
    ``global_batch`` (read through the rank's own reader)."""
    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = spec.get('tf32', False)
        torch.backends.cudnn.allow_tf32 = spec.get('tf32', False)
        torch.backends.cudnn.enabled = spec.get('cudnn', True)
    mesh = make_mesh(('data', 'model'), spec['axis_shapes'], device=spec['device'])
    sharding = data_sharding(mesh)
    state = create_train_state(build_model(spec['model'], spec.get('weights'), spec.get('seed', 0)),
                               device=sharding.device, learning_rate=spec.get('lr', 0.1))
    state = shard_train_state(state, mesh)
    preprocess = None
    if spec.get('preprocess') == 'crop_flip':
        preprocess = RecordingCropFlip(spec['crop'], spec['crop'])
    elif spec.get('flip_seed') is not None:
        preprocess = {'flip': flip_only,
                      'flip_normalize': dryrun_preprocess}[spec.get('preprocess', 'flip')]
    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=spec.get('flip_seed') or 0)
    batches = (_store_batches(spec, mesh, sharding) if 'url' in spec
               else _fixed_batches(spec, sharding))
    out = {'coord': (sharding.index, sharding.size), 'losses': [], 'accuracies': [],
           'digests': [], 'batches': [], 'step_s': [], 'states': {}, 'state_digests': {},
           'head_type': type(state.module.head).__name__,
           'head_rows': tuple(state.module.head.weight.shape)}
    for i, batch in enumerate(batches, 1):
        images, labels = batch['image'], batch['label']
        out['digests'].append(digest(images, labels))
        if 'url' in spec:
            out['batches'].append((images.to('cpu', copy=True).numpy(),
                                   labels.to('cpu', copy=True).numpy()))
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, images, labels)
        _sync(device)
        out['step_s'].append(time.perf_counter() - t0)
        out['losses'].append(metrics['loss'].item())
        out['accuracies'].append(metrics['accuracy'].item())
        if i == 1:
            head = state.module.head
            out['head_grad'] = head.weight.grad.detach().to('cpu', copy=True).numpy()
            rows = getattr(head, 'rows', slice(0, head.weight.shape[0]))
            out['head_grad_rows'] = (rows.start, rows.stop)
        if i in spec.get('record', ()):
            out['states'][i] = gather_state(state)
            out['state_digests'][i] = state_digest(out['states'][i])
        if spec.get('eval') and i == spec['steps']:
            metrics = make_eval_step()(state, images, labels)
            out['eval'] = {k: v.item() for k, v in metrics.items()}
    out['launches'] = {'normalize': normalize_kernel.launches}
    out['draws'] = getattr(preprocess, 'seen', None)
    return out


def pipeline_to_train_step(rank, world, url):
    """The twin of the JAX package's ``test_pipeline_to_train_step`` on a
    ``('data',)`` mesh of the world: the 100-row test store read on each
    rank's shard with a transform to 16x16 float images, global batches of
    16 through ``TorchDataLoader(to_device=sharding)``, one sharded step
    per batch. Returns the steps taken and the last loss."""
    from petastorm_tpu_torch import TransformSpec, make_reader
    from petastorm_tpu_torch.torch import TorchDataLoader

    mesh = make_mesh(('data',), device='cpu')
    sharding = data_sharding(mesh)
    cur_shard, shard_count = reader_shard_for_process(mesh)
    spec = TransformSpec(to_sample,
                         edit_fields=[('image', np.float32, (16, 16, 3), False),
                                      ('label', np.int64, (), False)],
                         removed_fields=['image_png'], selected_fields=['image', 'label'])
    model = build_model({'stage_sizes': [1, 1], 'block': 'basic', 'num_classes': 4,
                         'num_filters': 8})
    state = shard_train_state(create_train_state(model, device='cpu'), mesh)
    step = make_train_step()
    steps, loss = 0, None
    with make_reader(url, reader_pool_type='thread', workers_count=2,
                     schema_fields=['id', 'image_png'], transform_spec=spec,
                     shuffle_row_groups=True, seed=0, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = TorchDataLoader(reader, batch_size=process_local_batch_size(16, mesh),
                                 to_device=sharding)
        for batch in loader:
            state, metrics = step(state, batch['image'], batch['label'])
            steps += 1
            loss = metrics['loss'].item()
    return steps, loss


def to_sample(row):
    """The JAX test's transform: a 16x16 float crop of the PNG and
    ``id % 4`` as the label."""
    row['image'] = row['image_png'][:16, :16].astype(np.float32) / 255.0
    row['label'] = np.int64(row['id'] % 4)
    return row


def several_sharded_runs(rank, world, specs, uneven_classes=None):
    """:func:`sharded_steps` for each of ``specs`` in one world; with
    ``uneven_classes``, also the error a column-parallel head of that width
    raises on the last mesh's model group (``None`` when the group has one
    rank or the width divides)."""
    from torch import nn

    from petastorm_tpu_torch.models.train import ColumnParallelHead
    from petastorm_tpu_torch.parallel.mesh import axis_group

    runs = [sharded_steps(rank, world, spec) for spec in specs]
    uneven = None
    if uneven_classes is not None:
        group = axis_group(make_mesh(('data', 'model'), specs[-1]['axis_shapes'],
                                     device=specs[-1]['device']), 'model')
        try:
            if group is not None:
                ColumnParallelHead(nn.Linear(4, uneven_classes), group)
        except ValueError as e:
            uneven = str(e)
    return runs, uneven


def mesh_facts(rank, world, spec):
    """The mesh helpers on a ``('data', 'model')`` mesh of the world: the
    data sharding, the reader shard, the local batch size and its error,
    ``make_global_batch`` of a batch that differs by rank (a numeric, a
    string and a datetime column), three batches of the store through
    ``TorchDataLoader(to_device=sharding)`` over a 2-worker thread pool
    (their digests), then :func:`sharded_steps` over ``spec``."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.parallel import make_global_batch
    from petastorm_tpu_torch.torch import TorchDataLoader

    mesh = make_mesh(('data', 'model'), spec['axis_shapes'], device=spec['device'])
    sharding = data_sharding(mesh)
    facts = {'coord': (sharding.index, sharding.size),
             'replicas': None if sharding.replica_group is None else
             torch.distributed.get_world_size(sharding.replica_group),
             'reader_shard': reader_shard_for_process(mesh),
             'reader_shard_no_mesh': reader_shard_for_process(),
             'local_batch': process_local_batch_size(spec['global_batch'], mesh)}
    try:
        process_local_batch_size(spec['global_batch'] + 1, mesh)
    except ValueError as e:
        facts['local_batch_error'] = str(e)
    staged = make_global_batch({'x': np.arange(4, dtype=np.float32) + 100 * rank,
                                's': np.array(['rank{}'.format(rank)] * 4, dtype=object),
                                'ts': np.array(['2024-01-0{}'.format(rank + 1)] * 4,
                                               dtype='datetime64[ns]')}, sharding)
    facts['global_batch'] = {k: (type(v).__name__, np.asarray(v.cpu() if isinstance(
        v, torch.Tensor) else v)) for k, v in staged.items()}
    cur_shard, shard_count = facts['reader_shard']
    with make_reader(spec['url'], reader_pool_type='thread', workers_count=2, seed=0,
                     output='columnar', num_epochs=None, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = iter(TorchDataLoader(reader, batch_size=facts['local_batch'],
                                      shuffling_queue_capacity=4 * facts['local_batch'],
                                      seed=0, to_device=sharding))
        facts['loader_digests'] = [digest(b['image'], b['label'])
                                   for b in (next(loader) for _ in range(3))]
    return facts, sharded_steps(rank, world, spec)


# -- the long-context path: attention ops and the sequence train step --------

def attention_cases(rank, world, cases, device='cpu'):
    """Each case on a ``('data', 'seq')`` mesh of ``case['mesh']``: the
    global output of ``make_ring_attention``/``make_ulysses_attention``
    (``case['kind']``, ``causal``, ``kv_chunk``) on the global q, k, v;
    with ``case['cot']``, the gradients of ``sum(out * cot)`` with respect
    to q, k and v through the sharded op on this rank's shards, gathered.
    A case of kind ``'errors'`` returns the messages of the indivisible-heads
    refusals (3 heads on the mesh's seq axis)."""
    from petastorm_tpu_torch.models.transformer import make_sequence_transformer
    from petastorm_tpu_torch.ops.ring_attention import (gather_global, make_ring_attention,
                                                        make_sharded_ring_attention, shard_global)
    from petastorm_tpu_torch.ops.ulysses_attention import (make_sharded_ulysses_attention,
                                                           make_ulysses_attention,
                                                           ulysses_attention)
    from petastorm_tpu_torch.parallel.mesh import axis_group

    results = []
    for case in cases:
        mesh = make_mesh(('data', 'seq'), case['mesh'], device=device)
        if case['kind'] == 'errors':
            x = torch.zeros(1, 3, 4 * case['mesh'][1], 4, device=device)
            errors = {}
            for name, call in (
                    ('make_ulysses_attention', lambda: make_ulysses_attention(mesh)(x, x, x)),
                    ('ulysses_attention', lambda: ulysses_attention(
                        x, x, x, axis_group(mesh, 'seq'))),
                    ('make_sequence_transformer', lambda: make_sequence_transformer(
                        6, 4 * case['mesh'][1], 8, mesh=mesh, num_heads=6,
                        context_parallelism='ulysses'))):
                try:
                    call()
                except ValueError as e:
                    errors[name] = str(e)
            results.append(errors)
            continue
        kwargs = {'causal': case.get('causal', False)}
        if case['kind'] == 'ring':
            make, make_sharded = make_ring_attention, make_sharded_ring_attention
        else:
            make, make_sharded = make_ulysses_attention, make_sharded_ulysses_attention
            kwargs['kv_chunk'] = case.get('kv_chunk')
        q, k, v = (torch.from_numpy(case[n]).to(device) for n in 'qkv')
        out = make(mesh, seq_axis='seq', batch_axis='data', **kwargs)(q, k, v)
        result = {'out': out.cpu().numpy()}
        if case.get('cot') is not None:
            shards = [shard_global(x, mesh, 'seq', 'data').clone().requires_grad_(True)
                      for x in (q, k, v)]
            local = make_sharded(mesh, seq_axis='seq', batch_axis='data', **kwargs)(*shards)
            cot = shard_global(torch.from_numpy(case['cot']).to(device), mesh, 'seq', 'data')
            (local * cot).sum().backward()
            result['grads'] = [gather_global(x.grad, mesh, 'seq', 'data').cpu().numpy()
                               for x in shards]
        results.append(result)
    return results


def build_sequence_model(config, mesh=None, weights=None, seed=0, context='ring', causal=False):
    """A float32 :class:`~petastorm_tpu_torch.models.transformer.SequenceTransformer`
    from ``config`` (``num_classes``, ``seq_len``, ``feature_dim``,
    ``d_model``, ``num_heads``, ``num_layers``), on ``mesh`` with
    ``context`` attention (``causal`` masks by global position), loaded with
    ``weights`` or initialised from ``seed``. Without a mesh a causal model
    runs the ring op on one rank: exact causal full attention."""
    from functools import partial

    from petastorm_tpu_torch.models.transformer import (SequenceTransformer,
                                                        make_sequence_transformer)
    from petastorm_tpu_torch.ops.ring_attention import (make_sharded_ring_attention,
                                                        ring_attention)
    from petastorm_tpu_torch.ops.ulysses_attention import make_sharded_ulysses_attention
    from petastorm_tpu_torch.parallel.mesh import axis_group

    torch.manual_seed(seed)
    if not causal:
        model = make_sequence_transformer(mesh=mesh, context_parallelism=context, **config)
    else:
        if mesh is None:
            attention = partial(ring_attention, causal=True)
        else:
            make = {'ring': make_sharded_ring_attention,
                    'ulysses': make_sharded_ulysses_attention}[context]
            attention = make(mesh, causal=True)
        model = SequenceTransformer(attention_fn=attention,
                                    seq_group=None if mesh is None else axis_group(mesh, 'seq'),
                                    **config)
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()})
    return model


def _window_batches(spec, mesh):
    """This rank's ``(x [B_local, T, F], y [B_local])`` numpy batches: the
    columnar NGram windows of ``spec['url']`` (seeded by
    ``spec['reader_seed']``) through ``TorchDataLoader`` and
    ``stack_ngram_time_axis``, labels ``spec['label_field'][:, 0] %
    num_classes``. With ``spec['shard']`` the rank reads its reader shard
    (the data coordinate) through a 2-worker thread pool in local batches;
    else the whole store on the dummy pool in global batches, whose data
    coordinate's rows it keeps."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.torch import TorchDataLoader, stack_ngram_time_axis

    window = spec['model']['seq_len']
    ngram = NGram({i: list(spec['ngram_fields']) for i in range(window)},
                  delta_threshold=spec['delta_threshold'], timestamp_field=spec['timestamp_field'])
    sharding = data_sharding(mesh)
    kwargs = {'ngram': ngram, 'output': 'columnar', 'num_epochs': None,
              'seed': spec['reader_seed']}
    if spec.get('shard'):
        cur_shard, shard_count = reader_shard_for_process(mesh)
        kwargs.update(reader_pool_type='thread', workers_count=2, shuffle_row_groups=True,
                      cur_shard=cur_shard, shard_count=shard_count)
        batch, rows = process_local_batch_size(spec['global_batch'], mesh), slice(None)
    else:
        kwargs.update(reader_pool_type='dummy', shuffle_row_groups=False)
        batch = spec['global_batch']
        local = batch // sharding.size
        rows = slice(sharding.index * local, (sharding.index + 1) * local)
    with make_reader(spec['url'], **kwargs) as reader:
        loader = iter(TorchDataLoader(reader, batch_size=batch, drop_last=True))
        for _ in range(spec['steps']):
            stacked = stack_ngram_time_axis(next(loader))
            y = stacked[spec['label_field']][:, 0] % spec['model']['num_classes']
            yield stacked[spec['feature_field']][rows], y[rows]


def sequence_steps(rank, world, spec):
    """``spec['steps']`` sequence train steps on a ``('data', 'seq')`` mesh
    of ``spec['axis_shapes']`` over ``spec['device']``: the model of
    :func:`build_sequence_model` (``model``, ``weights`` or ``seed``,
    ``context``, ``causal``), ``shard_train_state``, the plain step, each
    batch's features staged onto the sequence sharding
    (``data_sharding(mesh, seq_axis='seq')``) and its labels onto the data
    sharding. Batches: ``batches`` (global ``(x, y)`` pairs; each rank
    takes its data coordinate's rows) or the NGram windows of ``url``
    (:func:`_window_batches`). Returns the coordinates, the losses, every
    parameter's gradient after step 1 (summed over the seq group and
    averaged over the data group), the gathered state after each step in
    ``record``, each step's staged slice and labels, and the model's
    logits on the first batch before any step (this rank's rows)."""
    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(('data', 'seq'), spec['axis_shapes'], device=spec['device'])
    rows_sharding = data_sharding(mesh)
    seq_sharding = data_sharding(mesh, seq_axis='seq')
    model = build_sequence_model(spec['model'], mesh, spec.get('weights'), spec.get('seed', 0),
                                 spec.get('context', 'ring'), spec.get('causal', False))
    state = create_train_state(model, device=rows_sharding.device,
                               learning_rate=spec.get('lr', 0.1))
    state = shard_train_state(state, mesh)
    step = make_train_step()
    if 'batches' in spec:
        local = len(spec['batches'][0][1]) // rows_sharding.size
        rows = slice(rows_sharding.index * local, (rows_sharding.index + 1) * local)
        batches = ((x[rows], y[rows]) for x, y in spec['batches'][:spec['steps']])
    else:
        batches = _window_batches(spec, mesh)
    out = {'coord': (rows_sharding.index, rows_sharding.size, seq_sharding.seq_index,
                     seq_sharding.seq_size),
           'losses': [], 'slices': [], 'labels': [], 'states': {}, 'step_s': []}
    for i, (x, y) in enumerate(batches, 1):
        x = make_global_batch({'x': np.ascontiguousarray(x, dtype=np.float32)}, seq_sharding)['x']
        y = make_global_batch({'y': np.ascontiguousarray(y, dtype=np.int64)}, rows_sharding)['y']
        out['slices'].append(x.cpu().numpy())
        out['labels'].append(y.cpu().numpy())
        if i == 1:
            with torch.no_grad():
                out['logits'] = state.module(x).cpu().numpy()
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, x, y)
        _sync(device)
        out['step_s'].append(time.perf_counter() - t0)
        out['losses'].append(metrics['loss'].item())
        if i == 1:
            out['grads'] = {name: p.grad.detach().cpu().numpy()
                            for name, p in state.module.named_parameters()}
        if i in spec.get('record', ()):
            out['states'][i] = gather_state(state)
    return out


def several_sequence_runs(rank, world, specs):
    """:func:`sequence_steps` for each of ``specs`` in one world."""
    return [sequence_steps(rank, world, spec) for spec in specs]


def build_moe_model(config, mesh=None, weights=None, seed=0):
    """A float32 :class:`~petastorm_tpu_torch.models.moe.MoESequenceTransformer`
    from ``config`` (``num_classes``, ``num_experts``, ``seq_len``,
    ``feature_dim``, ``d_model``, ``num_heads``, ``num_layers``), on
    ``mesh``, loaded with ``weights`` (all experts; a sharded model keeps
    its slice) or initialised from ``seed``."""
    from petastorm_tpu_torch.models import MoESequenceTransformer

    torch.manual_seed(seed)
    model = MoESequenceTransformer(mesh=mesh, **config)
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()})
    return model


def full_grads(module):
    """Every parameter's gradient as numpy, each MoE layer's experts
    gathered over the expert group (a collective of the group)."""
    from petastorm_tpu_torch.models.moe import EXPERT_PARAMS, MoEMlp
    from petastorm_tpu_torch.models.train import gather_rows

    layers = {prefix: layer for prefix, layer in module.named_modules()
              if isinstance(layer, MoEMlp) and layer.expert_group is not None}
    grads = {}
    for name, p in module.named_parameters():
        prefix, _, leaf = name.rpartition('.')
        if prefix in layers and leaf in EXPERT_PARAMS:
            grads[name] = gather_rows(p.grad, layers[prefix].expert_group)
        else:
            grads[name] = p.grad.detach().cpu().numpy()
    return grads


def moe_steps(rank, world, spec):
    """``spec['steps']`` MoE train steps on a ``('data', 'expert')`` mesh of
    ``spec['axis_shapes']`` over ``spec['device']``: the model of
    :func:`build_moe_model` (``model``, ``weights`` or ``seed``),
    ``shard_train_state``, the plain step on ``moe_loss``, each batch's
    features and labels staged onto the data sharding (replicated over the
    expert group). Batches: ``batches`` (global ``(x, y)`` pairs; each rank
    takes its data coordinate's rows) or the NGram windows of ``url``
    (:func:`_window_batches`). Returns the coordinates, the losses and aux
    losses, every parameter's whole gradient after step 1, the gathered
    state after each step in ``record``, each step's staged rows and
    labels, the model's logits on the first batch before any step (this
    rank's rows), the routing statistics of the last batch and the step
    seconds. With ``refuse_experts``, instead, the errors that a layer of
    that many experts and ``shard_train_state`` of a model not built on the
    mesh raise."""
    from petastorm_tpu_torch.models import MoEMlp

    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(('data', 'expert'), spec['axis_shapes'], device=spec['device'])
    if 'refuse_experts' in spec:
        refusals = {}
        for name, make in (('experts', lambda: MoEMlp(8, spec['refuse_experts'], 8, mesh=mesh)),
                           ('unsharded', lambda: shard_train_state(create_train_state(
                               build_moe_model(spec['model']), device=spec['device']), mesh))):
            try:
                make()
            except ValueError as e:
                refusals[name] = str(e)
        return refusals
    rows_sharding = data_sharding(mesh)
    model = build_moe_model(spec['model'], mesh, spec.get('weights'), spec.get('seed', 0))
    state = create_train_state(model, device=rows_sharding.device,
                               learning_rate=spec.get('lr', 0.1))
    state = shard_train_state(state, mesh)
    step = make_train_step()
    if 'batches' in spec:
        local = len(spec['batches'][0][1]) // rows_sharding.size
        rows = slice(rows_sharding.index * local, (rows_sharding.index + 1) * local)
        batches = ((x[rows], y[rows]) for x, y in spec['batches'][:spec['steps']])
    else:
        batches = _window_batches(spec, mesh)
    out = {'coord': (rows_sharding.index, rows_sharding.size, mesh.get_local_rank('expert'),
                     mesh.shape[1]),
           'reader_shard': reader_shard_for_process(mesh),
           'replicas': _group_size(rows_sharding.replica_group),
           'losses': [], 'auxes': [], 'slices': [], 'labels': [], 'states': {}, 'step_s': []}
    for i, (x, y) in enumerate(batches, 1):
        staged = make_global_batch({'x': np.ascontiguousarray(x, dtype=np.float32),
                                    'y': np.ascontiguousarray(y, dtype=np.int64)}, rows_sharding)
        x, y = staged['x'], staged['y']
        out['slices'].append(x.cpu().numpy())
        out['labels'].append(y.cpu().numpy())
        if i == 1:
            with torch.no_grad():
                out['logits'] = state.module(x)[0].cpu().numpy()
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, x, y)
        _sync(device)
        out['step_s'].append(time.perf_counter() - t0)
        out['losses'].append(metrics['loss'].item())
        out['auxes'].append(metrics['aux'].item())
        if i == 1:
            out['grads'] = full_grads(state.module)
        if i in spec.get('record', ()):
            out['states'][i] = gather_state(state)
    out['routing'] = state.module.routing_stats(x)
    return out


def several_moe_runs(rank, world, specs):
    """:func:`moe_steps` for each of ``specs`` in one world."""
    return [moe_steps(rank, world, spec) for spec in specs]


def pipeline_cases(rank, world, cases):
    """GPipe pipelines of :func:`~petastorm_tpu_torch.entry.gelu_stage` on a
    ``('stage',)`` mesh of the world over ``case['device']``, one per case:
    stacked ``w``, ``b`` (numpy), ``microbatches``, and the global batch
    ``x`` (numpy) or ``global_batch`` rows of ``url``'s ``field`` (a
    2-worker thread pool, staged onto ``data_sharding(mesh, batch_axes=())``
    so every stage holds rank 0's rows). Returns per case the staged batch,
    the output, this stage's rows of the gradients of ``sum(y**2)`` and,
    over ``repeat`` runs, the seconds of each forward and each forward +
    backward; with ``refuse``, the errors of a stack of ``S + 1`` stages
    and of a batch of ``microbatches + 1`` rows instead."""
    from petastorm_tpu_torch.entry import gelu_stage
    from petastorm_tpu_torch.parallel.pipeline import make_pipelined_apply

    results = []
    for case in cases:
        device = torch.device(case['device'])
        if device.type == 'cuda':
            torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh(('stage',), device=case['device'])
        stage = mesh.get_local_rank('stage')
        apply = make_pipelined_apply(mesh, gelu_stage, num_microbatches=case['microbatches'])
        w = torch.from_numpy(case['w']).to(device).requires_grad_()
        b = torch.from_numpy(case['b']).to(device).requires_grad_()
        if case.get('refuse'):
            errors = []
            for params, x in (((torch.cat([w, w[:1]]), torch.cat([b, b[:1]])),
                               torch.zeros(case['microbatches'], w.shape[1])),
                              ((w, b), torch.zeros(case['microbatches'] + 1, w.shape[1]))):
                try:
                    apply(params, x.to(device))
                except ValueError as e:
                    errors.append(str(e))
            results.append({'errors': errors})
            continue
        if 'x' in case:
            x = torch.from_numpy(case['x']).to(device)
        else:
            from petastorm_tpu_torch import make_reader
            from petastorm_tpu_torch.torch import TorchDataLoader

            with make_reader(case['url'], reader_pool_type='thread', workers_count=2, seed=0,
                             output='columnar', num_epochs=None) as reader:
                batch = next(iter(TorchDataLoader(reader, batch_size=case['global_batch'])))
            x = make_global_batch({'x': np.asarray(batch[case['field']], dtype=np.float32)},
                                  data_sharding(mesh, batch_axes=()))['x']
        forward_s, backward_s = [], []
        for _ in range(case.get('repeat', 1)):
            _sync(device)
            t0 = time.perf_counter()
            with torch.no_grad():
                y = apply((w, b), x)
            _sync(device)
            forward_s.append(time.perf_counter() - t0)
            w.grad = b.grad = None
            t0 = time.perf_counter()
            (apply((w, b), x) ** 2).sum().backward()
            _sync(device)
            backward_s.append(time.perf_counter() - t0)
        replicated = data_sharding(mesh, batch_axes=())
        results.append({'stage': stage, 'reader_shard': reader_shard_for_process(mesh),
                        'sharding': (replicated.index, replicated.size,
                                     _group_size(replicated.replica_group)),
                        'x': x.cpu().numpy(), 'y': y.cpu().numpy(),
                        'w_grad': w.grad[stage].cpu().numpy(),
                        'b_grad': b.grad[stage].cpu().numpy(),
                        'other_rows_zero': all(bool((g[torch.arange(len(g)) != stage] == 0).all())
                                               for g in (w.grad, b.grad)),
                        'forward_s': forward_s, 'forward_backward_s': backward_s})
    return results


def sequential_stages(w, b, x, dtype=torch.float32, device='cpu'):
    """The stacked stages ``w [S, D, D]``, ``b [S, D]`` (numpy) of
    :func:`~petastorm_tpu_torch.entry.gelu_stage` run one after another on
    ``x`` in ``dtype`` on ``device``: the output and the gradients of
    ``sum(y**2)`` with respect to ``w`` and ``b``, as float64 numpy."""
    from petastorm_tpu_torch.entry import gelu_stage

    w, b = (torch.from_numpy(t).to(device, dtype).requires_grad_() for t in (w, b))
    y = torch.from_numpy(x).to(device, dtype)
    for s in range(w.shape[0]):
        y = gelu_stage((w[s], b[s]), y)
    (y ** 2).sum().backward()
    return tuple(t.detach().cpu().double().numpy() for t in (y, w.grad, b.grad))


def float32_rounding_excess(ours, f32, f64):
    """How far the float32 result ``ours`` lies from the float64 ``f64``
    beyond float32's rounding: its largest error, less twice the largest
    error of ``f32`` (the same function computed plainly in float32) and
    less float32's epsilon times ``f64``'s largest magnitude. At most 0
    when ``ours`` is as close as a float32 computation gets."""
    return float(np.abs(ours - f64).max() - 2 * np.abs(f32 - f64).max()
                 - np.finfo(np.float32).eps * np.abs(f64).max())


def moe_and_pipeline_runs(rank, world, moe_specs, cases):
    """:func:`several_moe_runs` of ``moe_specs``, then
    :func:`pipeline_cases` of ``cases``, in one world."""
    return several_moe_runs(rank, world, moe_specs), pipeline_cases(rank, world, cases)
