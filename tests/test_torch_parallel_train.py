"""Port parity: the sharded ResNet train step of petastorm_tpu_torch against
the JAX package's ``shard_train_state`` step on the same mesh shape (twin of
``tests/test_models.py``'s sharded tests), and ``piece_filter`` on both
reader factories.

The port's ranks are spawned gloo processes
(``petastorm_tpu_torch.test_util.dist_workers``), one world per mesh shape,
shared by the tests of that shape; JAX runs on ``jax.devices()[:4]`` of the
suite's 8 virtual CPU devices. The model is a tiny float32 ResNet with
seeded weights moved by ``flax_to_torch``. Tolerances: 1e-4 between the
packages and between the sharded and the unsharded step (float32 sums taken
in another order, through three SGD steps); 1e-5 for one step's head
gradient against the unsharded one's slice (a summing gather backward
would double it)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.models.resnet import BasicBlock as JaxBasicBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_eval_step as jax_make_eval_step
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.models.train import shard_train_state as jax_shard_train_state
from petastorm_tpu.models.train import state_shardings as jax_state_shardings
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import (GraphedTrainStep, create_train_state,
                                              gather_state, make_train_step,
                                              shard_train_state, state_shardings)
from petastorm_tpu_torch.parallel import make_mesh
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.test_util import dist_workers

ATOL = 1e-4
GRAD_ATOL = 1e-5
SIZE = 16
BATCH = 8
NUM_CLASSES = 8
CONFIG = {'stage_sizes': [1, 1], 'block': 'basic', 'num_classes': NUM_CLASSES, 'num_filters': 8}
MESHES = [(2, 2), (4, 1), (1, 2)]
FLIP_SEED = 5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_model():
    return JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock, num_classes=NUM_CLASSES,
                     num_filters=8, dtype=jnp.float32)


@pytest.fixture(scope='module')
def setup():
    """Seeded flax variables (non-zero batch-norm scales, so every block
    counts), a global batch and labels."""
    shapes = jax.eval_shape(lambda: _jax_model().init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ('var', 'scale'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        scale = 0.1 if name in ('bias', 'mean') else np.sqrt(2.0 / max(1, np.prod(x.shape[:-1])))
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, {k: dict(v) for k, v in shapes.items()})
    images = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, BATCH)
    weights = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    return variables, weights, images, labels


def _jax_sharded_run(shape, variables, images, labels, steps=3):
    """JAX's shard_train_state step on a ('data', 'model') mesh of ``shape``."""
    mesh = jax_make_mesh(('data', 'model'), axis_shapes=shape,
                         devices=jax.devices()[:shape[0] * shape[1]])
    state = jax_create_train_state(_jax_model(), jax.random.PRNGKey(0),
                                   jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    out = {'losses': [], 'states': {}}
    with mesh:
        state = jax_shard_train_state(state, mesh)
        x = jax.device_put(jnp.asarray(images), NamedSharding(mesh, P('data')))
        y = jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P('data')))
        step = jax_make_train_step(donate=False)
        for i in range(1, steps + 1):
            state, metrics = step(state, x, y)
            out['losses'].append(float(metrics['loss']))
            if i in (1, steps):
                out['states'][i] = flax_to_torch(jax.device_get(
                    {'params': state.params, 'batch_stats': state.batch_stats}))
        out['eval'] = {k: float(v) for k, v in jax_make_eval_step()(state, x, y).items()}
    return out


@pytest.fixture(scope='module')
def runs(setup):
    """Per mesh shape: the port's ranks (a 3-step run with eval, a 2-step
    run with flips, the uneven head's error) and JAX's run. The shapes of
    four ranks share one world, each world is spawned on a thread of its
    own, and JAX steps meanwhile."""
    variables, weights, images, labels = setup
    base = {'device': 'cpu', 'model': CONFIG, 'weights': weights, 'images': images,
            'labels': labels}
    # the last spec of a world is a mesh with a model axis: its model group
    # builds the uneven head
    worlds = {4: [(4, 1), (2, 2)], 2: [(1, 2)]}
    spawned = {}

    def run_world(world, shapes):
        specs = []
        for shape in shapes:
            specs += [dict(base, axis_shapes=shape, steps=3, record=(1, 3), eval=True),
                      dict(base, axis_shapes=shape, steps=2, record=(2,), flip_seed=FLIP_SEED)]
        try:
            spawned[world] = spawn(dist_workers.several_sharded_runs, world,
                                   (specs, NUM_CLASSES + 1), threads=1)
        except Exception as e:  # noqa: BLE001 - raised on the test's thread below
            spawned[world] = e

    threads = [threading.Thread(target=run_world, args=item) for item in worlds.items()]
    for thread in threads:
        thread.start()
    expected = {shape: _jax_sharded_run(shape, variables, images, labels) for shape in MESHES}
    for thread in threads:
        thread.join(timeout=600)
    for result in spawned.values():
        if isinstance(result, Exception):
            raise result
    assert len(spawned) == len(worlds), 'a world did not finish'
    out = {}
    for world, shapes in worlds.items():
        for i, shape in enumerate(shapes):
            ranks = [(rank_runs[2 * i:2 * i + 2], uneven) for rank_runs, uneven in spawned[world]]
            out[shape] = ranks, expected[shape]
    return out.__getitem__


def _unsharded(weights, images, labels, steps, flip_seed=None):
    """The port's step on the global batch in one process, no mesh."""
    state = create_train_state(dist_workers.build_model(CONFIG, weights), device='cpu')
    step = make_train_step(preprocess_fn=None if flip_seed is None else dist_workers.flip_only,
                           preprocess_seed=flip_seed or 0)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses, grad = [], None
    for _ in range(steps):
        state, metrics = step(state, x, y)
        losses.append(metrics['loss'].item())
        if grad is None:
            grad = state.model.head.weight.grad.numpy().copy()
    return losses, gather_state(state), grad


def _assert_state_close(actual, expected, atol):
    assert set(actual) == set(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(actual[key], np.asarray(value), atol=atol, rtol=atol,
                                   err_msg=key)


@pytest.mark.parametrize('shape', MESHES)
def test_sharded_step_matches_jax_sharded_step(runs, shape):
    ranks, expected = runs(shape)
    run = ranks[0][0][0]
    np.testing.assert_allclose(run['losses'], expected['losses'], atol=ATOL, rtol=ATOL)
    for i in (1, 3):
        _assert_state_close(run['states'][i], expected['states'][i], ATOL)
    # every rank holds the same parameters and statistics, and saw the same
    # global metrics
    for i in (1, 3):
        assert len({r[0][0]['state_digests'][i] for r in ranks}) == 1
    assert len({tuple(r[0][0]['losses']) for r in ranks}) == 1
    model_axis = shape[1]
    assert run['head_type'] == ('ColumnParallelHead' if model_axis > 1 else 'Linear')
    assert run['head_rows'] == (NUM_CLASSES // model_axis, 16)


@pytest.mark.parametrize('shape', MESHES)
def test_head_gradient_is_the_unsharded_slice(runs, setup, shape):
    _, weights, images, labels = setup
    ranks, _ = runs(shape)
    _, _, grad = _unsharded(weights, images, labels, steps=1)
    for (rank_runs, _) in ranks:
        start, stop = rank_runs[0]['head_grad_rows']
        assert stop - start == NUM_CLASSES // shape[1]
        np.testing.assert_allclose(rank_runs[0]['head_grad'], grad[start:stop], atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL)


@pytest.mark.parametrize('shape', MESHES)
def test_sharded_eval_step_matches_jax(runs, shape):
    ranks, expected = runs(shape)
    for (rank_runs, _) in ranks:
        assert rank_runs[0]['eval']['loss'] == pytest.approx(expected['eval']['loss'], abs=ATOL)
        assert rank_runs[0]['eval']['accuracy'] == pytest.approx(expected['eval']['accuracy'])


@pytest.mark.parametrize('shape', MESHES)
def test_flip_mask_slices_equal_the_world_of_one(runs, setup, shape):
    # the mask is drawn for the global batch and sliced per data coordinate:
    # the sharded step with flips is the unsharded step with the same seed
    _, weights, images, labels = setup
    ranks, _ = runs(shape)
    losses, state, _ = _unsharded(weights, images, labels, steps=2, flip_seed=FLIP_SEED)
    run = ranks[0][0][1]
    np.testing.assert_allclose(run['losses'], losses, atol=ATOL, rtol=ATOL)
    _assert_state_close(run['states'][2], state, ATOL)


@pytest.mark.parametrize('shape', [(2, 2), (1, 2)])
def test_uneven_head_is_refused_like_jax(runs, setup, shape):
    # JAX refuses a head whose width the model axis does not divide
    variables = setup[0]
    model = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock, num_classes=NUM_CLASSES + 1,
                      num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    mesh = jax_make_mesh(('data', 'model'), axis_shapes=shape,
                         devices=jax.devices()[:shape[0] * shape[1]])
    with pytest.raises(ValueError, match='divisible'):
        jax_shard_train_state(state, mesh)
    ranks, _ = runs(shape)
    for _, uneven in ranks:
        assert 'does not divide' in uneven
    assert variables  # the shared setup


@pytest.fixture
def world_one_2d():
    """A ('data', 'model') mesh of the world of one in this process."""
    assert not dist.is_initialized()
    mesh = make_mesh(('data', 'model'), device='cpu')
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _torch_placements(path, spec, ndim, axes):
    """The torch placements of a flax leaf's PartitionSpec: dense kernels are
    transposed, conv kernels HWIO -> OIHW (``flax_to_torch``)."""
    perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(ndim, tuple(range(ndim))) \
        if path[-1] == 'kernel' else tuple(range(ndim))
    placements = []
    for axis in axes:
        dims = [i for i, s in enumerate(spec) if s == axis]
        placements.append(Shard(perm[dims[0]]) if dims else Replicate())
    return tuple(placements)


@pytest.mark.parametrize('axes', [('data', 'model'), ('data',)])
def test_state_shardings_match_jax_partition_specs(setup, axes):
    variables, weights = setup[:2]
    jax_mesh = jax_make_mesh(axes, axis_shapes=(4, 2)[:len(axes)],
                             devices=jax.devices()[:4 * (2 if len(axes) == 2 else 1)])
    state = jax_create_train_state(_jax_model(), jax.random.PRNGKey(0),
                                   jnp.zeros((1, SIZE, SIZE, 3)))
    shardings = jax_state_shardings(state, jax_mesh)
    expected = {}
    for collection in ('params', 'batch_stats'):
        leaves = jax.tree_util.tree_flatten_with_path(getattr(shardings, collection))[0]
        for path, sharding in leaves:
            keys = tuple(k.key for k in path)
            value = getattr(state, collection)
            for k in keys:
                value = value[k]
            name = '.'.join(keys[:-1] + ('weight' if keys[-1] == 'kernel' else keys[-1],))
            expected[name] = _torch_placements(keys, tuple(sharding.spec), value.ndim, axes)
    assert dist.is_initialized() is False
    mesh = make_mesh(axes, device='cpu')
    try:
        torch_state = create_train_state(dist_workers.build_model(CONFIG, weights), device='cpu')
        assert dict(state_shardings(torch_state, mesh)) == expected
    finally:
        dist.destroy_process_group()
    assert expected['head.weight'] == ((Replicate(), Shard(0)) if len(axes) == 2
                                       else (Replicate(),))


def test_graphed_step_refuses_a_gloo_mesh(world_one_2d, setup):
    state = create_train_state(dist_workers.build_model(CONFIG, setup[1]), device='cpu')
    state = shard_train_state(state, world_one_2d)
    with pytest.raises(RuntimeError, match="'gloo'"):
        GraphedTrainStep._check_state(state)
    with pytest.raises(ValueError, match='already sharded'):
        shard_train_state(state, world_one_2d)


def test_sharding_a_stepped_state_keeps_its_momentum(world_one_2d, setup):
    # shard_train_state rebuilds SGD over the sharded parameters with the
    # momentum buffers and the step counter of the state it is given, as
    # JAX's device_put of a TrainState keeps its opt_state: one step, then
    # sharding, then a second step is two unsharded steps
    _, weights, images, labels = setup
    expected_losses, expected, _ = _unsharded(weights, images, labels, steps=2)
    state = create_train_state(dist_workers.build_model(CONFIG, weights), device='cpu')
    step = make_train_step()
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses = [step(state, x, y)[1]['loss'].item()]
    state = shard_train_state(state, world_one_2d)
    assert state.step == 1
    losses.append(step(state, x, y)[1]['loss'].item())
    assert losses == expected_losses
    _assert_state_close(gather_state(state), expected, 0)


def test_pipeline_to_train_step_on_two_data_ranks(synthetic_dataset):
    # tests/test_models.py::test_pipeline_to_train_step on a ('data',) mesh
    # of two ranks: each reads its half of the 100 rows, 8 rows of each
    # global batch of 16; 6 steps as in JAX (50 rows / 8, drop_last)
    results = spawn(dist_workers.pipeline_to_train_step, 2, (synthetic_dataset.url,), threads=1)
    for steps, loss in results:
        assert steps == 6 and np.isfinite(loss)
    assert results[0][1] == results[1][1]  # the global batch's mean loss


def even_row_groups(piece):
    return piece.row_group % 2 == 0


def first_row_group(piece):
    return piece.row_group == 0


@pytest.mark.parametrize('piece_filter', [even_row_groups, first_row_group])
@pytest.mark.parametrize('shard', [None, (1, 2)])
def test_piece_filter_matches_jax(synthetic_dataset, piece_filter, shard):
    kwargs = {'reader_pool_type': 'dummy', 'shuffle_row_groups': False, 'schema_fields': ['id'],
              'piece_filter': piece_filter}
    if shard:
        kwargs.update(cur_shard=shard[0], shard_count=shard[1])
    with jax_make_reader(synthetic_dataset.url, **kwargs) as reader:
        expected_state = reader.state_dict()
        expected = [row.id for row in reader]
    with make_reader(synthetic_dataset.url, **kwargs) as reader:
        state = reader.state_dict()
        actual = [row.id for row in reader]
    assert actual == expected and 0 < len(actual) < 100
    # the resume cursor counts in the filtered enumeration, as in JAX
    for key in ('num_pieces', 'num_global_pieces', 'remaining_global_parts'):
        assert state[key] == expected_state[key]


@pytest.mark.parametrize('piece_filter', [even_row_groups, first_row_group])
def test_batch_reader_piece_filter_matches_jax(scalar_dataset, piece_filter):
    kwargs = {'reader_pool_type': 'dummy', 'shuffle_row_groups': False,
              'piece_filter': piece_filter}
    with jax_make_batch_reader(scalar_dataset.url, **kwargs) as reader:
        expected = np.concatenate([b.id for b in reader])
    with make_batch_reader(scalar_dataset.url, **kwargs) as reader:
        actual = np.concatenate([b.id for b in reader])
    np.testing.assert_array_equal(actual, expected)
    assert 0 < len(actual) < 100
