"""Port parity: the sequence transformer and its sharded train step of
petastorm_tpu_torch against the JAX package's (twin of
``tests/test_models.py``'s ``TestSequenceTransformer``).

The flax parameters, drawn from a seed, move to the port with
``flax_sequence_to_torch``. Single-process cases: the forward, and one SGD
step's loss, gradient and parameters. Sharded cases: the columnar NGram
windows of one store (``ts`` int64, ``f`` 16 float32 features, 200 rows,
25 per row group, windows of 4) read by every rank as JAX's reader reads
them, the rank's ``[B/data, T/seq, F]`` slice staged onto the sequence
sharding, three train steps on ``(2, 2)``, ``(1, 2)`` and ``(2, 1)``
``('data', 'seq')`` meshes with ring (and, where the heads divide, Ulysses)
attention, against JAX's ``shard_train_state`` step on the same mesh shape:
the first batch's logits, every step's loss, every parameter's gradient of
step 1 and every parameter after steps 1 and 3. One more run reads each
rank's reader shard through a thread pool and is held to one process
stepping the batches the ranks trained on. The port's ranks are spawned
gloo processes (a world of four and one of two, on threads while JAX
steps). Tolerances: 1e-5 for the single-process forward and step (float32,
the same ops in another order); 1e-4 for the sharded steps (float32 sums
over ranks and collectives in another order, through three SGD steps)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu.etl.dataset_metadata import write_petastorm_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax.loader import stack_ngram_time_axis as jax_stack_ngram_time_axis
from petastorm_tpu.models import make_sequence_transformer as jax_make_sequence_transformer
from petastorm_tpu.models.train import TrainState as JaxTrainState
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.models.train import shard_train_state as jax_shard_train_state
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.models import make_sequence_transformer
from petastorm_tpu_torch.models.convert import flax_sequence_to_torch
from petastorm_tpu_torch.models.train import create_train_state, gather_state, make_train_step
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.test_util import dist_workers

ATOL = 1e-5
SHARDED_ATOL = 1e-4
WINDOW, FEATURES, CLASSES, BATCH, STEPS, LR = 4, 16, 4, 8, 3, 0.05
CONFIG = {'num_classes': CLASSES, 'seq_len': WINDOW, 'feature_dim': FEATURES, 'd_model': 32,
          'num_heads': 4, 'num_layers': 1}
#: world size -> the sharded runs it holds: (mesh shape, context, own reader shard)
WORLDS = {4: [((2, 2), 'ring', False), ((2, 2), 'ulysses', False), ((2, 2), 'ring', True)],
          2: [((1, 2), 'ring', False), ((1, 2), 'ulysses', False), ((2, 1), 'ring', False)]}
JAX_RUNS = sorted({(shape, context) for runs in WORLDS.values()
                   for shape, context, shard in runs if not shard})


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox

    armed = jax_blackbox.get_recorder()
    yield
    if armed is None:
        jax_blackbox.disable()
    jax_obs.get_registry().reset()
    jax_obs.get_ring().clear()


def _data(b=8, t=4, f=16, classes=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, f)).astype(np.float32), rng.integers(0, classes, b)


def _flax_params(model, x, seed=1):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))['params'])


def _port_model(params, num_classes=6, t=4, f=16, **kwargs):
    model = make_sequence_transformer(num_classes, t, f, **kwargs)
    model.load_state_dict(flax_sequence_to_torch(params))
    return model


def test_forward_shapes_and_values_match_jax():
    x, _ = _data()
    jax_model = jax_make_sequence_transformer(num_classes=6)
    params = _flax_params(jax_model, x)
    expected = np.asarray(jax.jit(jax_model.apply)({'params': params}, jnp.asarray(x)))
    model = _port_model(params)
    logits = model(torch.from_numpy(x))
    assert tuple(logits.shape) == (8, 6) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), expected, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match='windows of 4 steps'):
        model(torch.from_numpy(x[:, :2]))
    with pytest.raises(ValueError, match='divisible by num_heads'):
        make_sequence_transformer(6, 4, 16, d_model=30, num_heads=4)


def test_one_sgd_step_matches_jax():
    """The plain step (no preprocess, no batch statistics): loss, every
    parameter's gradient and every parameter after SGD 0.1 momentum 0.9."""
    x, y = _data()
    jax_model = jax_make_sequence_transformer(num_classes=6)
    params = _flax_params(jax_model, x)
    # create_train_state's state and SGD, from the given parameters
    state = JaxTrainState.create(apply_fn=jax_model.apply, params=params, batch_stats=None,
                                 tx=optax.sgd(0.1, momentum=0.9))
    state, metrics = jax_make_train_step(donate=False)(state, jnp.asarray(x), jnp.asarray(y))
    # optax.sgd's first step moves each parameter by -0.1 x its gradient
    # (the momentum trace starts at the gradient)
    start, moved = flax_sequence_to_torch(params), flax_sequence_to_torch(jax.device_get(
        state.params))
    expected_grads = {name: (start[name] - moved[name]) / 0.1 for name in start}
    ours = create_train_state(_port_model(params), device='cpu')
    ours, our_metrics = make_train_step()(ours, torch.from_numpy(x), torch.from_numpy(y))
    assert ours.step == 1
    np.testing.assert_allclose(our_metrics['loss'].item(), float(metrics['loss']), atol=ATOL)
    for name, p in ours.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected_grads[name].numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    for name, value in gather_state(ours).items():
        np.testing.assert_allclose(value, moved[name].numpy(), rtol=0, atol=ATOL, err_msg=name)


@pytest.fixture(scope='module')
def seq_store(tmp_path_factory):
    """``test_sharded_train_step_from_columnar_ngram``'s store."""
    url = 'file://' + str(tmp_path_factory.mktemp('seq_store'))
    schema = Unischema('Seq', [UnischemaField('ts', np.int64, (), ScalarCodec(), False),
                               UnischemaField('f', np.float32, (FEATURES,), NdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    write_petastorm_dataset(url, schema, ({'ts': i, 'f': rng.standard_normal(FEATURES).astype(
        np.float32)} for i in range(200)), rows_per_row_group=25)
    return url


def _jax_sharded_run(url, params, shape, context):
    """The JAX test's flow on a ``('data', 'seq')`` mesh of ``shape``: JAX's
    columnar NGram reader, ``stack_ngram_time_axis``, the batch staged with
    ``P('data', 'seq', None)``, ``STEPS`` sharded steps. Returns the first
    batch's logits (of the plain model: exact attention), the losses, step
    1's gradients and the parameters after steps 1 and ``STEPS``, in the
    port's names."""
    mesh = jax_make_mesh(('data', 'seq'), axis_shapes=shape,
                         devices=jax.devices()[:shape[0] * shape[1]])
    model = jax_make_sequence_transformer(num_classes=CLASSES, mesh=mesh, d_model=32,
                                          num_layers=1, context_parallelism=context)
    plain = jax_make_sequence_transformer(num_classes=CLASSES, d_model=32, num_layers=1)
    ngram = JaxNGram({i: ['ts', 'f'] for i in range(WINDOW)}, delta_threshold=1,
                     timestamp_field='ts')
    out = {'losses': [], 'states': {}}
    with mesh:
        # create_train_state's state from the given parameters, without its
        # init pass through the mesh model
        state = JaxTrainState.create(apply_fn=model.apply, params=params, batch_stats=None,
                                     tx=optax.sgd(LR, momentum=0.9))
        state = jax_shard_train_state(state, mesh)
        step = jax_make_train_step(donate=False)
        sharding = NamedSharding(mesh, P('data', 'seq', None))
        with JaxDataLoader(jax_make_reader(url, reader_pool_type='dummy', ngram=ngram,
                                           output='columnar', shuffle_row_groups=False,
                                           num_epochs=None, seed=1),
                           batch_size=BATCH, drop_last=True) as loader:
            it = iter(loader)
            for i in range(1, STEPS + 1):
                stacked = jax_stack_ngram_time_axis(next(it))
                x = jax.device_put(stacked['f'], sharding)
                y = jnp.asarray(np.asarray(stacked['ts'][:, 0]) % CLASSES)
                if i == 1:
                    # the plain model on the same parameters: the sharded
                    # one's logits are exact attention (tests/test_models.py)
                    out['logits'] = np.asarray(plain.apply({'params': params}, stacked['f']))
                state, metrics = step(state, x, y)
                out['losses'].append(float(metrics['loss']))
                if i in (1, STEPS):
                    out['states'][i] = flax_sequence_to_torch(jax.device_get(state.params))
    # optax.sgd's first step moves each parameter by -lr x its gradient (the
    # momentum trace starts at the gradient): step 1's gradient, without a
    # second compiled program
    start = flax_sequence_to_torch(params)
    out['grads'] = {name: (start[name] - value) / LR for name, value in out['states'][1].items()}
    return out


@pytest.fixture(scope='module')
def sharded(seq_store, tmp_path_factory):
    """``{(shape, context, shard): every rank's run}`` of the port and
    ``{(shape, context): JAX's run}``, from one set of flax parameters."""
    params = _flax_params(jax_make_sequence_transformer(num_classes=CLASSES, d_model=32,
                                                        num_layers=1),
                          np.zeros((BATCH, WINDOW, FEATURES), np.float32), seed=3)
    weights = {k: v.numpy() for k, v in flax_sequence_to_torch(params).items()}
    # made here: tmp_path_factory is not safe to call from two threads
    work_dirs = {world: str(tmp_path_factory.mktemp('world{}'.format(world))) for world in WORLDS}
    spawned = {}

    def run_world(world, runs):
        specs = [{'device': 'cpu', 'axis_shapes': shape, 'model': CONFIG, 'weights': weights,
                  'context': context, 'url': seq_store, 'ngram_fields': ('ts', 'f'),
                  'timestamp_field': 'ts', 'delta_threshold': 1, 'feature_field': 'f',
                  'label_field': 'ts', 'reader_seed': 1, 'global_batch': BATCH, 'steps': STEPS,
                  'lr': LR, 'record': (1, STEPS), 'shard': shard}
                 for shape, context, shard in runs]
        try:
            spawned[world] = spawn(dist_workers.several_sequence_runs, world, (specs,), threads=1,
                                   work_dir=work_dirs[world])
        except BaseException as e:  # noqa: BLE001 - raised on the test's thread
            spawned[world] = e

    threads = [threading.Thread(target=run_world, args=item) for item in WORLDS.items()]
    for t in threads:
        t.start()
    theirs = {key: _jax_sharded_run(seq_store, params, *key) for key in JAX_RUNS}
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    ours = {}
    for world, runs in WORLDS.items():
        if isinstance(spawned[world], BaseException):
            raise spawned[world]
        for i, key in enumerate(runs):
            ours[key] = [rank[i] for rank in spawned[world]]
    return ours, theirs, weights


def _assemble_logits(ranks):
    """The global batch's logits from each data coordinate's first seq rank."""
    by_coord = {r['coord'][0]: r['logits'] for r in ranks if r['coord'][2] == 0}
    return np.concatenate([by_coord[c] for c in sorted(by_coord)])


@pytest.mark.parametrize('shape, context', JAX_RUNS)
def test_sharded_step_from_columnar_ngram_matches_jax(sharded, shape, context):
    """Every rank of the port's mesh against JAX's sharded step: logits,
    losses, every parameter's gradient of step 1, every parameter after
    steps 1 and 3, within 1e-4."""
    ours, theirs, _ = sharded
    ranks, expected = ours[(shape, context, False)], theirs[(shape, context)]
    assert sorted(r['coord'] for r in ranks) == sorted(
        (d, shape[0], s, shape[1]) for d in range(shape[0]) for s in range(shape[1]))
    np.testing.assert_allclose(_assemble_logits(ranks), expected['logits'], rtol=0,
                               atol=SHARDED_ATOL)
    for rank in ranks:
        np.testing.assert_allclose(rank['losses'], expected['losses'], rtol=0, atol=SHARDED_ATOL)
        assert set(rank['grads']) == set(expected['grads'])
        for name, grad in rank['grads'].items():
            np.testing.assert_allclose(grad, expected['grads'][name].numpy(), rtol=0,
                                       atol=SHARDED_ATOL, err_msg=name)
        for i in (1, STEPS):
            for name, value in rank['states'][i].items():
                np.testing.assert_allclose(value, expected['states'][i][name].numpy(), rtol=0,
                                           atol=SHARDED_ATOL, err_msg='{} after step {}'.format(
                                               name, i))


def test_ring_and_ulysses_models_match_plain(sharded):
    """Context-parallel models on the same parameters and batch: the logits
    of one process's plain attention, on both meshes with a seq axis."""
    ours, _, weights = sharded
    for shape in ((2, 2), (1, 2)):
        ranks = ours[(shape, 'ring', False)]
        by_coord = {r['coord'][:3:2]: r['slices'][0] for r in ranks}
        x = np.concatenate([np.concatenate([by_coord[(d, s)] for s in range(shape[1])], axis=1)
                            for d in range(shape[0])])
        model = dist_workers.build_sequence_model(CONFIG, weights=weights)
        with torch.no_grad():
            plain = model(torch.from_numpy(x)).numpy()
        for context in ('ring', 'ulysses'):
            np.testing.assert_allclose(_assemble_logits(ours[(shape, context, False)]), plain,
                                       rtol=0, atol=ATOL)


def test_sharded_step_on_reader_shards_matches_one_process(sharded):
    """Each rank reads its data coordinate's shard (2-worker thread pool):
    the two ranks of a seq group train on one batch (the group's first
    rank's, by broadcast), and one process stepping the global batches
    they made gets their losses and parameters within 1e-4."""
    ours, _, weights = sharded
    ranks = ours[((2, 2), 'ring', True)]
    by_coord = {r['coord'][:3:2]: r for r in ranks}
    for d in range(2):
        for step in range(STEPS):
            np.testing.assert_array_equal(by_coord[(d, 0)]['labels'][step],
                                          by_coord[(d, 1)]['labels'][step])
    state = create_train_state(dist_workers.build_sequence_model(CONFIG, weights=weights),
                               device='cpu', learning_rate=LR)
    step = make_train_step()
    losses = []
    for i in range(STEPS):
        x = np.concatenate([np.concatenate([by_coord[(d, s)]['slices'][i] for s in range(2)],
                                           axis=1) for d in range(2)])
        y = np.concatenate([by_coord[(d, 0)]['labels'][i] for d in range(2)])
        state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(metrics['loss'].item())
    reference = gather_state(state)
    for rank in ranks:
        np.testing.assert_allclose(rank['losses'], losses, rtol=0, atol=SHARDED_ATOL)
        for name, value in rank['states'][STEPS].items():
            np.testing.assert_allclose(value, reference[name], rtol=0, atol=SHARDED_ATOL,
                                       err_msg=name)
