"""Port parity: the MoE layer, the MoE sequence transformer and their
expert-parallel train step of petastorm_tpu_torch against the JAX
package's (twin of ``tests/test_models.py``'s ``TestMoE`` and the two
module-level MoE tests).

The flax parameters, drawn from a seed, move to the port with
``flax_moe_to_torch``; inputs come from a numpy seed. Single-process cases:
``expert_capacity``, the layer's output and aux loss (float32 and bf16),
the capacity drop, the aux loss's bounds, and the transformer's logits,
aux loss, ``moe_loss`` and every gradient against
``jax.value_and_grad``. Sharded cases: four spawned gloo ranks on
``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``('data', 'expert')`` meshes take one
train step on each of two global batches, a random one and one whose
second data shard overflows an expert only because the first shard's
tokens fill its first slots; each is held to JAX's loss, aux loss and
every gradient on the same mesh shape, and the parameters after the step
to SGD's move from JAX's gradient. One more run reads each rank's reader
shard of a window store through a 2-worker thread pool for three steps and
is held to one process stepping the batches the ranks trained on.
Tolerances: 1e-5 single-process (float32, the same ops in another order),
1e-4 sharded (sums over ranks in another order); bf16 outputs within 2% of
the largest (8 significand bits through two products)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu.etl.dataset_metadata import write_petastorm_dataset
from petastorm_tpu.models import MoEMlp as JaxMoEMlp
from petastorm_tpu.models import MoESequenceTransformer as JaxMoESequenceTransformer
from petastorm_tpu.models.moe import expert_capacity as jax_expert_capacity
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.models import MoEMlp, MoESequenceTransformer, expert_capacity, moe_loss
from petastorm_tpu_torch.models.convert import flax_moe_to_torch
from petastorm_tpu_torch.models.train import create_train_state, gather_state, make_train_step
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.test_util import dist_workers

ATOL = 1e-5
SHARDED_ATOL = 1e-4
LR = 0.1
CONFIG = {'num_classes': 4, 'num_experts': 4, 'seq_len': 4, 'feature_dim': 8, 'd_model': 16,
          'num_heads': 2, 'num_layers': 2}
#: the global batch of the sharded runs: 4 rows of 4 steps, 16 tokens, so
#: C = ceil(16 / 4 x 1.25) = 5 slots per expert
BATCH = 4
MESHES = [(2, 2), (1, 4), (4, 1)]
STORE_STEPS = 3


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
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.observability import blackbox

    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    if armed[0] is None:
        jax_blackbox.disable()
    if armed[1] is None:
        blackbox.disable()
    for module in (jax_obs, obs):
        module.get_registry().reset()
        module.get_ring().clear()
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


def _init(model, x, seed):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))['params'])


def _layer_state(params):
    """A flax ``MoEMlp``'s params -> the port layer's ``state_dict``."""
    state = {'gate.weight': params['gate']['kernel'].T, 'gate.bias': params['gate']['bias']}
    state.update({name: params[name] for name in ('w1', 'b1', 'w2', 'b2')})
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}


def _port_layer(params, d_model, **kwargs):
    layer = MoEMlp(d_model, params['gate']['kernel'].shape[1], params['w1'].shape[2], **kwargs)
    layer.load_state_dict(_layer_state(params))
    return layer


def _jax_loss_fn(model):
    """The JAX dry run's objective: ``ce + 0.01 aux``; returns the aux too."""

    def loss_fn(params, x, y):
        logits, aux = model.apply({'params': params}, x)
        ce = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])
        return ce + 0.01 * aux, aux

    return loss_fn


@pytest.mark.parametrize('tokens, experts, factor, expected', [
    (8, 4, 1.25, 3),     # ceil after the slack multiply: ceil(2.5)
    (8, 4, 1.0, 2),
    (3, 8, 1.0, 1),      # floor clamp
    (8, 1, 2.0, 8),      # ceiling clamp at N
    (128, 8, 1.25, 20),  # the smoke's seq_moe layer
    (16, 4, 1.25, 5),    # the sharded runs' global batch
])
def test_expert_capacity_formula(tokens, experts, factor, expected):
    assert expert_capacity(tokens, experts, factor) == expected
    assert jax_expert_capacity(tokens, experts, factor) == expected


def test_moe_layer_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(np.float32)
    jax_layer = JaxMoEMlp(num_experts=4, d_hidden=32)
    params = _init(jax_layer, x, 0)
    y_ref, aux_ref = jax_layer.apply({'params': params}, jnp.asarray(x))
    y, aux = _port_layer(params, 16)(torch.from_numpy(x))
    assert tuple(y.shape) == (2, 8, 16) and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=0, atol=ATOL)


class _MatmulDtypes(TorchDispatchMode):
    """Records the dtype of every matrix product dispatched under it."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split('.')[0] in ('mm', 'bmm', 'addmm', 'baddbmm'):
            self.dtypes.append(args[0].dtype if func.__name__.startswith(('mm', 'bmm'))
                               else args[1].dtype)
        return func(*args, **(kwargs or {}))


def test_moe_layer_bf16_compute_dtype():
    """``dtype=bfloat16``: a bf16 output, the expert products in bf16
    (routing stays float32), and JAX's bf16 output within 2% of its
    largest value."""
    x = np.random.default_rng(1).standard_normal((1, 4, 8)).astype(np.float32)
    jax_layer = JaxMoEMlp(num_experts=2, d_hidden=8, dtype=jnp.bfloat16)
    params = _init(jax_layer, jnp.asarray(x, jnp.bfloat16), 0)
    y_ref, aux_ref = jax_layer.apply({'params': params}, jnp.asarray(x, jnp.bfloat16))
    layer = _port_layer(params, 8, dtype=torch.bfloat16)
    with _MatmulDtypes() as seen:
        y, aux = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert seen.dtypes.count(torch.bfloat16) == 2  # the expert FFN's two products
    assert torch.float32 in seen.dtypes  # the gate
    ref = np.asarray(y_ref.astype(jnp.float32))
    np.testing.assert_allclose(y.float().detach().numpy(), ref, rtol=0,
                               atol=0.02 * np.abs(ref).max())
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=0, atol=ATOL)


def test_moe_capacity_drops_overflow_tokens():
    """With capacity 1 and every token routed to one expert, only one token
    produces output; the rest are zero (the residual carries them)."""
    x = np.ones((1, 6, 8), np.float32)
    jax_layer = JaxMoEMlp(num_experts=6, d_hidden=4, capacity_factor=1.0)
    params = _init(jax_layer, x, 2)
    y_ref, _ = jax_layer.apply({'params': params}, jnp.asarray(x))
    y, _ = _port_layer(params, 8, capacity_factor=1.0)(torch.from_numpy(x))
    y = y.detach().numpy()[0]
    assert int((np.abs(y).sum(axis=1) > 1e-7).sum()) == 1  # capacity = ceil(6/6 x 1.0) = 1
    np.testing.assert_allclose(y, np.asarray(y_ref)[0], rtol=0, atol=ATOL)


def test_moe_aux_loss_bounds():
    """Balanced routing gives an aux loss near 1 (Switch eq. 4's lower
    bound), degenerate routing near E."""
    x = np.random.default_rng(3).standard_normal((4, 32, 16)).astype(np.float32)
    params = _init(JaxMoEMlp(num_experts=4, d_hidden=8), x, 3)
    _, aux = _port_layer(params, 16)(torch.from_numpy(x))
    assert 0.9 <= aux.item() <= 4.0


def test_moe_transformer_matches_jax_value_and_grad():
    """Logits, aux loss, ``moe_loss`` and every gradient against
    ``jax.value_and_grad`` of the JAX dry run's objective, one process."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    y = rng.integers(0, 5, 4)
    model = JaxMoESequenceTransformer(num_classes=5, num_experts=4, d_model=16, num_heads=2,
                                      num_layers=2)
    params = _init(model, x, 4)
    logits_ref, aux_ref = model.apply({'params': params}, jnp.asarray(x))
    (loss_ref, _), grads_ref = jax.jit(jax.value_and_grad(_jax_loss_fn(model), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(y))
    grads_ref = flax_moe_to_torch(jax.device_get(grads_ref))
    ours = MoESequenceTransformer(5, 4, seq_len=8, feature_dim=16, d_model=16, num_heads=2,
                                  num_layers=2)
    ours.load_state_dict(flax_moe_to_torch(params))
    logits, aux = ours(torch.from_numpy(x))
    assert tuple(logits.shape) == (4, 5) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=0, atol=ATOL)
    loss = moe_loss(logits, aux, torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=0, atol=ATOL)
    loss.backward()
    assert {name for name, _ in ours.named_parameters()} == set(grads_ref)
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_ref[name].numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)
    with pytest.raises(ValueError, match='windows of 8 steps'):
        ours(torch.from_numpy(x[:, :4]))


def test_moe_objective_drives_the_train_and_eval_steps():
    """The steps take the model's ``objective``: the eval step's and the
    first train step's loss are ``moe_loss`` of its output, with its
    accuracy and aux loss among the metrics."""
    from petastorm_tpu_torch.models.train import make_eval_step

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 4))
    torch.manual_seed(6)
    model = MoESequenceTransformer(5, 4, seq_len=8, feature_dim=16, d_model=16, num_heads=2,
                                   num_layers=1)
    with torch.no_grad():
        logits, aux = model(x)
    expected = {'loss': moe_loss(logits, aux, y).item(), 'aux': aux.item(),
                'accuracy': (logits.argmax(-1) == y).float().mean().item()}
    state = create_train_state(model, device='cpu')
    evaluated = make_eval_step()(state, x, y)
    _, trained = make_train_step()(state, x, y)
    for metrics in (evaluated, trained):
        assert set(metrics) == set(expected)
        for name, value in expected.items():
            np.testing.assert_allclose(metrics[name].item(), value, rtol=0, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize('name', ['copy_to_group', 'gather_from_group', 'all_reduce_sum',
                                  'reduce_from_group', 'ring_shift', 'all_to_all'])
def test_collectives_are_the_identity_on_a_group_of_one(name):
    """Every collective returns its input on a group of one (``None``, as
    ``axis_group`` gives for an axis of one rank), with no process group:
    the MoE layer calls them unconditionally on a world of one."""
    from petastorm_tpu_torch.parallel import collectives

    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    args = (0, 1) if name == 'all_to_all' else ()
    assert getattr(collectives, name)(x, None, *args) is x


def test_flax_moe_to_torch_round_trip():
    """Every flax parameter lands on one port parameter of its shape:
    Dense kernels transposed, the experts' einsum parameters as they are,
    the blocks' LayerNorms ``norm{i}`` and the last one ``norm``; the port's
    ``state_dict`` gives the same tensors back."""
    model = JaxMoESequenceTransformer(num_classes=3, num_experts=2, d_model=8, num_heads=2,
                                      num_layers=2)
    params = _init(model, np.zeros((1, 4, 5), np.float32), 5)
    state = flax_moe_to_torch(params)
    ours = MoESequenceTransformer(3, 2, seq_len=4, feature_dim=5, d_model=8, num_heads=2,
                                  num_layers=2)
    assert set(state) == set(ours.state_dict())
    ours.load_state_dict(state)
    for name, value in ours.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[name].numpy(), err_msg=name)
    np.testing.assert_array_equal(state['moe1.w1'].numpy(), params['moe1']['w1'])
    np.testing.assert_array_equal(state['moe0.gate.weight'].numpy(),
                                  params['moe0']['gate']['kernel'].T)
    np.testing.assert_array_equal(state['norm.weight'].numpy(), params['LayerNorm_2']['scale'])
    np.testing.assert_array_equal(state['norm1.bias'].numpy(), params['LayerNorm_1']['bias'])
    np.testing.assert_array_equal(state['attn0.norm.weight'].numpy(),
                                  params['attn0']['LayerNorm_0']['scale'])


# -- expert parallelism on spawned ranks ---------------------------------------

@pytest.fixture(scope='module')
def window_store(tmp_path_factory):
    """128 rows of ``ts`` (int64) and 8 float32 features ``f``, 16 per row
    group: the reader-shard run's windows of 4."""
    url = 'file://' + str(tmp_path_factory.mktemp('moe_store'))
    schema = Unischema('MoeSeq', [UnischemaField('ts', np.int64, (), ScalarCodec(), False),
                                  UnischemaField('f', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    write_petastorm_dataset(url, schema, ({'ts': i, 'f': rng.standard_normal(8).astype(
        np.float32)} for i in range(128)), rows_per_row_group=16)
    return url


def _batches():
    """``{'random': (x, y), 'overflow': (x, y)}``: the overflow batch repeats
    one window on every row, so the tokens of each time step all route to
    one expert and an expert shared by two steps takes 8 tokens for 5
    slots: the first data shard's tokens fill its first slots."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, CONFIG['seq_len'], CONFIG['feature_dim'])).astype(np.float32)
    y = rng.integers(0, CONFIG['num_classes'], BATCH)
    return {'random': (x, y), 'overflow': (np.repeat(x[:1], BATCH, axis=0), y)}


def _jax_params():
    model = JaxMoESequenceTransformer(**{k: v for k, v in CONFIG.items()
                                          if k not in ('seq_len', 'feature_dim')})
    return _init(model, _batches()['random'][0], 7)


def _jax_sharded(params, shape, x, y):
    """JAX's value and gradient of the dry run's objective on a
    ``('data', 'expert')`` mesh of ``shape``, the batch staged
    ``P('data')``: loss, aux loss and gradients in the port's names."""
    mesh = jax_make_mesh(('data', 'expert'), axis_shapes=shape,
                         devices=jax.devices()[:shape[0] * shape[1]])
    model = JaxMoESequenceTransformer(mesh=mesh, **{k: v for k, v in CONFIG.items()
                                                    if k not in ('seq_len', 'feature_dim')})
    with mesh:
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P('data')))
        (loss, aux), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(model), has_aux=True))(
            params, xs, jnp.asarray(y))
    return {'loss': float(loss), 'aux': float(aux),
            'grads': flax_moe_to_torch(jax.device_get(grads))}


@pytest.fixture(scope='module')
def sharded(window_store, tmp_path_factory):
    """The port's four ranks (one spawn, on a thread while JAX computes):
    per mesh shape and batch one train step from the converted flax
    parameters, the reader-shard run and the refusal of 6 experts on an
    expert axis of 4; and JAX's runs."""
    params = _jax_params()
    weights = {k: v.numpy() for k, v in flax_moe_to_torch(params).items()}
    batches = _batches()
    runs = [(shape, kind) for shape in MESHES for kind in batches]
    specs = [{'device': 'cpu', 'axis_shapes': shape, 'model': CONFIG, 'weights': weights,
              'batches': [batches[kind]], 'steps': 1, 'record': (1,), 'lr': LR}
             for shape, kind in runs]
    specs.append({'device': 'cpu', 'axis_shapes': (2, 2), 'model': CONFIG, 'weights': weights,
                  'url': window_store, 'ngram_fields': ('ts', 'f'), 'timestamp_field': 'ts',
                  'delta_threshold': 1, 'feature_field': 'f', 'label_field': 'ts',
                  'reader_seed': 1, 'global_batch': BATCH, 'steps': STORE_STEPS,
                  'record': (STORE_STEPS,), 'lr': LR, 'shard': True})
    specs.append({'device': 'cpu', 'axis_shapes': (1, 4), 'refuse_experts': 6, 'model': CONFIG})
    work_dir = str(tmp_path_factory.mktemp('moe_world'))
    spawned = {}

    def run():
        try:
            spawned['ranks'] = spawn(dist_workers.several_moe_runs, 4, (specs,), threads=1,
                                     work_dir=work_dir, timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - raised on the test's thread
            spawned['error'] = e

    thread = threading.Thread(target=run)
    thread.start()
    theirs = {(shape, kind): _jax_sharded(params, shape, *batches[kind]) for shape, kind in runs}
    plain = JaxMoESequenceTransformer(**{k: v for k, v in CONFIG.items()
                                         if k not in ('seq_len', 'feature_dim')})
    logits = {kind: np.asarray(jax.jit(plain.apply)({'params': params}, jnp.asarray(x))[0])
              for kind, (x, _) in batches.items()}
    thread.join(timeout=330)
    assert not thread.is_alive()
    if 'error' in spawned:
        raise spawned['error']
    ranks = spawned['ranks']
    ours = {key: [rank[i] for rank in ranks] for i, key in enumerate(runs)}
    return {'ours': ours, 'theirs': theirs, 'logits': logits, 'weights': weights,
            'store_run': [rank[len(runs)] for rank in ranks],
            'refusals': [rank[len(runs) + 1] for rank in ranks]}


@pytest.mark.parametrize('kind', ['random', 'overflow'])
@pytest.mark.parametrize('shape', MESHES, ids=['{}x{}'.format(*m) for m in MESHES])
def test_sharded_step_matches_jax(sharded, shape, kind):
    """Every rank against JAX on the same mesh shape: the logits of its
    rows, the loss, the aux loss, every parameter's whole gradient (the
    experts gathered over the expert group), and every parameter after the
    step (SGD's first move, -lr x JAX's gradient), within 1e-4."""
    ranks, expected = sharded['ours'][(shape, kind)], sharded['theirs'][(shape, kind)]
    data, experts = shape
    assert sorted(r['coord'] for r in ranks) == sorted(
        (d, data, e, experts) for d in range(data) for e in range(experts))
    logits_ref = sharded['logits'][kind]
    local = BATCH // data
    for rank in ranks:
        d = rank['coord'][0]
        np.testing.assert_allclose(rank['logits'], logits_ref[d * local:(d + 1) * local], rtol=0,
                                   atol=SHARDED_ATOL)
        np.testing.assert_allclose(rank['losses'][0], expected['loss'], rtol=0, atol=SHARDED_ATOL)
        np.testing.assert_allclose(rank['auxes'][0], expected['aux'], rtol=0, atol=SHARDED_ATOL)
        assert set(rank['grads']) == set(expected['grads'])
        for name, grad in rank['grads'].items():
            np.testing.assert_allclose(grad, expected['grads'][name].numpy(), rtol=0,
                                       atol=SHARDED_ATOL, err_msg=name)
        for name, value in rank['states'][1].items():
            moved = sharded['weights'][name] - LR * expected['grads'][name].numpy()
            np.testing.assert_allclose(value, moved, rtol=0, atol=SHARDED_ATOL, err_msg=name)


def _routing(weights, x):
    """Each MoE layer's expert per token of the batch ``x`` (one process)."""
    model = dist_workers.build_moe_model(CONFIG, weights=weights)
    inputs = []
    for layer in model.moe_layers():
        layer.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
    with torch.no_grad():
        model(torch.from_numpy(x))
        return [layer.gate(h.reshape(-1, h.shape[-1])).argmax(-1).numpy()
                for layer, h in zip(model.moe_layers(), inputs)]


def test_overflow_batch_overflows_across_data_shards(sharded):
    """The overflow batch drops tokens of the second data shard that a rank
    routing its shard alone would keep: an expert holds tokens of both
    halves, and the first half's take slots the second half's need. Routing
    each half alone (its own capacity, its own FIFO order) gives other
    logits for the second half than JAX's global routing, which the
    sharded step matched (``test_sharded_step_matches_jax``)."""
    x, _ = _batches()['overflow']
    capacity = expert_capacity(BATCH * CONFIG['seq_len'], CONFIG['num_experts'], 1.25)
    half = BATCH * CONFIG['seq_len'] // 2
    overflows = False
    for experts in _routing(sharded['weights'], x):
        first = np.bincount(experts[:half], minlength=CONFIG['num_experts'])
        second = np.bincount(experts[half:], minlength=CONFIG['num_experts'])
        # kept of the second half's tokens: global FIFO, and each half alone
        overflows |= bool((np.maximum(0, capacity - first) < np.minimum(second, capacity)).any())
    assert overflows
    model = dist_workers.build_moe_model(CONFIG, weights=sharded['weights'])
    with torch.no_grad():
        alone = model(torch.from_numpy(x[BATCH // 2:]))[0].numpy()
        whole = model(torch.from_numpy(x))[0].numpy()[BATCH // 2:]
    assert np.abs(alone - whole).max() > 100 * SHARDED_ATOL


def test_expert_group_reads_one_shard_and_steps_like_one_process(sharded):
    """The ranks of one expert group read one reader shard (the data
    coordinate) and train on the same rows; one process stepping the global
    batches they made gets their losses, aux losses and parameters within
    1e-4. The rank functions also report the shard rule's facts."""
    ranks = sharded['store_run']
    by_coord = {r['coord'][::2]: r for r in ranks}
    for rank in ranks:
        assert rank['reader_shard'] == (rank['coord'][0], 2)
        assert rank['replicas'] == 2
    for d in range(2):
        for step in range(STORE_STEPS):
            np.testing.assert_array_equal(by_coord[(d, 0)]['labels'][step],
                                          by_coord[(d, 1)]['labels'][step])
            np.testing.assert_array_equal(by_coord[(d, 0)]['slices'][step],
                                          by_coord[(d, 1)]['slices'][step])
    state = create_train_state(dist_workers.build_moe_model(CONFIG, weights=sharded['weights']),
                               device='cpu', learning_rate=LR)
    step = make_train_step()
    losses, auxes = [], []
    for i in range(STORE_STEPS):
        x = np.concatenate([by_coord[(d, 0)]['slices'][i] for d in range(2)])
        y = np.concatenate([by_coord[(d, 0)]['labels'][i] for d in range(2)])
        state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(metrics['loss'].item())
        auxes.append(metrics['aux'].item())
    reference = gather_state(state)
    for rank in ranks:
        np.testing.assert_allclose(rank['losses'], losses, rtol=0, atol=SHARDED_ATOL)
        np.testing.assert_allclose(rank['auxes'], auxes, rtol=0, atol=SHARDED_ATOL)
        assert set(rank['states'][STORE_STEPS]) == set(reference)
        for name, value in rank['states'][STORE_STEPS].items():
            np.testing.assert_allclose(value, reference[name], rtol=0, atol=SHARDED_ATOL,
                                       err_msg=name)
    # the last batch's routing: every token of the global batch counted
    for layer in ranks[0]['routing']:
        assert sum(layer['expert_load']) == BATCH * CONFIG['seq_len']
        assert layer['capacity'] == 5 and 0 <= layer['dropped_fraction'] < 1


def test_moe_rejects_indivisible_experts(sharded):
    """6 experts on an expert axis of 4 ranks: refused on every rank, as
    the JAX layer refuses them; and ``shard_train_state`` refuses a model
    that was not built on the mesh (it would hold every expert)."""
    for refusals in sharded['refusals']:
        assert refusals['experts'] == ("num_experts (6) must be divisible by the 'expert' axis "
                                       'size (4)')
        assert 'expert axis of 4 ranks, and the model was not built on it' in \
            refusals['unsharded']
    mesh = jax_make_mesh(('expert',), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="num_experts \\(6\\) must be divisible by the 'expert' "
                                         'axis size \\(4\\)'):
        JaxMoEMlp(num_experts=6, d_hidden=8, mesh=mesh).init(jax.random.PRNGKey(0),
                                                             jnp.zeros((1, 4, 8)))


def test_state_shardings_shard_the_experts():
    """``state_shardings`` on a ``('data', 'expert')`` mesh: each MoE
    layer's ``w1``, ``b1``, ``w2``, ``b2`` ``Shard(0)`` on ``expert`` (JAX's
    ``P('expert')``), everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from petastorm_tpu_torch.models.train import state_shardings
    from petastorm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(('data', 'expert'), device='cpu')
    try:
        model = MoESequenceTransformer(mesh=mesh, **CONFIG)
        specs = state_shardings(create_train_state(model, device='cpu'), mesh)
    finally:
        torch.distributed.destroy_process_group()
    experts = {'moe{}.{}'.format(i, p) for i in range(2) for p in ('w1', 'b1', 'w2', 'b2')}
    assert experts <= set(specs)
    for name, placements in specs.items():
        assert placements == ((Replicate(), Shard(0)) if name in experts
                              else (Replicate(), Replicate())), name
