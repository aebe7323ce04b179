"""Port parity: GPipe pipeline parallelism of petastorm_tpu_torch against
the JAX package's ``make_pipelined_apply`` (twin of
``tests/test_ops.py``'s pipeline tests).

The stage function is the dry run's ``gelu(act @ w + b)`` (tanh GELU, as
``jax.nn.gelu``) with stacked parameters ``w [S, 16, 16]``, ``b [S, 16]``
and a ``[32, 16]`` batch from a numpy seed. The port's stages are spawned
gloo ranks on a ``('stage',)`` mesh: ``(stages, microbatches)`` of
``(2, 4)`` and ``(4, 8)`` against JAX's pipeline on as many CPU devices and
against running the stages one after another (2e-5, the float32 products
in another order); at 4 stages the gradients of ``sum(y**2)`` against
JAX's and the sequential ones (rtol 2e-4, atol 2e-5, the JAX test's); the
refusals of a wrong stage count and of an indivisible batch; and a world
of one in this process. At the dry run's weight scale 0.3 and width 64 four
stages grow the gradients past 1e3, where those absolute tolerances measure
float32's rounding, not the pipeline: there the pipeline's error against a
float64 sequential run is held to the float32 sequential run's own. Each
spawn has a time limit: a pipeline whose shifts do not match on every rank
fails instead of hanging."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from petastorm_tpu.parallel import make_pipelined_apply as jax_make_pipelined_apply
from petastorm_tpu_torch.entry import gelu_stage
from petastorm_tpu_torch.parallel import make_mesh, make_pipelined_apply
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.test_util import dist_workers

ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
WIDTH, ROWS = 16, 32
#: world size -> (stages, microbatches)
WORLDS = {2: 4, 4: 8}
#: the float64 witness at 4 stages: the dry run's weight scale at the
#: telemetry features' width, the batch and microbatches of ``chip_smoke.py``
WITNESS_SCALE, WITNESS_WIDTH, WITNESS_ROWS = 0.3, 64, 64


def _stage(params, act):
    w, b = params
    return jax.nn.gelu(act @ w + b)


def _params(stages, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((stages, WIDTH, WIDTH)) * 0.3).astype(np.float32),
            (rng.standard_normal((stages, WIDTH)) * 0.1).astype(np.float32))


def _batch(seed):
    return np.random.default_rng(seed).standard_normal((ROWS, WIDTH)).astype(np.float32)


def _witness_inputs(seed=13):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((4, WITNESS_WIDTH, WITNESS_WIDTH)) * WITNESS_SCALE)
            .astype(np.float32),
            (rng.standard_normal((4, WITNESS_WIDTH)) * 0.1).astype(np.float32),
            rng.standard_normal((WITNESS_ROWS, WITNESS_WIDTH)).astype(np.float32))


def _jax_pipeline(stages, microbatches, w, b, x):
    mesh = Mesh(np.array(jax.devices()[:stages]), ('stage',))
    apply = jax_make_pipelined_apply(mesh, _stage, num_microbatches=microbatches)
    params = (jnp.asarray(w), jnp.asarray(b))
    with mesh:
        y = np.asarray(apply(params, jnp.asarray(x)))
        grads = jax.grad(lambda p, xx: jnp.sum(apply(p, xx) ** 2))(params, jnp.asarray(x))
    return y, [np.asarray(g) for g in grads]


@pytest.fixture(scope='module')
def pipelines(tmp_path_factory):
    """Each world's ranks (one spawn each, on threads while JAX runs): the
    pipeline on its seeded parameters and batch, then the refusals; at 4
    stages, then the float64 witness's inputs."""
    inputs = {world: _params(world, world) + (_batch(world),) for world in WORLDS}
    work_dirs = {world: str(tmp_path_factory.mktemp('pp{}'.format(world))) for world in WORLDS}
    spawned = {}

    def run(world):
        w, b, x = inputs[world]
        cases = [{'device': 'cpu', 'microbatches': WORLDS[world], 'w': w, 'b': b, 'x': x},
                 {'device': 'cpu', 'microbatches': WORLDS[world], 'w': w, 'b': b,
                  'refuse': True}]
        if world == 4:
            w, b, x = _witness_inputs()
            cases.append({'device': 'cpu', 'microbatches': WORLDS[world], 'w': w, 'b': b,
                          'x': x})
        try:
            spawned[world] = spawn(dist_workers.pipeline_cases, world, (cases,), threads=1,
                                   work_dir=work_dirs[world], timeout_s=180)
        except BaseException as e:  # noqa: BLE001 - raised on the test's thread
            spawned[world] = e

    threads = [threading.Thread(target=run, args=(world,)) for world in WORLDS]
    for t in threads:
        t.start()
    theirs = {world: _jax_pipeline(world, WORLDS[world], *inputs[world]) for world in WORLDS}
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    for world in WORLDS:
        if isinstance(spawned[world], BaseException):
            raise spawned[world]
    return inputs, spawned, theirs


@pytest.mark.parametrize('stages', sorted(WORLDS))
def test_pipeline_matches_jax_and_sequential(pipelines, stages):
    inputs, spawned, theirs = pipelines
    y_seq = dist_workers.sequential_stages(*inputs[stages])[0]
    np.testing.assert_allclose(theirs[stages][0], y_seq, rtol=ATOL, atol=ATOL)
    assert sorted(rank[0]['stage'] for rank in spawned[stages]) == list(range(stages))
    for rank in spawned[stages]:
        np.testing.assert_allclose(rank[0]['y'], y_seq, rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(rank[0]['y'], theirs[stages][0], rtol=ATOL, atol=ATOL)
        # the input replicates over the stage axis: one reader shard, P()
        assert rank[0]['reader_shard'] == (0, 1)
        assert rank[0]['sharding'] == (0, 1, stages)


def test_pipeline_grads_match_jax_and_sequential(pipelines):
    """At 4 stages each rank's stage gradients (its row of the stacked
    gradient; the other rows zero) against JAX's and the sequential ones."""
    inputs, spawned, theirs = pipelines
    _, w_grad, b_grad = dist_workers.sequential_stages(*inputs[4])
    jax_w, jax_b = theirs[4][1]
    np.testing.assert_allclose(jax_w, w_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for rank in spawned[4]:
        s = rank[0]['stage']
        assert rank[0]['other_rows_zero']
        for ours, expected in ((rank[0]['w_grad'], (w_grad[s], jax_w[s])),
                               (rank[0]['b_grad'], (b_grad[s], jax_b[s]))):
            for reference in expected:
                np.testing.assert_allclose(ours, reference, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize('stages', sorted(WORLDS))
def test_pipeline_refusals_match_jax(pipelines, stages):
    """A stack of S + 1 stages ("one stage per device") and a batch the
    microbatches do not divide: refused on every rank, as JAX refuses
    them."""
    inputs, spawned, _ = pipelines
    for rank in spawned[stages]:
        wrong_stages, indivisible = rank[1]['errors']
        assert 'one stage per device is required' in wrong_stages
        assert 'has leading dim {}'.format(stages + 1) in wrong_stages
        assert indivisible == 'batch ({}) must be divisible by num_microbatches ({})'.format(
            WORLDS[stages] + 1, WORLDS[stages])
    mesh = Mesh(np.array(jax.devices()[:stages]), ('stage',))
    apply = jax_make_pipelined_apply(mesh, _stage, num_microbatches=WORLDS[stages])
    w, b, _ = inputs[stages]
    with mesh, pytest.raises(ValueError, match='one stage per device'):
        apply((jnp.concatenate([w, w[:1]]), jnp.concatenate([b, b[:1]])),
              jnp.zeros((WORLDS[stages], WIDTH)))
    with mesh, pytest.raises(ValueError, match='divisible'):
        apply((jnp.asarray(w), jnp.asarray(b)), jnp.zeros((WORLDS[stages] + 1, WIDTH)))


def test_pipeline_error_at_the_dry_run_scale_is_float32_rounding(pipelines):
    """Weights at the dry run's 0.3, width 64, 4 stages, 8 microbatches:
    the output and every stage's gradients against the stages run one after
    another in float64, within what float32 rounding gives the same stages
    run one after another in float32 (``float32_rounding_excess``)."""
    _, spawned, _ = pipelines
    w, b, x = _witness_inputs()
    y64, w64, b64 = dist_workers.sequential_stages(w, b, x, dtype=torch.float64)
    y32, w32, b32 = dist_workers.sequential_stages(w, b, x)
    # the scale grows the gradients far past the absolute tolerances' reach
    assert np.abs(w64).max() > 1e3
    by_stage = sorted((rank[2] for rank in spawned[4]), key=lambda r: r['stage'])
    assert dist_workers.float32_rounding_excess(by_stage[0]['y'], y32, y64) <= 0
    for name, f32, f64 in (('w_grad', w32, w64), ('b_grad', b32, b64)):
        ours = np.stack([r[name] for r in by_stage])
        assert dist_workers.float32_rounding_excess(ours, f32, f64) <= 0, name


def test_pipeline_on_a_world_of_one():
    """One stage (no group, no shift): microbatched execution of the single
    stage, with its refusals."""
    assert not dist.is_initialized()
    mesh = make_mesh(('stage',), device='cpu')
    try:
        w, b = _params(1, 9)
        x = _batch(9)
        apply = make_pipelined_apply(mesh, gelu_stage, num_microbatches=4)
        y = apply((torch.from_numpy(w), torch.from_numpy(b)), torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), dist_workers.sequential_stages(w, b, x)[0], rtol=ATOL, atol=ATOL)
        with pytest.raises(ValueError, match='one stage per device'):
            apply((torch.zeros(2, WIDTH, WIDTH), torch.zeros(2, WIDTH)), torch.from_numpy(x))
        with pytest.raises(ValueError, match='divisible'):
            apply((torch.from_numpy(w), torch.from_numpy(b)), torch.zeros(6, WIDTH))
    finally:
        dist.destroy_process_group()
