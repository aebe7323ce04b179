"""Port parity: ring and Ulysses attention of petastorm_tpu_torch against the
JAX package's (twin of ``tests/test_ops.py``'s context-parallel cases).

The port's ops run in spawned gloo ranks on ``('data', 'seq')`` meshes of
``(1, 2)`` (a ring of 2), ``(1, 4)`` (a ring of 4), ``(2, 2)`` (data and seq
axes) and ``(4, 1)`` (a ring of one, which sends nothing), one world of
four ranks and one of two, spawned on threads while JAX computes the same
cases on its virtual CPU devices. Tolerances: the forward within 1e-5 of
JAX's (float32, the same online-softmax recipe summed in another order) and
within the JAX tests' 2e-4 of a float64 numpy reference; the gradients of
``sum(out * cot)`` with respect to q, k and v within 1e-5 of JAX's (the
backward of the same float32 recipe through the collectives' transposes).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from petastorm_tpu.ops.ring_attention import make_ring_attention as jax_make_ring_attention
from petastorm_tpu.ops.ring_attention import (
    make_sharded_ring_attention as jax_make_sharded_ring_attention)
from petastorm_tpu.ops.ulysses_attention import make_ulysses_attention as jax_make_ulysses_attention
from petastorm_tpu.ops.ulysses_attention import (
    make_sharded_ulysses_attention as jax_make_sharded_ulysses_attention)
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.test_util import dist_workers

ATOL = 1e-5
REFERENCE_TOL = 2e-4
GRAD_ATOL = 1e-5
B, H, T, D = 4, 4, 16, 8


def _case_name(mesh, kind, causal):
    return '{}x{}-{}-{}'.format(mesh[0], mesh[1], kind, 'causal' if causal else 'full')


#: mesh -> the cases it runs: (kind, causal, kv_chunk, with gradients)
CASES = {
    (1, 2): [(k, c, None, False) for k in ('ring', 'ulysses') for c in (False, True)],
    (1, 4): [(k, c, None, c) for k in ('ring', 'ulysses') for c in (False, True)],
    (2, 2): [(k, c, 4 if k == 'ulysses' else None, c) for k in ('ring', 'ulysses')
             for c in (False, True)],
    (4, 1): [('ring', False, None, False)],
}
NAMES = sorted(_case_name(m, k, c) for m, cases in CASES.items() for k, c, _, _ in cases)
GRAD_NAMES = sorted(_case_name(m, k, c) for m, cases in CASES.items() for k, c, _, g in cases
                    if g)


def _reference_attention(q, k, v, causal):
    """float64 numpy attention (``tests/test_ops.py``'s reference)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum('bhqd,bhkd->bhqk', q, k) / np.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum('bhqk,bhkd->bhqd', p / p.sum(-1, keepdims=True), v)


def _jax_case(mesh_shape, kind, causal, kv_chunk, grads, q, k, v, cot):
    mesh = Mesh(np.asarray(jax.devices()[:mesh_shape[0] * mesh_shape[1]]).reshape(mesh_shape),
                ('data', 'seq'))
    kwargs = {'causal': causal}
    if kind == 'ring':
        make, make_sharded = jax_make_ring_attention, jax_make_sharded_ring_attention
    else:
        make, make_sharded = jax_make_ulysses_attention, jax_make_sharded_ulysses_attention
        kwargs['kv_chunk'] = kv_chunk
    inputs = [jnp.asarray(x) for x in (q, k, v)]
    out = {'out': np.asarray(make(mesh, seq_axis='seq', batch_axis='data', **kwargs)(*inputs))}
    if grads:
        sharded = jax.jit(make_sharded(mesh, seq_axis='seq', batch_axis='data', **kwargs))
        out['grads'] = [np.asarray(g) for g in jax.grad(
            lambda *x: jnp.sum(sharded(*x) * jnp.asarray(cot)), argnums=(0, 1, 2))(*inputs)]
    return out


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """``{case name: (port result of rank 0, every rank's result, JAX's)}``
    and the refusals of indivisible heads from the port's ranks."""
    rng = np.random.default_rng(0)
    q, k, v, cot = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    worlds = {4: [(1, 4), (2, 2), (4, 1)], 2: [(1, 2)]}
    # made here: tmp_path_factory is not safe to call from two threads
    work_dirs = {world: str(tmp_path_factory.mktemp('world{}'.format(world))) for world in worlds}
    spawned = {}

    def run_world(world, meshes):
        cases = [{'mesh': m, 'kind': kind, 'causal': causal, 'kv_chunk': chunk,
                  'q': q, 'k': k, 'v': v, 'cot': cot if grads else None}
                 for m in meshes for kind, causal, chunk, grads in CASES[m]]
        if world == 4:
            cases.append({'mesh': (1, 4), 'kind': 'errors'})
        try:
            spawned[world] = (cases, spawn(dist_workers.attention_cases, world, (cases,),
                                           threads=1, work_dir=work_dirs[world]))
        except BaseException as e:  # noqa: BLE001 - raised on the test's thread
            spawned[world] = e

    threads = [threading.Thread(target=run_world, args=item) for item in worlds.items()]
    for t in threads:
        t.start()
    theirs = {_case_name(m, kind, causal): _jax_case(m, kind, causal, chunk, grads, q, k, v, cot)
              for m, cases in CASES.items() for kind, causal, chunk, grads in cases}
    jax_errors = {}
    x = jnp.zeros((1, 3, 16, 4))
    try:
        jax_make_ulysses_attention(Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4),
                                        ('data', 'seq')))(x, x, x)
    except ValueError as e:
        jax_errors['make_ulysses_attention'] = str(e)
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    out, errors = {}, None
    for world, value in spawned.items():
        if isinstance(value, BaseException):
            raise value
        cases, ranks = value
        for i, case in enumerate(cases):
            if case['kind'] == 'errors':
                errors = ranks[0][i]
                continue
            name = _case_name(case['mesh'], case['kind'], case['causal'])
            out[name] = (ranks[0][i], [r[i] for r in ranks], theirs[name])
    return out, errors, jax_errors, (q, k, v)


@pytest.mark.parametrize('name', NAMES)
def test_attention_forward_matches_jax_and_full_attention(results, name):
    """Ring and Ulysses on every mesh: JAX's output within 1e-5, exact full
    attention (causal masks by global position) within 2e-4, and the same
    global output on every rank."""
    cases, _, _, (q, k, v) = results
    ours, ranks, theirs = cases[name]
    np.testing.assert_allclose(ours['out'], theirs['out'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours['out'], _reference_attention(q, k, v, 'causal' in name),
                               rtol=REFERENCE_TOL, atol=REFERENCE_TOL)
    for rank in ranks[1:]:
        np.testing.assert_array_equal(rank['out'], ours['out'])


@pytest.mark.parametrize('name', GRAD_NAMES)
def test_attention_gradients_match_jax(results, name):
    """The gradients through ``ring_shift``'s and ``all_to_all``'s autograd
    (each the other direction's exchange) equal JAX's through ``ppermute``
    and ``all_to_all``."""
    ours, _, theirs = results[0][name]
    for ours_grad, jax_grad, arg in zip(ours['grads'], theirs['grads'], 'qkv'):
        np.testing.assert_allclose(ours_grad, jax_grad, rtol=0, atol=GRAD_ATOL, err_msg=arg)


def test_ulysses_matches_ring(results):
    cases = results[0]
    for mesh in ('1x4', '2x2'):
        np.testing.assert_allclose(cases[mesh + '-ulysses-causal'][0]['out'],
                                   cases[mesh + '-ring-causal'][0]['out'], rtol=0, atol=ATOL)


def test_ulysses_rejects_indivisible_heads(results):
    """3 heads on a seq axis of 4: the op, ``make_ulysses_attention`` and
    ``make_sequence_transformer`` refuse, with JAX's message where JAX has
    the same entry point."""
    _, errors, jax_errors, _ = results
    assert set(errors) == {'make_ulysses_attention', 'ulysses_attention',
                           'make_sequence_transformer'}
    assert errors['make_ulysses_attention'] == jax_errors['make_ulysses_attention']
    for message in errors.values():
        assert 'divisible' in message
