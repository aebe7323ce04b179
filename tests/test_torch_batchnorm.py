"""Batch norm's training forward (``petastorm_tpu_torch/ops/kernels/batchnorm.py``)
on the CPU: the kernels' plain version against flax's ``nn.BatchNorm`` with
the ResNet block's epilogue (``+ residual``, ReLU) applied in JAX, its
gradient against ``jax.vjp`` of the same, the wrapper's refusals, the
statistics pass's launch rule, and the model's ``BatchNorm`` with its
epilogue against the separate calls it replaces. Float32 throughout;
tolerance 1e-5 relative (the two frameworks sum in different orders, and
flax takes the variance as E[x^2] - E[x]^2)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.models.resnet import BatchNorm
from petastorm_tpu_torch.ops.kernels import batchnorm as bn

EPILOGUES = {'none': (False, False), 'relu': (True, False), 'residual_relu': (True, True)}
SHAPES = [(4, 8, 6, 6), (3, 16, 5, 7)]  # (N, C, H, W)
RTOL = ATOL = 1e-5


def _case(shape, seed=0):
    """NCHW float32 input, residual, scale, bias, running mean and var."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, (1, c, 1, 1))
         + rng.normal(0, 2.0, (1, c, 1, 1))).astype(np.float32)
    residual = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, residual, scale, bias, mean, var


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _flax(x, residual, scale, bias, mean, var, relu, has_residual):
    """flax's batch norm (the JAX ResNet's ``norm``) on NHWC inputs, with the
    block's epilogue in JAX. Returns ``(f, new_batch_stats)``, ``f`` a
    function of ``(x, scale, bias, residual)`` giving NHWC ``y``."""
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {'mean': jnp.asarray(mean), 'var': jnp.asarray(var)}

    def f(x, scale, bias, residual):
        y, updates = module.apply({'params': {'scale': scale, 'bias': bias},
                                   'batch_stats': stats}, x, mutable=['batch_stats'])
        if has_residual:
            y = residual + y
        return (jax.nn.relu(y) if relu else y), updates['batch_stats']

    _, new_stats = f(jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias),
                     jnp.asarray(_nhwc(residual)))
    return (lambda *args: f(*args)[0]), new_stats


@pytest.mark.parametrize('epilogue', sorted(EPILOGUES))
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_version_matches_flax(shape, epilogue):
    relu, has_residual = EPILOGUES[epilogue]
    x, residual, scale, bias, mean, var = _case(shape)
    f, new_stats = _flax(x, residual, scale, bias, mean, var, relu, has_residual)
    expected = np.asarray(f(jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias),
                            jnp.asarray(_nhwc(residual))))
    run_mean, run_var = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    y, batch_mean, batch_var = bn.batch_norm_train_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), run_mean, run_var,
        relu=relu, residual=torch.from_numpy(residual) if has_residual else None)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    np.testing.assert_allclose(_nhwc(y.numpy()), expected, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(batch_mean.numpy(), x.mean((0, 2, 3)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(batch_var.numpy(), x.astype(np.float64).var((0, 2, 3)),
                               rtol=RTOL, atol=ATOL)
    # the running update with the BIASED variance, flax's rule
    np.testing.assert_allclose(run_mean.numpy(), np.asarray(new_stats['mean']), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(run_var.numpy(), np.asarray(new_stats['var']), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('epilogue', sorted(EPILOGUES))
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_version_gradient_matches_flax(shape, epilogue):
    relu, has_residual = EPILOGUES[epilogue]
    x, residual, scale, bias, mean, var = _case(shape, seed=1)
    f, _ = _flax(x, residual, scale, bias, mean, var, relu, has_residual)
    grad_y = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(f, jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias),
                     jnp.asarray(_nhwc(residual)))
    gx, gscale, gbias, gres = (np.asarray(g) for g in vjp(jnp.asarray(_nhwc(grad_y))))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias, residual)]
    y, _, _ = bn.batch_norm_train_reference(
        inputs[0], inputs[1], inputs[2], torch.from_numpy(mean.copy()),
        torch.from_numpy(var.copy()), relu=relu, residual=inputs[3] if has_residual else None)
    y.backward(torch.from_numpy(grad_y))
    np.testing.assert_allclose(_nhwc(inputs[0].grad.numpy()), gx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inputs[1].grad.numpy(), gscale, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inputs[2].grad.numpy(), gbias, rtol=1e-4, atol=1e-4)
    if has_residual:
        np.testing.assert_allclose(_nhwc(inputs[3].grad.numpy()), gres, rtol=1e-4, atol=1e-4)
    else:
        assert inputs[3].grad is None


def _wrapper_args(x):
    c = x.shape[1]
    return x, torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c)


@pytest.mark.parametrize('case,match', [
    ('cpu', 'CUDA'),
    ('contiguous_nchw', 'channels-last'),
    ('float64', 'bfloat16, float16 or float32'),
    ('three_d', '4-D'),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(case, match):
    # the wrapper launches or raises; it never runs a plain version itself
    x = torch.randn(2, 8, 4, 4)
    if case == 'cpu':
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    elif case == 'contiguous_nchw':
        x = x.to(torch.bfloat16)
    elif case == 'float64':
        x = x.double().contiguous(memory_format=torch.channels_last)
    else:
        x = x[0]
    before = bn.launches
    with pytest.raises(ValueError, match=match):
        bn.batch_norm_train(*_wrapper_args(x))
    with pytest.raises(ValueError, match=match):
        bn.batch_norm_train_fused(*_wrapper_args(x), relu=True)
    assert bn.launches == before


@pytest.mark.parametrize('m,c', [
    (256 * 112 * 112, 64),   # ResNet-50's bn_init at batch 256
    (256 * 56 * 56, 256),
    (256 * 7 * 7, 2048),
    (4 * 2 * 2, 2048),       # fewer rows than a tile
    (1000003, 24),           # a ragged last slab, a ragged column block
])
def test_stats_grid_covers_every_row_once(m, c):
    sms = 132
    col_blocks, slabs, rows = bn.stats_grid(m, c, sms)
    assert col_blocks == -(-c // bn._STATS_BLOCK_C)
    assert rows % bn._STATS_BLOCK_M == 0
    # the slabs tile [0, m): every slab starts inside, the last one ends at m
    assert (slabs - 1) * rows < m <= slabs * rows
    programs = col_blocks * slabs
    tiles = col_blocks * -(-m // bn._STATS_BLOCK_M)
    # a few programs per SM wherever the tiles allow it
    assert programs >= min(tiles, bn._STATS_PROGRAMS_PER_SM * sms // 2)


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('epilogue', sorted(EPILOGUES))
def test_module_epilogue_equals_the_separate_calls(epilogue, train):
    # on the CPU the module runs ATen's batch norm, then the residual add and
    # the ReLU it used to leave to its caller: bit for bit the same
    relu, has_residual = EPILOGUES[epilogue]
    x, residual, scale, bias, mean, var = _case((4, 8, 5, 5), seed=3)
    fused, separate = BatchNorm(8), BatchNorm(8)
    for module in (fused, separate):
        with torch.no_grad():
            for name, value in (('scale', scale), ('bias', bias), ('mean', mean), ('var', var)):
                getattr(module, name).copy_(torch.from_numpy(value))
        module.train(train)
    xt, rt = torch.from_numpy(x), torch.from_numpy(residual)
    out = fused(xt, relu=relu, residual=rt if has_residual else None)
    expected = separate(xt)
    if has_residual:
        expected = rt + expected
    if relu:
        expected = F.relu(expected)
    assert torch.equal(out, expected)
    assert torch.equal(fused.mean, separate.mean) and torch.equal(fused.var, separate.var)
