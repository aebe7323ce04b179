"""The port's hand-written kernels against their plain PyTorch versions.

This file imports nothing of JAX, so it also runs on a host that has only
PyTorch and a card, without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests that need the card carry the ``gpu`` marker and skip without CUDA.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.ops.kernels import batchnorm as batchnorm_kernel
from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)

SHAPES = [
    (64, 160, 160, 3),  # the main path's batch
    (64, 144, 144, 3),  # the crop path's batch: 160 cropped to 144 in the step
    (4, 32, 32, 3),
    (2, 17, 224, 3),    # odd rows, a masked tail
    (1, 8, 128, 1),     # single channel
]

#: every batch norm of ResNet-50 at 224 px: (C, H = W, epilogue), run at
#: batch 256 by the card's tests
RESNET50_BN_SHAPES = [
    (64, 112, 'relu'),                                                   # bn_init
    (64, 56, 'relu'), (256, 56, 'residual_relu'), (256, 56, 'none'),     # stage 1
    (128, 56, 'relu'), (128, 28, 'relu'), (512, 28, 'residual_relu'),    # stage 2
    (512, 28, 'none'),
    (256, 28, 'relu'), (256, 14, 'relu'), (1024, 14, 'residual_relu'),   # stage 3
    (1024, 14, 'none'),
    (512, 14, 'relu'), (512, 7, 'relu'), (2048, 7, 'residual_relu'),     # stage 4
    (2048, 7, 'none'),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    return torch.device('cuda')


def _images(shape, dtype, device, seed=0):
    host = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(host).to(device, dtype)


def _stats(c, device):
    return (torch.from_numpy(MEAN[:c]).to(device),
            torch.from_numpy((1.0 / STD[:c]).astype(np.float32)).to(device))


def test_kernel_wrapper_refuses_cpu_tensor():
    # on the CPU the op runs the plain version; the kernel wrapper itself
    # never does: it launches or raises
    images = _images((1, 4, 4, 3), torch.uint8, 'cpu')
    mean, inv_std = _stats(3, 'cpu')
    with pytest.raises(ValueError, match='CUDA'):
        normalize_kernel.normalize_triton(images, mean, inv_std)


@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
def test_plain_version_widens_integers_and_keeps_floats(out_dtype):
    mean, inv_std = _stats(3, 'cpu')
    ints = _images((2, 4, 4, 3), torch.uint8, 'cpu')
    out = normalize_kernel.normalize_reference(ints, mean, inv_std, out_dtype)
    expected = (ints.numpy().astype(np.float32) - MEAN) * (1.0 / STD).astype(np.float32)
    assert out.dtype == out_dtype
    np.testing.assert_allclose(out.float().numpy(), expected, rtol=1e-2 if out_dtype ==
                               torch.bfloat16 else 1e-6, atol=1e-5)
    floats = ints.float() + 0.25  # a truncating cast would drop the quarter
    out = normalize_kernel.normalize_reference(floats, mean, inv_std, torch.float32)
    np.testing.assert_allclose(out.numpy(), expected + 0.25 / STD, rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('dtype', [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
def test_triton_kernel_matches_plain_version(cuda, shape, dtype, out_dtype):
    images = _images(shape, dtype, cuda)
    if dtype == torch.float32:
        images = images + 0.5
    mean, inv_std = _stats(shape[-1], cuda)
    before = normalize_kernel.launches
    out = normalize_kernel.normalize_triton(images, mean, inv_std, out_dtype)
    torch.cuda.synchronize()
    assert normalize_kernel.launches == before + 1
    assert out.dtype == out_dtype and out.shape == images.shape
    ref = normalize_kernel.normalize_reference(images, mean, inv_std, out_dtype)
    # the same float32 arithmetic, rounded once: at most one bf16 ulp
    tol = (2.0 ** -7 * ref.float().abs() if out_dtype == torch.bfloat16
           else 1e-5 * ref.float().abs() + 1e-5)
    assert ((out.float() - ref.float()).abs() <= tol + 1e-6).all()


@pytest.mark.gpu
def test_normalize_images_launches_kernel_on_cuda(cuda):
    images = _images((2, 17, 224, 3), torch.uint8, cuda)
    before = normalize_kernel.launches
    out = normalize_images(images, MEAN, STD, out_dtype=torch.float32)
    assert normalize_kernel.launches == before + 1
    expected = normalize_images(images.cpu(), MEAN, STD, out_dtype=torch.float32)
    np.testing.assert_allclose(out.cpu().numpy(), expected.numpy(), rtol=1e-5, atol=1e-5)
    single = normalize_images(images[0], MEAN, STD)  # one (H, W, C) image
    assert normalize_kernel.launches == before + 2 and single.shape == images[0].shape


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs(cuda):
    mean, inv_std = _stats(3, cuda)
    images = _images((2, 8, 8, 3), torch.uint8, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        normalize_kernel.normalize_triton(images.transpose(1, 2), mean, inv_std)
    with pytest.raises(ValueError, match='3-D or 4-D'):
        normalize_kernel.normalize_triton(images[0, 0], mean, inv_std)
    with pytest.raises(ValueError, match='mean_c'):
        normalize_kernel.normalize_triton(images, mean[:2], inv_std)
    with pytest.raises(ValueError, match='out_dtype'):
        normalize_kernel.normalize_triton(images, mean, inv_std, torch.float16)


def test_resnet50_batch_norm_shapes_are_the_models():
    # the list the card's tests run is every (C, H, epilogue) the model's
    # batch norms are called with at 224 px, and there are 53 calls
    from petastorm_tpu_torch.models import resnet50
    from petastorm_tpu_torch.models.resnet import BatchNorm

    model = resnet50(num_classes=10, dtype=torch.float32).eval()
    seen = []

    def hook(module, args, kwargs):
        x = args[0]
        epilogue = 'residual_relu' if kwargs.get('residual') is not None else (
            'relu' if kwargs.get('relu') else 'none')
        seen.append((x.shape[1], x.shape[2], epilogue))

    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3))
    assert len(seen) == 53
    assert sorted(set(seen)) == sorted(RESNET50_BN_SHAPES)


def _bn_case(shape, cuda, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    c = shape[1]

    def channels(low, high):
        return torch.rand(c, generator=gen, device=cuda) * (high - low) + low

    x = torch.randn(shape, generator=gen, device=cuda) * channels(0.5, 2.0)[None, :, None, None] \
        + channels(-4.0, 4.0)[None, :, None, None]
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    residual = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    grad = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return x, residual, grad, channels(0.5, 1.5), channels(-0.1, 0.1)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize('c,h,epilogue', RESNET50_BN_SHAPES)
def test_batchnorm_kernels_match_plain_version(cuda, c, h, epilogue):
    # ResNet-50's batch norms at batch 256 in bf16: the batch statistics to
    # 1e-5 of the channel's scale, the output within one bf16 ulp (above a
    # 1e-4 floor where x * a and b cancel), the running statistics. The
    # gradients (ATen's backward behind the kernels' forward) are the plain
    # version's in float32 within bf16 rounding, and no farther from them
    # than those of the ATen path the model ran before (native_batch_norm,
    # the residual add, F.relu): that path rounds the batch norm's output to
    # bf16 before the add, so its ReLU mask differs from the exact one where
    # the sum is near zero (some 0.1% of the elements)
    shape = (256, c, h, h)
    relu, has_residual = epilogue != 'none', epilogue == 'residual_relu'
    x, residual, grad, scale, bias = _bn_case(shape, cuda, seed=c * 1000 + h)
    residual = residual if has_residual else None
    running = [torch.zeros(c, device=cuda), torch.ones(c, device=cuda)]
    ref_running = [t.clone() for t in running]
    before = batchnorm_kernel.launches
    y, save_mean, save_invstd = batchnorm_kernel.batch_norm_train(
        x, scale, bias, *running, relu=relu, residual=residual)
    torch.cuda.synchronize()
    assert batchnorm_kernel.launches == before + batchnorm_kernel.KERNELS_PER_CALL
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref_y, ref_mean, ref_var = batchnorm_kernel.batch_norm_train_reference(
        x, scale, bias, *ref_running, relu=relu, residual=residual)
    ref_invstd = torch.rsqrt(ref_var + 1e-5)
    assert float(((save_mean - ref_mean).abs() / (ref_mean.abs() + ref_var.sqrt())).max()) <= 1e-5
    assert float(((save_invstd - ref_invstd).abs() / ref_invstd).max()) <= 1e-5
    diff = (y.float() - ref_y.float()).abs()
    assert bool((diff <= 2.0 ** -7 * ref_y.float().abs() + 1e-4).all()), float(diff.max())
    del diff, ref_y
    for got, want in zip(running, ref_running):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    def grads(path):
        inputs = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
        res = residual.detach().clone().requires_grad_() if has_residual else None
        fresh = [torch.zeros(c, device=cuda), torch.ones(c, device=cuda)]
        if path == 'kernels':
            out = batchnorm_kernel.batch_norm_train_fused(*inputs, *fresh, relu=relu,
                                                          residual=res)
        elif path == 'plain':
            # float32 from the same bf16 values
            inputs[0] = x.float().requires_grad_()
            res = residual.float().requires_grad_() if has_residual else None
            out = batchnorm_kernel.batch_norm_train_reference(*inputs, *fresh, relu=relu,
                                                              residual=res)[0]
        else:
            out = torch.native_batch_norm(*inputs, None, None, True, 0.0, 1e-5)[0]
            if has_residual:
                out = res + out
            out = F.relu(out) if relu else out
        out.backward(grad if path != 'plain' else grad.float())
        return [t.grad for t in inputs] + ([res.grad] if has_residual else [])

    plain = grads('plain')
    fused, aten = grads('kernels'), grads('aten')
    for name, got, old, want in zip(('x', 'scale', 'bias', 'residual'), fused, aten, plain):
        assert _rel(got, want) <= 1e-2, (name, _rel(got, want))
        assert _rel(got, want) <= _rel(old, want) + 1e-3, (name, _rel(got, want),
                                                           _rel(old, want))


@pytest.mark.gpu
def test_batchnorm_kernels_check_their_inputs(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda).contiguous(memory_format=torch.channels_last)
    per_channel = [torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
                   torch.zeros(8, device=cuda), torch.ones(8, device=cuda)]
    with pytest.raises(ValueError, match='channels-last'):
        batchnorm_kernel.batch_norm_train(x.contiguous(), *per_channel)
    with pytest.raises(ValueError, match='float32'):
        batchnorm_kernel.batch_norm_train(x, per_channel[0].half(), *per_channel[1:])
    with pytest.raises(ValueError, match='residual'):
        batchnorm_kernel.batch_norm_train(x, *per_channel, residual=x.half())


@pytest.mark.gpu
@pytest.mark.parametrize('epilogue', ['none', 'relu', 'residual_relu'])
def test_batchnorm_module_trains_through_the_kernels(cuda, epilogue):
    # the module's training forward on the card is the kernels' forward:
    # the same output and running statistics on a channels-last input; an
    # NCHW input (what a convolution run without cuDNN returns) raises, with
    # no launch, no update and no other path taken
    from petastorm_tpu_torch.models.resnet import BatchNorm

    relu, has_residual = epilogue != 'none', epilogue == 'residual_relu'
    x, residual, _, scale, bias = _bn_case((4, 16, 6, 6), cuda, seed=7)
    residual = residual if has_residual else None
    module = BatchNorm(16).to(cuda)
    with torch.no_grad():
        module.scale.copy_(scale)
        module.bias.copy_(bias)
    running = [module.mean.clone(), module.var.clone()]
    before = batchnorm_kernel.launches
    out = module(x, relu=relu, residual=residual)
    assert batchnorm_kernel.launches == before + batchnorm_kernel.KERNELS_PER_CALL
    want = batchnorm_kernel.batch_norm_train_fused(x, scale, bias, *running, relu=relu,
                                                   residual=residual)
    assert torch.equal(out, want)
    assert torch.equal(module.mean, running[0]) and torch.equal(module.var, running[1])
    before = batchnorm_kernel.launches
    with pytest.raises(ValueError, match='channels-last'):
        module(x.contiguous(), relu=relu, residual=residual)
    if has_residual:
        with pytest.raises(ValueError, match='residual'):
            module(x, relu=relu, residual=residual.contiguous())
    assert batchnorm_kernel.launches == before
    assert torch.equal(module.mean, running[0]) and torch.equal(module.var, running[1])


@pytest.mark.gpu
def test_graphed_resnet50_replay_counts_its_kernels(cuda):
    # the bf16 ResNet-50 the benchmark trains, at a small size: one replay
    # launches the three batch-norm kernels for each of its 53 batch norms
    # and the normalize kernel once; the module's training forward on the
    # card goes through the kernels (no other path runs there)
    from petastorm_tpu_torch.models import resnet50
    from petastorm_tpu_torch.models.resnet import BatchNorm
    from petastorm_tpu_torch.models.train import (GRAPH_WARMUP_STEPS, create_train_state,
                                                  make_train_step)
    from petastorm_tpu_torch.ops.augment import flip_with_mask

    torch.manual_seed(0)
    model = resnet50(num_classes=10)
    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert norms == 53
    state = create_train_state(model, cuda)
    step = make_train_step(preprocess_fn=lambda x, mask: normalize_images(
        flip_with_mask(x, mask), MEAN, STD), preprocess_seed=5, graphed=True)
    images = _images((4, 64, 64, 3), torch.uint8, cuda)
    labels = torch.arange(4, device=cuda) % 10
    before = batchnorm_kernel.launches
    step(state, images, labels)  # eager: the module launches the kernels itself
    assert batchnorm_kernel.launches - before == norms * batchnorm_kernel.KERNELS_PER_CALL
    for _ in range(GRAPH_WARMUP_STEPS):
        step(state, images, labels)  # the last eager step, then capture and replay
    bn_before, norm_before = batchnorm_kernel.launches, normalize_kernel.launches
    _, metrics = step(state, images, labels)
    torch.cuda.synchronize()
    assert batchnorm_kernel.launches - bn_before == norms * batchnorm_kernel.KERNELS_PER_CALL
    assert normalize_kernel.launches - norm_before == 1
    assert np.isfinite(float(metrics['loss']))


@pytest.mark.gpu
def test_graphed_step_losses_equal_the_eager_steps(cuda):
    # five steps of a small ResNet from one seed on the same batches: the
    # graphed step (two eager warm-up steps, then capture and replays) gives
    # the eager step's losses within 1e-3 (the same kernels; float32 sums of
    # the backward may come in another order), counts the normalize kernel
    # once per replay, and its metrics survive the later replays
    from petastorm_tpu_torch.models import BottleneckBlock, ResNet
    from petastorm_tpu_torch.models.train import (GRAPH_WARMUP_STEPS, create_train_state,
                                                  make_train_step)
    from petastorm_tpu_torch.ops.augment import flip_with_mask

    steps = 5
    gen = np.random.default_rng(2)
    batches = [(_images((8, 32, 32, 3), torch.uint8, cuda, seed=s),
                torch.from_numpy(gen.integers(0, 10, 8)).to(cuda)) for s in range(steps)]

    def preprocess(images, mask):
        return normalize_images(flip_with_mask(images, mask), MEAN, STD, out_dtype=torch.float32)

    def run(graphed):
        torch.manual_seed(0)
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        state = create_train_state(model, cuda)
        step = make_train_step(preprocess_fn=preprocess, preprocess_seed=3, graphed=graphed)
        before = normalize_kernel.launches
        losses = [step(state, images, labels)[1]['loss'] for images, labels in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [float(x) for x in losses], normalize_kernel.launches - before, step

    eager, eager_launches, _ = run(False)
    graphed, graphed_launches, step = run(True)
    assert steps > GRAPH_WARMUP_STEPS + 1
    np.testing.assert_allclose(graphed, eager, atol=1e-3, rtol=0)
    assert len(set(graphed)) == steps
    assert eager_launches == graphed_launches == steps
    with pytest.raises(ValueError, match='captured for images'):
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        step(create_train_state(model, cuda), batches[0][0][:4], batches[0][1][:4])


@pytest.mark.gpu
def test_graphed_crop_step_losses_equal_the_eager_steps(cuda):
    # the step draws more than the flip mask: RandomCropFlip's crop offsets
    # and mask are drawn outside the graph and copied into buffers of their
    # own before each replay. Five steps from one seed on the same batches:
    # the graphed losses equal the eager ones within chip_smoke.py's
    # FIRST_LOSS_TOL (1e-3, the first) and REPLAY_LOSS_TOL (1e-2, the rest)
    from petastorm_tpu_torch.models import BottleneckBlock, ResNet
    from petastorm_tpu_torch.models.train import (GRAPH_WARMUP_STEPS, create_train_state,
                                                  make_train_step)
    from petastorm_tpu_torch.ops import RandomCropFlip

    steps, size, crop = 5, 40, 32
    gen = np.random.default_rng(3)
    batches = [(_images((8, size, size, 3), torch.uint8, cuda, seed=10 + s),
                torch.from_numpy(gen.integers(0, 10, 8)).to(cuda)) for s in range(steps)]
    preprocess = RandomCropFlip(crop, crop, then=lambda x: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))

    def run(graphed):
        torch.manual_seed(0)
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        state = create_train_state(model, cuda)
        step = make_train_step(preprocess_fn=preprocess, preprocess_seed=4, graphed=graphed)
        before = normalize_kernel.launches
        losses = [step(state, images, labels)[1]['loss'] for images, labels in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [float(x) for x in losses], normalize_kernel.launches - before, step

    eager, eager_launches, _ = run(False)
    graphed, graphed_launches, step = run(True)
    assert steps > GRAPH_WARMUP_STEPS + 1
    assert abs(graphed[0] - eager[0]) <= 1e-3
    np.testing.assert_allclose(graphed, eager, atol=1e-2, rtol=0)
    assert len(set(graphed)) == steps
    assert eager_launches == graphed_launches == steps
    # captured for one input shape: a batch of another size is refused
    with pytest.raises(ValueError, match='captured for images'):
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        step(create_train_state(model, cuda), batches[0][0][:, :crop, :crop].contiguous(),
             batches[0][1])


@pytest.mark.gpu
def test_graphed_step_times_its_replayed_calls_alone(cuda):
    # a replayed call is one train_step stage with its replay's launch as a
    # nested train_step_replay; the eager warm-up calls and the capture call
    # are neither, so a window's stage count is its replayed steps
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.models import BottleneckBlock, ResNet
    from petastorm_tpu_torch.models.train import (GRAPH_WARMUP_STEPS, create_train_state,
                                                  make_train_step)

    steps = 6
    images = _images((8, 32, 32, 3), torch.uint8, cuda)
    labels = torch.arange(8, device=cuda) % 10
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                   dtype=torch.float32)
    state = create_train_state(model, cuda)
    step = make_train_step(preprocess_fn=lambda x, mask: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32), graphed=True)
    saved = obs.current_config()
    obs.configure('counters')
    try:
        before = obs.snapshot()['counters']
        for _ in range(steps):
            step(state, images, labels)
        torch.cuda.synchronize()
        after = obs.snapshot()['counters']
    finally:
        obs.configure(saved)

    def delta(key):
        return after.get(key, 0) - before.get(key, 0)

    replayed = steps - GRAPH_WARMUP_STEPS - 1
    assert delta('stage_train_step_count') == delta('stage_train_step_replay_count') == replayed
    assert 0 < delta('stage_train_step_replay_s') <= delta('stage_train_step_s')
    # the thread's CPU seconds are there (a sandboxed host may count them in
    # 10 ms ticks, so a few short calls may read a tick more than their wall)
    assert delta('stage_train_step_cpu_s') >= 0 and 'stage_train_step_replay_cpu_s' in after


@pytest.mark.gpu
@pytest.mark.parametrize('context', ['plain', 'ring'])
def test_graphed_sequence_step_equals_the_eager_step(cuda, context, monkeypatch):
    # the sequence transformer's plain step (no preprocess, no mask): five
    # steps from one seed on the same [B, T, F] batches, graphed against
    # eager; 'ring' runs the ring attention op with a seq group of one. The
    # graph replays the eager step's float32 kernels, so the losses agree
    # within 1e-5 (float32 sums of the backward may come in another order)
    from petastorm_tpu_torch.models import make_sequence_transformer
    from petastorm_tpu_torch.models.transformer import SequenceTransformer
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step
    from petastorm_tpu_torch.ops.ring_attention import ring_attention

    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    steps = 5
    gen = np.random.default_rng(4)
    batches = [(torch.from_numpy(gen.standard_normal((16, 8, 64)).astype(np.float32)).to(cuda),
                torch.from_numpy(gen.integers(0, 8, 16)).to(cuda)) for _ in range(steps)]

    def run(graphed):
        torch.manual_seed(0)
        if context == 'plain':
            model = make_sequence_transformer(8, 8, 64)
        else:
            model = SequenceTransformer(8, 8, 64, attention_fn=ring_attention)
        state = create_train_state(model, cuda)
        step = make_train_step(graphed=graphed)
        losses = [step(state, x, y)[1]['loss'] for x, y in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [float(x) for x in losses]

    eager, graphed = run(False), run(True)
    np.testing.assert_allclose(graphed, eager, atol=1e-5, rtol=0)
    assert len(set(graphed)) == steps


@pytest.mark.gpu
def test_graphed_moe_step_equals_the_eager_step(cuda, monkeypatch):
    # the MoE sequence transformer (8 experts, the smoke's widths) stepped
    # on moe_loss: five steps from one seed on the same [B, T, F] batches,
    # graphed against eager. Routing builds its one-hots by comparison and
    # reads nothing back to the host, so the step captures; the losses and
    # aux losses agree within 1e-5
    from petastorm_tpu_torch.models import MoESequenceTransformer
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    steps = 5
    gen = np.random.default_rng(5)
    batches = [(torch.from_numpy(gen.standard_normal((16, 8, 64)).astype(np.float32)).to(cuda),
                torch.from_numpy(gen.integers(0, 8, 16)).to(cuda)) for _ in range(steps)]

    def run(graphed):
        torch.manual_seed(0)
        state = create_train_state(MoESequenceTransformer(8, 8, seq_len=8, feature_dim=64), cuda)
        step = make_train_step(graphed=graphed)
        metrics = [step(state, x, y)[1] for x, y in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [[float(m[k]) for m in metrics] for k in ('loss', 'aux')]

    eager, graphed = run(False), run(True)
    np.testing.assert_allclose(graphed, eager, atol=1e-5, rtol=0)
    assert len(set(graphed[0])) == steps


@pytest.mark.gpu
def test_mirror_backed_batch_staged_and_normalized_equals_plain(cuda, tmp_path):
    # a warm chunk cache of a mock-remote raw store serves its blocks as views
    # over the mirrors; the pinned host copy of prefetch_to_device is taken
    # from them while the mapping stays alive, and the kernel on the staged
    # batch equals the plain version on the same host rows
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, cache_diagnostics
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    store = str(tmp_path / 'raw')
    schema = Unischema('Raw', [
        UnischemaField('image', np.uint8, (32, 32, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    with materialize_dataset('file://' + store, schema, rows_per_row_group=16,
                             compression='none') as writer:
        for i in range(64):
            writer.write({'image': rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                          'label': np.int64(i)})
    config = ChunkCacheConfig(str(tmp_path / 'chunks'))
    url = 'mock-remote://' + store
    with make_reader(url, reader_pool_type='dummy', output='columnar',
                     chunk_cache=config) as reader:
        list(reader)
    cold = cache_diagnostics(config)
    with make_reader(url, reader_pool_type='dummy', output='columnar', seed=1,
                     chunk_cache=config) as reader:
        loader = TorchDataLoader(reader, 16, shuffling_queue_capacity=0)
        batches = iter(prefetch_to_device(loader, cuda, size=2))
        for batch in batches:
            staged = batch['image']
            assert staged.device.type == 'cuda' and staged.dtype == torch.uint8
            before = normalize_kernel.launches
            out = normalize_images(staged, MEAN, STD)
            assert normalize_kernel.launches == before + 1
            host = staged.cpu()
            expected = normalize_kernel.normalize_reference(host, *_stats(3, 'cpu'),
                                                            torch.bfloat16).float()
            # the same float32 arithmetic, rounded once: at most one bf16 ulp
            err = (out.cpu().float() - expected).abs()
            assert (err <= 2.0 ** -7 * expected.abs() + 1e-6).all()
        batches.close()
    warm = cache_diagnostics(config)
    assert warm['chunk_cache_misses'] == cold['chunk_cache_misses']
    assert warm['chunk_cache_hits'] > cold['chunk_cache_hits']


@pytest.mark.gpu
def test_infeed_stages_beside_a_graph_capture(cuda):
    # PyTorch hands out each priority's pool of streams round robin, 32 per
    # device. With the pool placed so that its next default-priority stream
    # is the one torch.cuda.graph captures on, a batch the prefetch thread
    # stages while this thread captures must stay out of the graph, and land
    # whole once the capture ends
    import threading

    from petastorm_tpu_torch.torch import prefetch_to_device

    capture = torch.cuda.graph(torch.cuda.CUDAGraph()).capture_stream
    for _ in range(32):
        if torch.cuda.Stream(cuda).cuda_stream == capture.cuda_stream:
            break
    else:
        pytest.fail('the capture stream is not one of the pool\'s default-priority streams')
    for _ in range(31):
        torch.cuda.Stream(cuda)
    batches = [{'image': np.random.default_rng(seed).integers(0, 256, (64, 160, 160, 3),
                                                               dtype=np.uint8)}
               for seed in range(3)]
    in_capture, staged = threading.Event(), threading.Event()

    def source():
        yield batches[0]
        in_capture.wait(30)
        yield batches[1]  # staged while this thread captures
        staged.set()
        yield batches[2]

    it = prefetch_to_device(source(), cuda, size=2)
    try:
        got = [next(it)]
        x = torch.ones(1024, device=cuda)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            y = x * 2
            in_capture.set()
            assert staged.wait(30)
        graph.replay()
        got.extend(it)
    finally:
        it.close()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 2))
    assert len(got) == len(batches)
    for batch, expected in zip(got, batches):
        np.testing.assert_array_equal(batch['image'].cpu().numpy(), expected['image'])
